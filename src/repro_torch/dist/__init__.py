"""Single-process training of the port."""
