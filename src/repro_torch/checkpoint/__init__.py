"""Checkpoints in the reference's format (`arrays.npz` + `meta.json`)."""
from repro_torch.checkpoint.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
