"""The convex examples of the port, run as modules:
`python -m repro_torch.examples.quickstart` and
`python -m repro_torch.examples.decentralized_lsq`."""
