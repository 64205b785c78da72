"""Continuous-batching greedy serving of the port (arena or paged KV)."""
from repro_torch.serve.bucketing import bucket_length, num_buckets  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    Engine, FamilyCaps, Request, probe_family_caps)
