import os
import sys

# Tests must see ONE CPU device (dry-run sets 512 in its own process only).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Subprocess tests pop JAX_PLATFORMS (they force a host device count); on
# images with libtpu but no TPU, jax's TPU probe then blocks minutes on
# the GCE metadata server. Skipping the MDS query makes the TPU backend
# fail fast so those subprocesses fall back to CPU in seconds.
os.environ.setdefault("TPU_SKIP_MDS_QUERY", "1")

import jax

# The convex reference path (theorem descent checks at ~1e-8 scale) needs
# float64; model code uses explicit f32/bf16 dtypes throughout.
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(__file__))  # for proptest helper


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
