"""Hopper kernels of the port, their plain versions and the dispatch.

`ops` is the entry point: CUDA tensors go to the hand-written kernels
(built from `csrc/` on first use by `build`), CPU tensors to `ref`.
"""
