"""PyTorch/CUDA port of the API-BCD reproduction, for one NVIDIA H100.

A package of its own beside `repro` (the JAX reference). It imports
`torch` and `numpy` only, never `jax` and nothing from `repro`; modules
it shares with the reference are kept as copies here. Module names follow
the reference, so each file has a clear counterpart.

Ported so far, for the dense `qwen2-0.5b` family: the gAPI-BCD
language-model trainer (`repro_torch.launch.train`), with the closed-form
prox update as a hand-written CUDA kernel, and greedy continuous-batching
serving over a slot arena or a paged pool of KV blocks (a ring of blocks
for a sliding window) (`repro_torch.launch.serve`, `repro_torch.serve`),
with prefill, decode, paged decode and ring decode attention as
hand-written CUDA kernels (`repro_torch.kernels`). For the recurrent
`rwkv6-1.6b`: greedy serving from the slot arena, with the WKV
recurrence as a hand-written CUDA kernel. For the hybrid
`recurrentgemma-2b` (RG-LRU and local attention): greedy serving from the
slot arena, with the RG-LRU recurrence as a hand-written CUDA kernel
beside the attention kernels at head_dim 256.
"""
