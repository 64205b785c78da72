"""PyTorch/CUDA port of the API-BCD reproduction, for one NVIDIA H100.

A package of its own beside `repro` (the JAX reference). It imports
`torch` and `numpy` only, never `jax` and nothing from `repro`; modules
it shares with the reference are kept as copies here. Module names follow
the reference, so each file has a clear counterpart.

What it covers:

- the paper's convex experiments (`repro_torch.core`,
  `repro_torch.data.synthetic`, `repro_torch.examples`): I-BCD, API-BCD
  and gAPI-BCD, the WPG and DGD baselines, the serial driver and the
  asynchronous event simulator behind Figs. 3-6, in float64;
- the true-async multi-process trainer that runs those methods with
  bounded staleness (`repro_torch.dist.async_trainer`,
  `repro_torch.launch.train_async`), over a TCPStore or a shared
  directory, digests bitwise equal across processes;
- the gAPI-BCD language-model trainer and the DP baseline
  (`repro_torch.launch.train`, `repro_torch.dist.trainer`,
  `repro_torch.optim`, `repro_torch.checkpoint`), with the closed-form
  prox update as a hand-written CUDA kernel;
- greedy continuous-batching serving over a slot arena, a paged pool of
  KV blocks or a ring of blocks for a sliding window, overlapped or
  serialized (`repro_torch.launch.serve`, `repro_torch.serve`), and the
  reference's raw prefill/decode loop for the encoder-decoder and VLM
  families;
- all ten of the reference's architectures (`repro_torch.configs`,
  `repro_torch.models`): the dense family (qwen2, internlm2, qwen3,
  nemotron), rwkv6, recurrentgemma, the MoE dbrx, MLA deepseek-v2,
  whisper-small and phi-3-vision;
- cost accounting on one card (`repro_torch.utils.roofline`,
  `repro_torch.kernels.costs`, `repro_torch.launch.dryrun`): a step's
  FLOPs and HBM bytes, counted alike on the card, the CPU and fake
  tensors, against one H100's peaks, for every architecture at the
  reference's input shapes; and the reference's two LM examples;
- every Pallas kernel of the reference as a hand-written CUDA kernel for
  Hopper (`repro_torch.kernels`: prox update, flash prefill, linear,
  paged and ring decode attention, the WKV and RG-LRU scans, and the
  two scans' backward kernels), each with its plain PyTorch version,
  which CPU tensors take.

Entry points run on the card unless the caller asks for the CPU, and
raise when there is no card.
"""
