"""repro_torch.dist — the port's API-BCD runtimes (the port of
`repro/dist`):

  trainer        — init_train_state / make_train_step (the API-BCD
                   superstep on a language model, one process) /
                   make_dp_baseline_step; make_mesh_train_step and
                   make_mesh_dp_baseline_step, the same steps across
                   processes (one agent a rank line: tensor-parallel
                   over "model", FSDP over "replica").
  sharding       — specs for the training and serving meshes, and the
                   cuts of a tensor into its ranks' pieces.
  collectives    — ring shift, all-gather, reduce-scatter, all-reduce
                   and gather over a mesh's axes, as point-to-point
                   sends, with bytes counted per kind.
  tensor_parallel — the "model" axis for the dense GQA family: a rank's
                   config and parameter shard, and its collectives
                   (the sums of the row-parallel products and their
                   conjugate for training, the vocabulary-parallel
                   embedding, cross-entropy and argmax).
  serving        — serving on a ("data", "model") mesh: the reference's
                   specs, the rank's model (`local_model`) whose token
                   steps `Engine(mesh=...)` serves with, and the bytes
                   a step sends.
  async_trainer  — the TRUE-async runtime: per-process event loops over
                   sharded agents, bounded-staleness token exchange,
                   adaptive update rates, straggler injection
                   (`launch/train_async.py` drives it multi-process).
  async_schedule — deterministic virtual-time schedules + the
                   bounded-staleness gate (digest reproducibility).
  async_comm     — block-update transports (torch.distributed TCPStore,
                   file, in-memory).

The event-driven simulator of Algorithm 2's *cost model* lives in
`repro_torch.core.simulator`; `async_trainer` is where wall-clock
asynchrony runs on a real multi-process runtime.
"""
from repro_torch.dist import (  # noqa: F401
    async_comm, async_schedule, async_trainer, collectives, serving,
    sharding, tensor_parallel, trainer)
