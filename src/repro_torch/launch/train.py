"""End-to-end API-BCD decentralized LM training on one GPU.

Runs on CUDA unless --device cpu is given; with no GPU it raises rather
than run on the CPU unasked. Example (full qwen2-0.5b width on an H100):

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen2-0.5b --agents 4 --walks 2 --steps 3 \
        --batch-per-agent 2 --seq 256

and at smoke size on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --agents 4 --walks 2 --steps 10 --batch-per-agent 2 \
        --seq 64 --device cpu

`--baseline` runs the synchronous all-reduce DP baseline instead (adamw,
no weight decay, a constant rate of 3e-4, on the global batch [A * B,
S]); `--checkpoint-dir DIR` writes the API-BCD state after the last
step in the reference's checkpoint format. `--arch dbrx-132b --smoke`
trains the mixture of experts (its loss adds the load-balance term,
printed as `aux`); at full width one dbrx layer's state would pass the
card's 80 GB.

Across processes (the reference's mesh, `--devices`): `--processes N`
spawns N ranks of the ("agent", "replica", "model") mesh, one agent a
rank line with its state split over "model" (tensor parallelism over
`--model-parallel` ranks: heads, d_ff and vocabulary, `dist.
tensor_parallel`) and FSDP-sharded over "replica"
(`dist.trainer.make_mesh_train_step`); as the reference, the replica
count is N / (agents x --model-parallel):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --agents 4 --walks 2 --steps 4 --batch-per-agent 2 \
        --seq 64 --processes 4 --backend gloo --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --smoke --agents 2 --walks 1 --steps 4 --batch-per-agent 2 \
        --seq 64 --processes 4 --model-parallel 2 --device cpu

The parent picks a port, spawns the ranks (each joins the default group
through a TCPStore and builds the same init from the same seeded
generator, keeping its own piece) and checks that every rank's metrics
agree and, on a model axis above 1, that the leaves it does not split
are bitwise equal across each model line. `--backend` names the
transport: gloo (host tensors; on the card a CUDA tensor goes through a
pinned host buffer, so ranks may share one GPU) or nccl (one GPU a
rank). Each rank prints, per superstep, the host ms, the token hop's ms,
the model axis's ms and the bytes it sent, and at the end one digest per
state part of its agent slot and its peak memory.

`--layers N` keeps the config's first N layers at full width, as
`launch.serve --layers` does: the same model, shallower, for a run
whose depth one card (or a time limit) cannot take; 0 keeps them all.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time

from repro_torch.utils.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-feasible)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the config's first N layers (0: all)")
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--walks", type=int, default=2)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-per-agent", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tau", type=float, default=0.05)
    ap.add_argument("--rho", type=float, default=20.0)
    ap.add_argument("--baseline", action="store_true",
                    help="run the synchronous all-reduce DP baseline "
                         "instead of API-BCD")
    ap.add_argument("--paper-faithful", action="store_true",
                    help="disable gradient accumulation between visits "
                         "(idle agents, as in the paper)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--log-dir", default=None,
                    help="write JSONL metrics here")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--processes", type=int, default=0,
                    help="run the superstep across N processes (0: one "
                         "process), N / (agents x model parallel) FSDP "
                         "replicas of each agent")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor parallel width (with --processes): the "
                         "mesh's \"model\" axis")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="the transport between processes")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a run across processes may take")
    # internal (set by the parent when it spawns the ranks)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args(argv)
    # what a parent passes on to the ranks it spawns
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args


def tensor_digest(t, chunk=1 << 24):
    """An integer digest of a tensor's bytes, computed where it lives: the
    bytes read as 32-bit words b_i (16- or 8-bit where the size asks),
    the sum over i of (b_i * w_i mod 2^32) with odd weights w_i = (2i + 1)
    mod 2^31, mod 2^64. An odd weight is invertible mod 2^32, so a change
    in any one word changes its term; no product or chunk sum overflows
    int64. Bitwise-equal tensors give equal digests."""
    import torch

    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    width = 4 if raw.numel() % 4 == 0 else 2 if raw.numel() % 2 == 0 else 1
    words = raw.view({4: torch.int32, 2: torch.int16,
                      1: torch.uint8}[width])
    mask = (1 << (8 * width)) - 1
    total = 0
    for s in range(0, words.numel(), chunk):
        b = words[s:s + chunk].to(torch.int64) & mask
        w = (torch.arange(s, s + b.numel(), dtype=torch.int64,
                          device=b.device) * 2 + 1) & 0x7FFFFFFF
        total += int(((b * w) & 0xFFFFFFFF).sum())
    return total % (1 << 64)


def part_digests(state, slot=None):
    """{part: 16 hex digits} over the part's leaves in key order: the
    leaves themselves, or their agent slot `slot` (as [1, ...])."""
    out = {}
    for part, leaves in state.items():
        h = hashlib.sha256()
        for k in sorted(leaves):
            v = leaves[k] if slot is None else leaves[k][slot:slot + 1]
            h.update(f"{k}:{tuple(v.shape)}:{tensor_digest(v)};".encode())
        out[part] = h.hexdigest()[:16]
    return out


def _config(args):
    """The config of --arch (--smoke: its smoke config), cut to --layers."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers,
                                  layer_types=cfg.layer_types[:args.layers])
    return cfg


def train(args):
    """Run args.steps supersteps (or DP baseline steps with
    args.baseline). Returns {"losses", "auxs" (the MoE load-balance term
    of each loss, 0 without MoE layers), "step_ms", "peak_bytes",
    "device"}; peak_bytes is None on the CPU. With args.processes, the
    run across processes (`train_processes`)."""
    if args.rank is not None:
        return train_rank(args)
    if args.processes:
        return train_processes(args)
    if args.model_parallel != 1:
        raise ValueError("--model-parallel splits a model over the ranks of "
                         "a run across processes: give --processes")
    import numpy as np
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.tokens import agent_batches
    from repro_torch.dist.trainer import (
        init_train_state, make_dp_baseline_step, make_train_step)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, constant
    from repro_torch.utils.logging import MetricLogger

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        # f32 products in full f32, as the reference computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)

    cfg = _config(args)
    model = build_model(cfg)
    a = args.agents
    print(f"agents={a} walks={args.walks} arch={cfg.name} device={device}"
          + (" baseline" if args.baseline else ""))
    tcfg = TrainConfig(num_agents=a, num_walks=args.walks, tau=args.tau,
                       rho=args.rho,
                       accumulate_between_visits=not args.paper_faithful)
    batches = agent_batches(cfg.vocab_size, a, args.batch_per_agent,
                            args.seq, seed=0)
    generator = torch.Generator(device=device).manual_seed(0)
    if args.baseline:
        opt = adamw(weight_decay=0.0)
        params = model.init(generator)
        opt_state = opt.init(params)
        dp_step = make_dp_baseline_step(model, opt, constant(3e-4))
    else:
        state = init_train_state(model, tcfg, generator)
        train_step = make_train_step(model, tcfg)

    logger = MetricLogger(args.log_dir, echo_every=args.log_every)
    losses, auxs, step_ms = [], [], []
    for step in range(args.steps):
        toks, targs = next(batches)
        if args.baseline:       # the global batch [A * B, S]
            toks, targs = (x.reshape(-1, args.seq) for x in (toks, targs))
        batch = {"tokens": torch.from_numpy(toks).to(device),
                 "targets": torch.from_numpy(targs).to(device)}
        t0 = time.perf_counter()
        if args.baseline:
            params, opt_state, metrics = dp_step(params, opt_state, batch,
                                                 step)
        else:
            state, metrics = train_step(state, batch, step)
        if cuda:
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        loss = float(metrics["loss"])
        losses.append(loss)
        auxs.append(float(metrics["aux"]))
        logger.log(step, loss=loss, nll=float(metrics["nll"]),
                   aux=auxs[-1], step_ms=step_ms[-1])
    logger.close()
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"non-finite loss: {losses}")
    if args.checkpoint_dir and not args.baseline:
        save_checkpoint(args.checkpoint_dir, state, step=args.steps,
                        metadata={"arch": cfg.name})
        print("checkpoint written to", args.checkpoint_dir)
    return {"losses": losses, "auxs": auxs, "step_ms": step_ms,
            "device": str(device),
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if cuda else None)}


def _replica(args):
    """The replica count of a run across processes: processes / (agents x
    model parallel), as the reference derives it from its devices.
    Refuses what a run across processes cannot do, before a process
    starts: a model axis above 1 trains the dense attention stack only
    (`tensor_parallel.check_tensor_parallel(training=True)` names the
    ROADMAP item that would split the rest)."""
    if args.model_parallel > 1:
        from repro_torch.dist.tensor_parallel import check_tensor_parallel

        check_tensor_parallel(_config(args), args.model_parallel,
                              training=True)
    line = args.agents * args.model_parallel
    if args.processes % line:
        raise ValueError(f"--processes {args.processes} is not a multiple "
                         f"of agents x model parallel = {args.agents} x "
                         f"{args.model_parallel}")
    return args.processes // line


def train_processes(args):
    """The parent of a run across processes: spawn args.processes ranks of
    this module (`launch.mesh.run_ranks`), wait for them (a rank that
    fails ends the others) and check that they agree. Returns {"ranks":
    [each rank's result], "losses", "step_ms" (the slowest rank's),
    "device", "backend"}; raises if a rank failed."""
    from repro_torch.launch.mesh import check_backend, run_ranks
    from repro_torch.utils.device import resolve_device

    replica = _replica(args)
    device = resolve_device(args.device)
    check_backend(args.backend, args.processes, device)
    print(f"mesh: agents={args.agents} replica={replica} "
          f"model={args.model_parallel} processes={args.processes} "
          f"backend={args.backend} device={device}", flush=True)
    # the collectives' roofline is reckoned while the ranks start
    run = run_ranks("repro_torch.launch.train", args.argv, args.processes,
                    "--rank", args.timeout,
                    while_running=None if args.baseline else
                    lambda: _collective(args, replica))
    collective = run.during
    results = []
    for r, out in enumerate(run.outs):
        for line in out.splitlines():
            print(f"  r{r}| {line}", flush=True)
            if line.startswith("MESH_RANK "):
                results.append(json.loads(line[len("MESH_RANK "):]))
    if any(run.rcs) or len(results) != args.processes:
        raise RuntimeError(f"a rank failed: exit codes {run.rcs}")
    losses = [res["losses"] for res in results]
    if any(x != losses[0] for x in losses):
        raise RuntimeError(f"the ranks' metrics disagree: {losses}")
    print(f"[parent] {args.processes} ranks agree: losses {losses[0]}",
          flush=True)
    if args.model_parallel > 1:
        lines = {}
        for res in results:
            where = (res["coords"]["agent"], res["coords"]["replica"])
            lines.setdefault(where, []).append(res["replicated"])
        if any(d != got[0] for got in lines.values() for d in got):
            raise RuntimeError(f"the leaves the model axis does not split "
                               f"differ across a model line: {lines}")
        print(f"[parent] the leaves the model axis does not split are "
              f"bitwise equal across each of the {len(lines)} model lines",
              flush=True)
    # a rank's clock readings are the host's monotonic clock, as the
    # parent's: where its launch time went
    for res in results:
        r = res["rank"]
        res["start_s"] = res["clock"]["enter"] - run.spawned
        res["exit_s"] = run.exited[r] - res["clock"]["line"]
        print(f"[parent] rank {r}: start {res['start_s']:.1f} s, setup "
              f"{res['setup_s']:.1f}, supersteps "
              f"{sum(res['step_ms']) / 1e3:.1f}, finish "
              f"{res['finish_s']:.1f}, exit {res['exit_s']:.1f}; all ranks "
              f"done {max(run.exited.values()) - run.spawned:.1f} s after "
              f"the spawn", flush=True)
    if collective is not None:
        print(f"[parent] a superstep's collective bytes (all ranks) "
              f"{collective.collective_bytes:.0f}: "
              f"{collective.collective_s * 1e3:.3f} ms at the NVLink rate "
              f"on {args.processes} GPUs", flush=True)
    return {"ranks": results, "losses": losses[0],
            "roofline": collective and collective.as_dict(),
            "step_ms": [max(res["step_ms"][i] for res in results)
                        for i in range(len(losses[0]))],
            "device": str(device), "backend": args.backend}


def _collective(args, replica):
    """The `utils.roofline.Roofline` of a superstep's collectives: the
    bytes every rank sends (`trainer.mesh_collective_bytes`) over
    args.processes GPUs."""
    from repro_torch.dist.trainer import _param_shapes, mesh_collective_bytes
    from repro_torch.models import build_model
    from repro_torch.utils.roofline import Roofline

    sizes = {"agent": args.agents, "replica": replica,
             "model": args.model_parallel}
    cfg = _config(args)
    return Roofline({}, 0, collective_bytes=mesh_collective_bytes(
        _param_shapes(build_model(cfg)), sizes, args.batch_per_agent,
        cfg=cfg, seq=args.seq), chips=args.processes)


def train_rank(args):
    """One rank of a run across processes: join the group, build the
    mesh, the rank's part of the state and the step, run args.steps
    steps on the global batch stream, then print its result as one
    `MESH_RANK {json}` line, with the seconds from entry (torch already
    imported) to the first step (the port's imports, joining the group,
    the init and the step's build: `setup_s`), from the last step to the
    line (`finish_s`), and the host's monotonic clock at entry and at the
    line (`clock`), which the parent sets against its own."""
    t_enter = time.perf_counter()
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.tokens import agent_batches
    from repro_torch.dist.collectives import Collectives
    from repro_torch.dist.sharding import gather_shards
    from repro_torch.dist.tensor_parallel import param_specs, shard_params
    from repro_torch.dist.trainer import (
        init_mesh_train_state, make_mesh_dp_baseline_step,
        make_mesh_train_step, state_specs)
    from repro_torch.kernels.prox_update import prox_update_cuda
    from repro_torch.launch.mesh import (init_distributed,
                                         make_training_mesh, rank_device)
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, constant
    from repro_torch.utils.device import resolve_device

    replica = _replica(args)
    rank = args.rank
    device = rank_device(resolve_device(args.device), rank)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        # the ranks share the host's cores
        torch.set_num_threads(1)
    init_distributed(rank, args.processes, args.coordinator, args.backend,
                     device, timeout_s=args.timeout)
    mesh = make_training_mesh(args.agents, replica, args.model_parallel)
    comm = Collectives(mesh, device)
    cfg = _config(args)
    model = build_model(cfg)
    tcfg = TrainConfig(num_agents=args.agents, num_walks=args.walks,
                       tau=args.tau, rho=args.rho,
                       accumulate_between_visits=not args.paper_faithful)
    generator = torch.Generator(device=device).manual_seed(0)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if args.baseline:
        opt = adamw(weight_decay=0.0)
        whole = model.init(generator)
        # the leaves' split on the model axis (nothing split where it is 1)
        specs = {"params": param_specs(cfg, whole)}
        params = shard_params(cfg, whole, mesh)
        del whole
        opt_state = opt.init(params)
        step_fn = make_mesh_dp_baseline_step(model, opt, constant(3e-4),
                                             mesh, comm)
    else:
        state = init_mesh_train_state(model, tcfg, mesh, generator)
        specs = state_specs(model, tcfg, mesh)
        step_fn = make_mesh_train_step(model, tcfg, mesh, comm)
    batches = agent_batches(cfg.vocab_size, args.agents,
                            args.batch_per_agent, args.seq, seed=0)
    prox_update_cuda.launches = 0
    losses, auxs, step_ms, hop_ms, axis_ms, sent = [], [], [], [], [], []
    setup_s = time.perf_counter() - t_enter
    for step in range(args.steps):
        toks, targs = next(batches)
        if args.baseline:       # the global batch [A * B, S]
            toks, targs = (x.reshape(-1, args.seq) for x in (toks, targs))
        batch = {"tokens": torch.from_numpy(toks).to(device),
                 "targets": torch.from_numpy(targs).to(device)}
        comm.reset()
        t0 = time.perf_counter()
        if args.baseline:
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
        else:
            state, metrics = step_fn(state, batch, step)
        if cuda:
            torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        hop_ms.append(comm.ms["ring_shift"])
        axis_ms.append(comm.axis_ms["model"])
        sent.append(dict(comm.sent))
        losses.append(float(metrics["loss"]))
        auxs.append(float(metrics["aux"]))
        if args.log_every and step % args.log_every == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  step_ms "
                  f"{step_ms[-1]:.1f}  hop_ms {hop_ms[-1]:.1f}  axis_ms "
                  f"{axis_ms[-1]:.1f}  sent {sum(sent[-1].values())} B",
                  flush=True)
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"non-finite loss: {losses}")
    t_steps = time.perf_counter()
    result = {"rank": rank, "coords": mesh.coords, "device": str(device),
              "backend": args.backend, "losses": losses, "auxs": auxs,
              "step_ms": step_ms, "hop_ms": hop_ms, "axis_ms": axis_ms,
              "sent": sent,
              "prox_update_launches": prox_update_cuda.launches,
              "peak_bytes": (torch.cuda.max_memory_allocated(device)
                             if cuda else None)}
    parts = {"params": params} if args.baseline else state
    result["digests"] = part_digests(parts)
    if args.model_parallel > 1:
        # the leaves the model axis does not split: equal across a line
        result["replicated"] = part_digests({
            part: {k: v for k, v in leaves.items()
                   if "model" not in specs[part][k]}
            for part, leaves in parts.items()})
    if args.checkpoint_dir and not args.baseline:
        # leaf by leaf to rank 0, which joins the pieces
        whole = {}
        for part, leaves in state.items():
            whole[part] = {}
            for k, v in leaves.items():
                pieces = comm.gather(v, dst=0)
                if pieces is not None:
                    whole[part][k] = gather_shards(
                        [p.cpu() for p in pieces], specs[part][k], mesh)
        if rank == 0:
            save_checkpoint(args.checkpoint_dir, whole, step=args.steps,
                            metadata={"arch": cfg.name})
            print("checkpoint written to", args.checkpoint_dir, flush=True)
    result["setup_s"] = setup_s
    result["finish_s"] = time.perf_counter() - t_steps
    result["clock"] = {"enter": t_enter, "line": time.perf_counter()}
    print(f"rank {rank} {mesh.coords}: digests {result['digests']} peak "
          f"{(result['peak_bytes'] or 0) / 1e9:.2f} GB setup "
          f"{setup_s:.1f} s finish {result['finish_s']:.1f} s", flush=True)
    print("MESH_RANK " + json.dumps(result), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return result


def main(argv=None):
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
