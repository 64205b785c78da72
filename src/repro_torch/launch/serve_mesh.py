"""Serving across processes: one Engine, N ranks in lockstep (the port of
`repro/launch/serve_mesh.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve_mesh \\
        --processes 4 --model-parallel 2 --backend gloo --device cpu \\
        --arch qwen2-0.5b --smoke --requests 8 --max-batch 4 [--paged] \\
        [--no-overlap] [--arrival-rate R] [--num-blocks N] [--out stats.json]

Run with no `--process-id`, the script is the parent: it picks a free
port, spawns `--processes` copies of itself (one rank each, on the
("data", "model") mesh of `launch.mesh.make_serving_mesh`, data =
processes / model parallel), prints their output, and fails unless
every rank exits 0 and every `SERVE_MESH_OK process=… digest=…` line of
an arm carries the same digest. A rank that fails ends the others at
once; `--timeout` ends them all.

Every rank runs the same deterministic scheduler: the engine's host
state moves only with the submitted workload (seeded) and the `[B]`
token ids each step returns, which `ModelAxis.argmax` and the gathers
over "data" make equal on every rank. No rank sends another a
scheduling decision; lockstep follows from determinism, as in the
reference. Each rank holds its slice of the model
(`dist.tensor_parallel`): the heads of its kv heads, its slice of d_ff
and of the vocabulary (an MoE model's: its experts; an MLA model's: its
heads over the whole latents), drawn without the whole model
(`tensor_parallel.init_shard`), and the decode rows of its data line
(`dist.serving.RowSplit`: `--max-batch` / data of them, an arena of
those rows or the whole pool, of its kv heads), so the attention kernels
run on that shard. On a data axis above 1 the overlapped arms resolve
to the "async" overlap mode, as the reference's do. An MoE model serves
from the serialized arena (`--arms paged` says so in its record's
backend), as in one process, and so do rwkv6-1.6b and recurrentgemma-2b
(a rank: its RWKV heads or RG-LRU channels with their recurrent state,
recurrentgemma's one kv head whole), every prompt at its exact length.

`--arrival-rate R` submits the workload on a seeded, step-indexed
Poisson schedule (`_arrival_steps`), the same on every rank and in every
arm. Each arm replays the timed loop once as a warm-up, then times it;
process 0 writes the engine's stats with the reference's keys to
`--out`.

Beside the reference's flags: `--backend gloo|nccl` (NCCL needs a GPU a
rank; gloo shares a card through host buffers), `--device cuda|cpu`
(cuda unless asked), `--smoke` and `--layers` (as `launch.serve`;
`--arch tiny`, the default, is the reference's built-in bench config),
and `--arms` (several arms on one process group, each `arena` or
`paged`, with `-serialized` for `--no-overlap`; default: the one arm of
`--paged` and `--no-overlap`). Each arm prints a `SERVE_MESH_ARM
{json}` line a rank: its mesh, data line and overlap mode, its digest,
stats, step and admission ms, the axes' ms (also by axis) and bytes by
kind (checked against `dist.serving.serve_step_sends`), kernel launches
and peak memory.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from collections import Counter

from repro_torch.utils.device import resolve_device
from repro_torch.utils.hotpath import hot_loop


def _build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--model-parallel", type=int, default=2,
                    help='"model" mesh axis; the rest becomes "data"')
    ap.add_argument("--arch", default="tiny",
                    help='"tiny" (the reference\'s bench config) or an arch')
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the config's first N layers (0: all)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--mixed", action="store_true",
                    help="interleave short (new_tokens//4) and long budgets")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="mean Poisson arrivals per engine step (seeded, "
                         "step-indexed: the same schedule on every rank and "
                         "in every arm); 0 submits the whole workload up "
                         "front")
    ap.add_argument("--no-overlap", action="store_true",
                    help="serialized admission (overlap=False)")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="paged pool size (default: the engine's, the "
                         "arena's footprint)")
    ap.add_argument("--preemption", choices=("recompute", "reserve"),
                    default="recompute")
    ap.add_argument("--arms", default=None,
                    help="comma-separated arms run one after another on one "
                         "process group: arena or paged, optionally "
                         "-serialized (default: --paged / --no-overlap's)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="process 0 writes the engine stats JSON here")
    ap.add_argument("--timeout", type=int, default=600)
    # internal (set by the parent when spawning children)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    return ap


def _tiny_cfg():
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(name="mesh-serve-tiny", family="dense", source="bench",
                      num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=256, vocab_size=512,
                      tie_embeddings=True)


def _config(args):
    """The config of --arch (--smoke: its smoke config; tiny: the bench
    config), cut to --layers."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke

    if args.arch == "tiny":
        cfg = _tiny_cfg()
    else:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers,
                                  layer_types=cfg.layer_types[:args.layers])
    return cfg


def _workload(cfg, args):
    import numpy as np
    rng = np.random.default_rng(0)
    short = max(1, args.new_tokens // 4)
    return [(rng.integers(0, cfg.vocab_size, (args.prompt_len,)),
             short if (args.mixed and i % 2 == 0) else args.new_tokens)
            for i in range(args.requests)]


def _arrival_steps(n, rate):
    """Engine-step index at which request i is submitted: Poisson gaps
    drawn once from a fixed seed and floored onto step numbers, so every
    rank and every arm replays one arrival schedule."""
    import numpy as np
    if rate <= 0:
        return [0] * n
    rng = np.random.default_rng(1234)
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.floor(np.cumsum(gaps)).astype(int).tolist()


def _digest(done):
    h = hashlib.sha256()
    for r in sorted(done, key=lambda r: r.uid):
        h.update(f"{r.uid}:{r.output.tolist()}".encode())
    return h.hexdigest()[:16]


def arms_of(args):
    """[(name, paged, overlap)] of --arms, or the one arm of --paged and
    --no-overlap."""
    names = (args.arms.split(",") if args.arms else
             [("paged" if args.paged else "arena")
              + ("-serialized" if args.no_overlap else "")])
    out = []
    for name in names:
        base, _, flag = name.partition("-")
        if base not in ("arena", "paged") or flag not in ("", "serialized"):
            raise ValueError(f"arm {name!r}: arena or paged, optionally "
                             "-serialized")
        out.append((name, base == "paged", not flag))
    return out


def expected_sends(eng, st, cfg, mesh, rank, plen):
    """{kind: bytes} rank `rank` sends in the steps of `eng` that `st` (a
    pass's count of `Engine.stats`) counts, from `dist.serving.
    serve_step_sends`: plain decode steps, mixed steps (each carrying a
    prefill unit of a `plen`-token prompt: its padded prompt on the
    arena, a chunk on the pool), its data line's prefill launches outside
    them (`line_prefill_units`) and the first tokens' gathers."""
    from repro_torch.dist.serving import serve_step_sends
    from repro_torch.serve.bucketing import bucket_length

    def per(rows):
        return serve_step_sends(cfg, mesh, eng.max_batch, rows)[rank]

    calls = [(per(0)["decode"], st["decode_steps"] - st["mixed_steps"]),
             (per(0)["first_token"], st["first_tokens"])]
    if st["mixed_steps"]:
        unit = (eng.prefill_chunk if eng.paged
                else min(bucket_length(plen, 8), eng.capacity))
        calls.append((per(unit)["mixed"], st["mixed_steps"]))
    for rows, n in st["line_prefill_units"].items():
        calls.append((per(int(rows))["admission"], n))
    total = {}
    for sends, n in calls:
        for kind, b in sends.items():
            total[kind] = total.get(kind, 0) + n * b
    return total


def run_child(args) -> int:
    t_enter = time.perf_counter()
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.decode_attention_paged import (
        decode_attention_paged_cuda, decode_attention_ring_cuda)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rglru_scan import rglru_scan_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    from repro_torch.dist.tensor_parallel import init_shard
    from repro_torch.launch.mesh import (init_distributed, make_serving_mesh,
                                         rank_device)
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, bucket_length

    counters = {"flash_attention": flash_attention_cuda,
                "decode_attention": decode_attention_cuda,
                "decode_attention_paged": decode_attention_paged_cuda,
                "decode_attention_ring": decode_attention_ring_cuda,
                "rwkv6_scan": rwkv6_scan_cuda, "rglru_scan": rglru_scan_cuda}
    pid = args.process_id
    device = rank_device(resolve_device(args.device), pid)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        # f32 products (an f32 config's, a rank's row-parallel partial
        # products) in full f32, never TF32, as `launch.serve` serves
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)        # the ranks share the host's cores
    init_distributed(pid, args.processes, args.coordinator, args.backend,
                     device, timeout_s=args.timeout)
    mesh = make_serving_mesh(args.model_parallel)
    print(f"[proc {pid}] {args.processes} processes, mesh "
          f"{mesh.shape}, backend {args.backend}, device {device}",
          flush=True)

    cfg = _config(args)
    model = build_model(cfg)
    # the rank's piece of the one init (one seed, one device kind), drawn
    # without the whole model; every engine serves it
    params = init_shard(cfg, torch.Generator(device=device).manual_seed(0),
                        mesh)
    max_len = bucket_length(args.prompt_len + args.new_tokens)
    setup_s = time.perf_counter() - t_enter
    payloads = []
    reqs = _workload(cfg, args)
    arrive = _arrival_steps(len(reqs), args.arrival_rate)
    for name, paged, overlap in arms_of(args):
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        eng = Engine(model, params, max_batch=args.max_batch,
                     max_len=max_len, mesh=mesh, paged=paged,
                     block_size=args.block_size, num_blocks=args.num_blocks,
                     preemption=args.preemption, overlap=overlap)
        backend = "paged" if eng.paged else "arena"

        @hot_loop
        def _run_workload():
            """Submit `reqs` on the arrival schedule and drain; returns
            {uid: Request} for this pass only."""
            uids, done, nxt, step_i = set(), {}, 0, 0
            while nxt < len(reqs) or eng.num_active or eng.pending:
                while nxt < len(reqs) and arrive[nxt] <= step_i:
                    p, b = reqs[nxt]
                    uids.add(eng.submit(p, max_new_tokens=b))
                    nxt += 1
                for r in eng.step():
                    done[r.uid] = r
                step_i += 1
            return {u: r for u, r in done.items() if u in uids}

        # warm up by replaying the timed loop once: the engine is
        # deterministic, so the timed pass repeats its launch sequence
        # (and the mixed steps an up-front warm-up would miss)
        _run_workload()
        eng._done.clear()
        warm = eng.stats
        comm = eng.comm
        if comm is not None:
            comm.reset()
        for fn in counters.values():
            fn.launches = 0
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        done = _run_workload()
        if cuda:
            torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t0
        stats = eng.stats
        delta = {k: (stats[k] - warm[k]
                     if isinstance(stats[k], (int, float, Counter))
                     else stats[k])
                 for k in stats}
        # gauges, not counters: the live values
        delta["decode_fetch_elems"] = stats["decode_fetch_elems"]
        delta["decode_fetch_dtype"] = stats["decode_fetch_dtype"]
        digest = _digest(done.values())
        toks = sum(len(r.output) for r in done.values())
        adm = max(delta["admissions"], 1)
        dsteps = max(delta["decode_steps"], 1)
        derived = {
            "admit_host_ms_per_admission": 1e3 * delta["admit_host_s"] / adm,
            "prefill_wait_ms_per_admission":
                1e3 * delta["prefill_wait_s"] / adm,
            "admission_ms_per_admission":
                1e3 * (delta["admit_host_s"] + delta["prefill_wait_s"]) / adm,
            "decode_step_ms": 1e3 * delta["decode_s"] / dsteps,
            "admission_over_decode_step":
                (delta["admit_host_s"] + delta["prefill_wait_s"]) / adm
                / max(delta["decode_s"] / dsteps, 1e-12),
            "h2d_uploads_per_decode_step": delta["h2d_uploads"] / dsteps,
            "throughput_tok_s": toks / max(wall_s, 1e-12),
        }
        sent = dict(comm.sent) if comm is not None else {}
        want = ({} if comm is None else
                expected_sends(eng, delta, cfg, mesh, mesh.rank,
                               args.prompt_len))
        axis_ms = dict(comm.ms) if comm is not None else {}
        record = {
            "arm": name, "arch": cfg.name, "process": pid, "backend": backend,
            "mesh": mesh.shape, "data_index": eng.rows.index,
            "overlap": eng.overlap, "overlap_mode": eng.overlap_mode,
            "digest": digest, "outputs": [
                r.output.tolist()
                for r in sorted(done.values(), key=lambda r: r.uid)],
            "completed": len(done), "tokens": toks,
            "wall_s": wall_s, "engine_stats": delta, "derived": derived,
            "axis_ms": axis_ms,
            "axis_ms_per_decode_step": sum(axis_ms.values()) / dsteps,
            # the same milliseconds by the axis each call ran on
            "axis_ms_by_axis": ({str(a): v for a, v in comm.axis_ms.items()}
                                if comm is not None else {}),
            "sent": sent, "sent_reckoned": want,
            "calls": dict(comm.calls) if comm is not None else {},
            "launches": {k: fn.launches for k, fn in counters.items()},
            "free_blocks": eng.free_blocks,
            "num_blocks": eng.num_blocks if eng.paged else None,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if cuda else None),
            "setup_s": setup_s, "device": str(device)}
        print(f"[proc {pid}] {name} {backend}"
              f"[{eng.overlap_mode or 'serialized'}] data line "
              f"{eng.rows.index}: "
              f"{len(done)}/{len(reqs)} requests, {toks} tokens in "
              f"{wall_s:.2f}s; admission "
              f"{derived['admission_ms_per_admission']:.2f} ms/req, decode "
              f"step {derived['decode_step_ms']:.2f} ms (axes "
              f"{record['axis_ms_per_decode_step']:.2f}), fetch "
              f"[{delta['decode_fetch_elems']}] "
              f"{delta['decode_fetch_dtype']}, mixed_steps "
              f"{delta['mixed_steps']}, overlapped_admissions "
              f"{delta['overlapped_admissions']}, sent {sent}", flush=True)
        if sent != want:
            raise RuntimeError(f"arm {name}: rank {mesh.rank} sent {sent}, "
                               f"serve_step_sends reckons {want}")
        print("SERVE_MESH_ARM " + json.dumps(record), flush=True)
        payloads.append({
            "backend": backend, "arm": name,
            "num_processes": args.processes,
            "devices": args.processes,
            "mesh": mesh.shape,
            "arch": cfg.name,
            "workload": {"requests": args.requests,
                         "prompt_len": args.prompt_len,
                         "new_tokens": args.new_tokens,
                         "mixed": bool(args.mixed),
                         "max_batch": args.max_batch,
                         "arrival_rate": args.arrival_rate,
                         "overlap": bool(eng.overlap),
                         "preemption": args.preemption
                         if backend == "paged" else None},
            "completed": len(done), "tokens": toks,
            "wall_s": round(wall_s, 4),
            "free_blocks": eng.free_blocks,
            "num_blocks": eng.num_blocks if backend == "paged" else None,
            "engine_stats": {k: (round(v, 6) if isinstance(v, float) else v)
                             for k, v in delta.items()},
            "derived": {k: round(v, 4) for k, v in derived.items()},
            "output_digest": digest})
        # the parent checks these digests agree across all processes
        print(f"SERVE_MESH_OK process={pid} digest={digest} arm={name}",
              flush=True)
        del eng
        if cuda:
            torch.cuda.empty_cache()

    if args.out and pid == 0:
        with open(args.out, "w") as f:
            json.dump(payloads[0] if len(payloads) == 1 else payloads, f,
                      indent=1)
        print(f"[proc {pid}] wrote {args.out}", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_parent(args, argv) -> int:
    """Spawn the ranks, wait for them (a rank that fails ends the others;
    --timeout ends all), print their output and check that every arm's
    digests agree. Returns 0 when they do."""
    from repro_torch.launch.mesh import check_backend, run_ranks

    check_backend(args.backend, args.processes, resolve_device(args.device))
    arms = [name for name, *_ in arms_of(args)]
    run = run_ranks("repro_torch.launch.serve_mesh", argv, args.processes,
                    "--process-id", args.timeout)
    digests = {arm: [] for arm in arms}
    for i, out in enumerate(run.outs):
        for line in out.splitlines():
            print(f"  p{i}| {line}", flush=True)
            if line.startswith("SERVE_MESH_OK"):
                fields = dict(kv.split("=", 1) for kv in line.split()[1:])
                digests.setdefault(fields.get("arm"), []).append(
                    fields["digest"])
    ok = (not run.timed_out and all(rc == 0 for rc in run.rcs)
          and all(len(d) == args.processes and len(set(d)) == 1
                  for d in digests.values()))
    if ok:
        for arm, d in digests.items():
            print(f"[parent] {args.processes} processes agree on {arm} "
                  f"(digest {d[0]})", flush=True)
        return 0
    print(f"[parent] FAILED: rcs={run.rcs} digests={digests}"
          + (f" (timed out after {args.timeout} s)" if run.timed_out
             else ""), flush=True)
    return 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = _build_parser().parse_args(argv)
    if args.process_id is not None:
        sys.exit(run_child(args))
    sys.exit(run_parent(args, argv))


if __name__ == "__main__":
    main()
