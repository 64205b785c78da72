"""Multi-process true-async API-BCD training driver (the port of
`repro/launch/train_async.py`).

    PYTHONPATH=src python -m repro_torch.launch.train_async \
        --processes 2 --agents 8 --walks 2 --rounds 60 \
        --local-steps 4 --max-delay 4 --adaptive \
        --straggle 1:3.0 --min-update-ms 2 [--out run.json]

and on the CPU, at a small size:

    PYTHONPATH=src python -m repro_torch.launch.train_async \
        --processes 2 --agents 6 --rounds 6 --subsample 256 --device cpu

Run with no ``--process-id``, the script is the *parent*: it spawns
``--processes`` copies of itself — one worker process each — streams
their output, and verifies every process computed the **identical**
shared-estimate digest.  Each child runs one
`repro_torch.dist.async_trainer.AsyncWorker` event loop over its
contiguous agent shard, on ``--device`` (the card unless ``--device
cpu`` is given: without a card the parent, and each child, raises),
exchanging token-block updates through a `torch.distributed.TCPStore`
(``--transport tcp``, the default: process 0 hosts the store) or a
shared directory (``--transport file``).  Every child of a run on the
card shares the one card, each with a CUDA context of its own.

Asynchrony knobs:

  * ``--max-delay D`` — bounded staleness: no process runs more than D
    sync rounds ahead of the slowest peer (0 = synchronous lockstep
    superstep).
  * ``--local-steps L`` / ``--adaptive`` — walk updates per sync;
    adaptive scales per-process counts by declared speed so stragglers
    sync at the fleet cadence instead of stalling it.
  * ``--mid-round`` — apply peer deltas *between* local steps at the
    schedule's deterministic ingestion points (staleness shrinks, the
    digest doesn't move; ``--max-delay 0 --mid-round`` is textbook BSP).
  * ``--measured-speeds`` / ``--rate-rounds`` — adapt from *measured*
    per-update wall time instead of the declared ``--straggle`` vector:
    every ``--rate-rounds`` rounds each process publishes the quantized
    bucket of its update-time EMA, the fleet agrees on the bucket
    vector through the KV, and the next epoch's schedule is rebuilt
    from it (raw wall times never cross the determinism boundary).
  * ``--straggle p:f[,q:g]`` — straggler injection: process p's updates
    are padded to f× the nominal ``--min-update-ms`` duration.

Every process computes the same deterministic schedule and applies the
same block updates in the same order, so seeded runs are bitwise
digest-reproducible across processes — while the wall-clock trace each
process records is genuinely asynchronous.  Process 0 gathers all
traces and writes ``--out``.
"""
from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time


def _build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--transport", choices=("tcp", "file"), default="tcp")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for every process")
    ap.add_argument("--dataset", default="cpusmall",
                    help="synthetic surrogate dataset (repro_torch.data)")
    ap.add_argument("--subsample", type=int, default=2048,
                    help="rows drawn from the dataset (keeps runs fast)")
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--walks", type=int, default=2)
    ap.add_argument("--method", choices=("apibcd", "gapibcd"),
                    default="apibcd")
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--rho", type=float, default=5.0,
                    help="gAPI-BCD proximal weight (method=gapibcd)")
    ap.add_argument("--rule", choices=("walk", "fresh"), default="walk")
    ap.add_argument("--rounds", type=int, default=60,
                    help="sync rounds per process")
    ap.add_argument("--local-steps", type=int, default=1,
                    help="walk updates per sync round (base)")
    ap.add_argument("--max-delay", type=int, default=0,
                    help="staleness bound in rounds; -1 = unbounded")
    ap.add_argument("--adaptive", action="store_true",
                    help="speed-adapted per-round update counts")
    ap.add_argument("--mid-round", action="store_true",
                    help="apply peer deltas between local steps at the "
                         "schedule's deterministic ingestion points")
    ap.add_argument("--measured-speeds", action="store_true",
                    help="adapt from measured update-time buckets agreed "
                         "through the KV instead of --straggle")
    ap.add_argument("--rate-rounds", type=int, default=8,
                    help="rounds per rate-sync epoch (measured mode)")
    ap.add_argument("--straggle", default="",
                    help='per-process slowdowns, e.g. "1:3.0,2:1.5"')
    ap.add_argument("--min-update-ms", type=float, default=0.0,
                    help="per-update duration floor (straggler hook unit)")
    ap.add_argument("--walk-kind", choices=("cyclic", "random"),
                    default="cyclic")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="process 0 writes the merged run JSON here")
    ap.add_argument("--timeout", type=int, default=600)
    # internal (set by the parent when spawning children)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--kv-dir", default=None)
    return ap


def parse_straggle(spec: str, num_procs: int):
    speeds = [1.0] * num_procs
    if spec:
        for part in spec.split(","):
            pid, factor = part.split(":")
            speeds[int(pid)] = float(factor)
    return speeds


def run_child(args) -> int:
    import torch

    from repro_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    # the processes share the host: tiny f64 ops gain nothing from threads
    torch.set_num_threads(1)
    pid = args.process_id
    if args.transport == "tcp":
        from repro_torch.dist.async_comm import TCPStoreKV

        host, port = args.coordinator.rsplit(":", 1)
        kv = TCPStoreKV(host, int(port), args.processes, pid,
                        timeout_s=float(args.timeout))
    else:
        from repro_torch.dist.async_comm import FileKV
        kv = FileKV(args.kv_dir)

    from repro_torch.core.methods import APIBCD, GAPIBCD
    from repro_torch.data import make_problem
    from repro_torch.dist.async_comm import decode, encode
    from repro_torch.dist.async_trainer import AsyncBCDConfig, AsyncWorker

    problem = make_problem(args.dataset, args.agents, seed=args.seed,
                           subsample=args.subsample)
    if args.method == "apibcd":
        method = APIBCD(problem, tau=args.tau, num_walks=args.walks,
                        device=device)
    else:
        method = GAPIBCD(problem, tau=args.tau, num_walks=args.walks,
                         rho=args.rho, device=device)

    speeds = parse_straggle(args.straggle, args.processes)
    cfg = AsyncBCDConfig(
        num_procs=args.processes, num_agents=args.agents,
        num_walks=args.walks, rounds=args.rounds,
        local_steps=args.local_steps,
        max_delay=None if args.max_delay < 0 else args.max_delay,
        adaptive=args.adaptive, speeds=tuple(speeds), rule=args.rule,
        walk_kind=args.walk_kind, min_update_s=args.min_update_ms * 1e-3,
        seed=args.seed, comm_timeout_s=float(args.timeout),
        mid_round=args.mid_round, measured_speeds=args.measured_speeds,
        rate_rounds=args.rate_rounds)

    worker = AsyncWorker(cfg, method, pid, kv)
    res = worker.run()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    summary = {
        "proc": pid, "digest": res.digest, "trace": res.trace,
        "agent_range": list(res.agent_range),
        "own_updates": res.own_updates,
        "applied_updates": res.applied_updates,
        "comm_posts": res.comm_posts, "comm_fetches": res.comm_fetches,
        "comm_events": res.comm_posts + res.comm_fetches,
        "gate_wait_s": round(res.gate_wait_s, 6),
        "wall_s": round(res.wall_s, 6),
        "max_staleness": res.max_staleness,
        "speed": speeds[pid],
        "local_steps": worker.my_events[0].num_updates,
        "mid_round_ingested": res.mid_round_ingested,
        "ingest_wait_s": round(res.ingest_wait_s, 6),
        "max_view_lag": res.max_view_lag,
        "update_ema_s": round(res.update_ema_s, 6),
        "speed_buckets": res.speed_buckets,
        "rate_syncs": res.rate_syncs,
        "num_epochs": res.num_epochs,
        "device": str(device),
        "peak_bytes": peak,
    }
    print(f"[proc {pid}] {res.own_updates} updates on {device}, "
          f"update EMA {res.update_ema_s * 1e3:.3f} ms, "
          f"peak {peak} B", flush=True)
    kv.set(f"result/{pid}", encode(summary))
    kv.barrier("async-bcd-results", args.processes, pid,
               float(args.timeout))

    if pid == 0:
        procs = [decode(kv.get(f"result/{q}", float(args.timeout)))
                 for q in range(args.processes)]
        final_obj = procs[0]["trace"][-1]["objective"] \
            if procs[0]["trace"] else None
        if args.max_delay == 0 and args.local_steps == 1 \
                and not args.mid_round:
            mode = "lockstep"
        elif args.mid_round:
            mode = "async+mid"
        else:
            mode = "async"
        payload = {
            "mode": mode,
            "transport": args.transport,
            "device": str(device),
            "num_processes": args.processes,
            "config": {
                "dataset": args.dataset, "subsample": args.subsample,
                "agents": args.agents, "walks": args.walks,
                "method": args.method, "rule": args.rule,
                "tau": args.tau, "rho": args.rho,
                "rounds": args.rounds, "local_steps": args.local_steps,
                "max_delay": args.max_delay, "adaptive": args.adaptive,
                "straggle": args.straggle,
                "min_update_ms": args.min_update_ms,
                "walk_kind": args.walk_kind, "seed": args.seed,
                "mid_round": args.mid_round,
                "measured_speeds": args.measured_speeds,
                "rate_rounds": args.rate_rounds,
            },
            "digest": res.digest,
            "wall_s": round(max(p["wall_s"] for p in procs), 6),
            "total_updates": procs[0]["applied_updates"],
            "total_comm_events": sum(p["comm_events"] for p in procs),
            "max_staleness": max(p["max_staleness"] for p in procs),
            "max_view_lag": max(p["max_view_lag"] for p in procs),
            "mid_round_ingested": sum(
                p["mid_round_ingested"] for p in procs),
            "final_objective": final_obj,
            "processes": procs,
        }
        if args.out:
            with open(args.out, "w") as f:
                json.dump(payload, f, indent=1)
            print(f"[proc {pid}] wrote {args.out}", flush=True)
        print(f"[proc {pid}] {payload['mode']}: "
              f"{payload['total_updates']} updates, "
              f"{payload['total_comm_events']} comm events, "
              f"wall {payload['wall_s']:.2f}s, "
              f"final objective {final_obj:.6f}, "
              f"max staleness {payload['max_staleness']}", flush=True)
    # hold every process until output is written, so no child tears the
    # store down while a peer still reads from it
    kv.barrier("async-bcd-done", args.processes, pid, float(args.timeout))
    if args.transport == "tcp":
        kv.close()     # the master waits here until every peer has left

    # the parent asserts these digests agree across all processes
    print(f"ASYNC_BCD_OK process={pid} digest={res.digest}", flush=True)
    return 0


def run_parent(args, argv) -> int:
    extra = ["--device", args.device]
    if args.transport == "tcp":
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        extra += ["--coordinator", f"localhost:{port}"]
        cleanup = None
    else:
        import tempfile
        kv_dir = tempfile.mkdtemp(prefix="async_bcd_kv_")
        extra += ["--kv-dir", kv_dir]
        cleanup = kv_dir
    procs = []
    for i in range(args.processes):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train_async", *argv,
             "--process-id", str(i), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        # checked while the children start (each checks it too), so the
        # parent's torch import overlaps theirs: without a card and
        # without --device cpu the parent raises
        from repro_torch.utils.device import resolve_device

        resolve_device(args.device)
    except (RuntimeError, ValueError):
        for p in procs:
            p.kill()
            p.wait()
        if cleanup:
            import shutil

            shutil.rmtree(cleanup, ignore_errors=True)
        raise
    outs, rcs = [], []
    deadline = time.monotonic() + args.timeout
    for i, p in enumerate(procs):
        try:
            out, _ = p.communicate(
                timeout=max(1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += "\n[parent] TIMEOUT"
        outs.append(out)
        rcs.append(p.returncode)
        for line in out.splitlines():
            print(f"  p{i}| {line}")
    if cleanup:
        import shutil

        shutil.rmtree(cleanup, ignore_errors=True)
    digests = []
    for out in outs:
        digests += [ln.split("digest=")[1] for ln in out.splitlines()
                    if ln.startswith("ASYNC_BCD_OK")]
    ok = (all(rc == 0 for rc in rcs)
          and len(digests) == args.processes
          and len(set(digests)) == 1)
    if ok:
        print(f"[parent] {args.processes} processes agree "
              f"(digest {digests[0]})")
        return 0
    print(f"[parent] FAILED: rcs={rcs} digests={digests}")
    return 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = _build_parser().parse_args(argv)
    if args.process_id is not None:
        sys.exit(run_child(args))
    sys.exit(run_parent(args, argv))


if __name__ == "__main__":
    main()
