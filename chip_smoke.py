#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; none catches its own failure, so any failure exits
non-zero before the last line:

  1. card: the `nvidia-smi` name and power limit;
  2. build: every CUDA kernel of the main path, compiled from the sources
     in this checkout (the old library is removed first);
  3. kernels: each kernel against its plain PyTorch version at the main
     path's shapes, with timings and the card's lower bound;
  4. main path: `repro_torch.launch.train` at full qwen2-0.5b width,
     A=4 agents, M=2 walks, 3 supersteps, with the kernel launch counts
     reset just before and read just after;
  5. reference: the smoke config in f32 for 2 supersteps on the card and
     on the CPU (plain versions) from one state, which must agree;
  6. profile: 2 more supersteps under torch.profiler, device time by
     kernel and the device's busy share.

Then it prints the `kernels` JSON line and, last, the `ok` JSON line.
With no GPU, or without the rest of the repo beside it, it exits
non-zero and prints no result.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script runs on the card only")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist.trainer import init_train_state, make_train_step  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels.prox_update import prox_update_cuda  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 peak outside the tensor cores
KW = dict(tau=0.05, rho=20.0, num_walks=2, num_agents=4)   # the CLI's
STEPS = 3
# qwen2-0.5b leaves: embed.table, final_norm.scale and 12 stacked-layer
# leaves (ln1, wq, wk, wv, wo, bq, bk, bv, ln2, w_gate, w_up, w_down)
LEAVES = 14


def main_args(steps, log_every):
    return ["--arch", "qwen2-0.5b", "--agents", "4", "--walks", "2",
            "--steps", str(steps), "--batch-per-agent", "2", "--seq", "256",
            "--log-every", str(log_every)]


DEV = torch.device("cuda")


def phase(name):
    print(f"== {name}", flush=True)


def event_ms(fn, iters):
    """Mean device ms of fn() over iters launches, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp(v):
    """Spacing of bf16 values at |v|: 2^(e-8) for |v| = m * 2^e, m in [.5, 1)."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def check_prox_case(label, shape, dtype, gen):
    x = torch.randn(shape, generator=gen, device=DEV).to(dtype)
    g = torch.randn(shape, generator=gen, device=DEV)
    z = torch.randn(shape, generator=gen, device=DEV)
    xn, d = ops.prox_update(x, g, z, **KW)
    torch.cuda.synchronize()
    rxn, rd = ref.prox_update(x, g, z, **KW)
    err_x = (xn.float() - rxn.float()).abs()
    err_d = float((d - rd).abs().max())
    if dtype == torch.float32:
        tol = 1e-6 * float(rxn.abs().max())
        ok = float(err_x.max()) <= tol and err_d <= 1e-6 * float(rd.abs().max())
        rule = "max_abs_err <= 1e-6 * max|x_new| (x_new and delta)"
    else:
        ok = bool((err_x <= bf16_ulp(rxn)).all()) and \
            err_d <= 1e-6 * float(rd.abs().max())
        rule = "|x_new - plain| <= 1 bf16 ulp; delta <= 1e-6 * max|delta|"
    max_err = max(float(err_x.max()), err_d)
    del xn, d, rxn, rd, err_x
    kernel_ms = event_ms(lambda: ops.prox_update(x, g, z, **KW), 10)
    plain_ms = event_ms(lambda: ref.prox_update(x, g, z, **KW), 3)
    numel = x.numel()
    nbytes = numel * (2 * x.element_size() + 3 * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 7 * numel / F32_FLOPS_PER_S * 1e3
    case = {"case": label, "shape": list(shape), "dtype": str(dtype),
            "max_abs_err": max_err, "tolerance": rule,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "achieved_GBps": nbytes / kernel_ms / 1e6}
    print(json.dumps(case), flush=True)
    if not ok:
        raise AssertionError(f"prox_update kernel disagrees with its plain "
                             f"version on {label}: {case}")
    return case


def reference_check():
    """Smoke config in f32, 2 supersteps, card vs CPU from one state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"), compute_dtype="float32")
    model = build_model(cfg)
    tcfg = TrainConfig(num_agents=4, num_walks=2)
    cpu = init_train_state(model, tcfg, torch.Generator().manual_seed(0))
    gpu = {part: {k: v.to(DEV, copy=True) for k, v in leaves.items()}
           for part, leaves in cpu.items()}
    step_fn = make_train_step(model, tcfg)
    batches = agent_batches(cfg.vocab_size, 4, 2, 32, seed=1)
    worst = {}
    for step in range(2):
        toks, targs = next(batches)
        b_cpu = {"tokens": torch.from_numpy(toks),
                 "targets": torch.from_numpy(targs)}
        cpu, m_cpu = step_fn(cpu, b_cpu, step)
        gpu, m_gpu = step_fn(gpu, {k: v.to(DEV) for k, v in b_cpu.items()},
                             step)
        np.testing.assert_allclose(float(m_gpu["loss"]), float(m_cpu["loss"]),
                                   rtol=1e-4)
    for part in cpu:
        for k, v in cpu[part].items():
            err = float((gpu[part][k].cpu() - v).abs().max())
            worst[part] = max(worst.get(part, 0.0), err)
    print(json.dumps({"reference_max_abs_err": worst, "tolerance": 1e-4}),
          flush=True)
    # f32 sums run in another order on the card than on the CPU
    if max(worst.values()) > 1e-4:
        raise AssertionError(f"card and CPU disagree: {worst}")


def profile_supersteps():
    """Device time by kernel over 2 supersteps of the main path (state
    init included), the device's busy share of the steps' wall time, and
    the host's op calls and self time (the profiler inflates the latter)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = train_cli.parse_args(main_args(steps=2, log_every=0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = train_cli.train(args)
    events = prof.key_averages()
    # kernels and copies only: an aten op's row repeats its kernels' time
    rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key[:90])
                   for ev in events
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    device_ms = sum(ms for ms, _, _ in rows)
    if not device_ms:
        print("profile: no device time recorded (not measured)")
        return
    steps_ms = sum(out["step_ms"])
    host = sorted(((ev.self_cpu_time_total / 1e3, ev.count, ev.key[:60])
                   for ev in events
                   if ev.device_type == DeviceType.CPU), reverse=True)
    print(json.dumps({"profile_2_supersteps": {
        "steps_wall_ms": steps_ms, "device_ms_incl_init": device_ms,
        "device_busy_share": device_ms / steps_ms,
        "host_op_calls": sum(n for _, n, _ in host),
        "host_self_ms": sum(ms for ms, _, _ in host),
        "host_top": [{"ms": ms, "count": n, "name": name}
                     for ms, n, name in host[:8]],
        "prox_update_device_ms": sum(ms for ms, _, name in rows
                                     if "prox" in name),
        "top": [{"ms": ms, "count": n, "name": name}
                for ms, n, name in rows[:15]]}}), flush=True)


def main():
    phase("1 card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    phase("2 build")
    build.library_path("prox_update").unlink(missing_ok=True)
    t0 = time.perf_counter()
    logs = build.build("prox_update")
    print(f"build_s {time.perf_counter() - t0:.3f}")
    for line in logs["prox_update"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())

    phase("3 kernels against their plain versions")
    gen = torch.Generator(device=DEV).manual_seed(0)
    cases = [check_prox_case(label, shape, dtype, gen) for label, shape, dtype
             in (("embed.table", (4, 151936, 896), torch.float32),
                 ("mlp.w_gate", (4, 24, 896, 4864), torch.float32),
                 ("mlp.w_gate bf16 x", (4, 24, 896, 4864), torch.bfloat16))]
    torch.cuda.empty_cache()

    phase("4 main path: repro_torch.launch.train, full qwen2-0.5b")
    argv = main_args(STEPS, log_every=1)
    print(" ".join(argv))
    prox_update_cuda.launches = 0
    out = train_cli.train(train_cli.parse_args(argv))
    launches = prox_update_cuda.launches
    print(json.dumps({"main_path": {**out, "prox_update_launches": launches,
                                    "peak_GB": out["peak_bytes"] / 1e9}}),
          flush=True)
    if not np.all(np.isfinite(out["losses"])):
        raise AssertionError(f"non-finite losses {out['losses']}")
    if launches != LEAVES * STEPS:
        raise AssertionError(f"prox_update launched {launches} times in "
                             f"{STEPS} supersteps, expected {LEAVES * STEPS}")
    torch.cuda.empty_cache()

    phase("5 reference: card against CPU at smoke size")
    reference_check()

    phase("6 profile")
    profile_supersteps()

    # top level: the largest leaf's f32 case (mlp.w_gate) for the times,
    # the worst case for the error; every case under "cases"
    rep = cases[1]
    print(json.dumps({"kernels": [{
        "name": "prox_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/prox_update.cu",
        "replaces": "src/repro/kernels/prox_update.py:35",
        "launches": launches, "shape": rep["shape"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": rep["kernel_ms"], "kernel_ms": rep["kernel_ms"],
        "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"], "library_ms": None,
        "cases": cases}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
