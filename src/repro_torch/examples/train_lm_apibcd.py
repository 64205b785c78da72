"""End-to-end example: decentralized LM training with API-BCD on one device
(the port of `examples/train_lm_apibcd.py`).

Presets:
  tiny  (default) — ~2.9M-param qwen2-family model, 60 steps, runs on
                    the CPU in seconds.
  paper           — ~100M-param model, 300 steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_apibcd
    PYTHONPATH=src python -m repro_torch.examples.train_lm_apibcd \
        --preset paper
    PYTHONPATH=src python -m repro_torch.examples.train_lm_apibcd \
        --steps 12 --device cpu

A = 4 agents and M = 2 walks (tau 0.05, rho 20) train one model each on
its own token stream (`data.tokens.agent_batches`); the reference lays
them on a mesh of 8 host devices, the port runs them in one process.
`--baseline` also runs the synchronous all-reduce DP baseline (adamw, a
constant rate of 3e-4) on the same batches. Runs on the card unless
`--device cpu` is given, and raises when there is no card to run on.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, TrainConfig
from repro_torch.data.tokens import agent_batches
from repro_torch.dist.trainer import (init_train_state,
                                      make_dp_baseline_step, make_train_step)
from repro_torch.models import build_model
from repro_torch.optim import adamw, constant
from repro_torch.utils.device import resolve_device

PRESETS = {
    "tiny": dict(cfg=ArchConfig(
        name="lm-tiny", family="dense", source="examples", num_layers=4,
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
        vocab_size=2048, tie_embeddings=True), steps=60, seq=128, bpa=4),
    "paper": dict(cfg=ArchConfig(
        name="lm-100m", family="dense", source="examples", num_layers=12,
        d_model=768, num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32768, tie_embeddings=True), steps=300, seq=512, bpa=8),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=0,
                    help="supersteps (0: the preset's)")
    ap.add_argument("--baseline", action="store_true",
                    help="also run the synchronous all-reduce DP baseline")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _batch(toks, targs, device):
    return {"tokens": torch.from_numpy(toks).to(device),
            "targets": torch.from_numpy(targs).to(device)}


def main(argv=None):
    """Returns {"losses": API-BCD's, "improved": bool, "baseline_losses":
    the DP baseline's or None}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # f32 products in full f32, as the reference computes them
        torch.backends.cuda.matmul.allow_tf32 = False
    preset = PRESETS[args.preset]
    cfg, seq, bpa = preset["cfg"], preset["seq"], preset["bpa"]
    steps = args.steps or preset["steps"]

    model = build_model(cfg)
    a = 4
    tcfg = TrainConfig(num_agents=a, num_walks=2, tau=0.05, rho=20.0)
    print(f"API-BCD: {cfg.name}, agents={a}, walks={tcfg.num_walks}, "
          f"steps={steps}, device={device}")

    state = init_train_state(model, tcfg,
                             torch.Generator(device=device).manual_seed(0))
    step_fn = make_train_step(model, tcfg)
    batches = agent_batches(cfg.vocab_size, a, bpa, seq, seed=0)

    losses = []
    for step in range(steps):
        toks, targs = next(batches)
        state, metrics = step_fn(state, _batch(toks, targs, device), step)
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == steps - 1:
            print(f"step {step:4d}  loss {losses[-1]:.4f}")

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    improved = bool(last < first)
    print(f"\nloss: first-10 avg {first:.4f} -> last-10 avg {last:.4f} "
          f"({'improved' if improved else 'NOT improved'})")

    baseline_losses = None
    if args.baseline:
        print("\nall-reduce DP baseline:")
        opt = adamw(weight_decay=0.0)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        opt_state = opt.init(params)
        bstep = make_dp_baseline_step(model, opt, constant(3e-4))
        batches = agent_batches(cfg.vocab_size, a, bpa, seq, seed=0)
        baseline_losses = []
        for step in range(steps):
            toks, targs = next(batches)
            params, opt_state, metrics = bstep(
                params, opt_state,
                _batch(toks.reshape(-1, seq), targs.reshape(-1, seq),
                       device), step)
            baseline_losses.append(float(metrics["loss"]))
            if step % 10 == 0 or step == steps - 1:
                print(f"step {step:4d}  loss {baseline_losses[-1]:.4f}")
    return {"losses": losses, "improved": improved,
            "baseline_losses": baseline_losses}


if __name__ == "__main__":
    main()
