"""Continuous-batching serving example (`repro_torch.serve.Engine`; the
port of `examples/serve_batched.py`).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        --arch qwen2-0.5b [--device cpu]

Submits a mixed workload (short and long generation budgets) to the
slot-arena engine: requests are admitted into freed slots between decode
steps, so short requests finish and leave while long ones keep decoding
— no wave convoy. Uses the reduced smoke config. Runs on the card unless
`--device cpu` is given, and raises when there is no card to run on.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import build_model
from repro_torch.serve import Engine, bucket_length
from repro_torch.utils.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-batch", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns {"budgets": per request, "outputs": {uid: tokens},
    "steps": engine steps, "tokens_per_s"}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)

    eng = Engine(model, params, max_batch=args.max_batch,
                 max_len=bucket_length(args.prompt_len + args.new_tokens))
    budgets = [max(1, args.new_tokens // 4) if i % 2 else args.new_tokens
               for i in range(args.requests)]
    t0 = time.monotonic()
    uids = [eng.submit(rng.integers(0, cfg.vocab_size, (args.prompt_len,)),
                       max_new_tokens=b) for b in budgets]

    steps = 0
    while eng.pending or eng.num_active:
        for r in eng.step():
            more = "..." if len(r.output) > 8 else ""
            print(f"  [{time.monotonic() - t0:6.3f}s, step {steps:3d}] "
                  f"uid {r.uid} done: {len(r.output)} tokens "
                  f"-> {r.output[:8].tolist()}{more}")
        steps += 1
    dt = time.monotonic() - t0
    done = eng.run()
    toks = sum(len(r.output) for r in done)
    print(f"[{cfg.name}] {len(uids)} requests, {toks} tokens in {dt:.3f}s "
          f"({toks / dt:.1f} tok/s, {steps} engine steps, {device})")
    return {"budgets": budgets, "steps": steps, "tokens_per_s": toks / dt,
            "outputs": {r.uid: r.output.tolist() for r in done}}


if __name__ == "__main__":
    main()
