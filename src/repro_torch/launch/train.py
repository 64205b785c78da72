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
"""
from __future__ import annotations

import argparse
import time

from repro_torch.utils.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-feasible)")
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
    return ap.parse_args(argv)


def train(args):
    """Run args.steps supersteps (or DP baseline steps with
    args.baseline). Returns {"losses", "auxs" (the MoE load-balance term
    of each loss, 0 without MoE layers), "step_ms", "peak_bytes",
    "device"}; peak_bytes is None on the CPU."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config, get_smoke
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

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
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


def main(argv=None):
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
