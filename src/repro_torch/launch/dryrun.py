"""One-card dry run: count every (arch x input shape) step on fake tensors
and read its roofline terms against one H100 (the port of
`repro/launch/dryrun.py`, its one-card part).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
        --shape train_4k [--baseline-dp] [--out result.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --out-dir results/dryrun_torch

Where the reference lowers and compiles each step for a 256- or
512-device mesh and reads its HLO, this builds the parameters, the
API-BCD state (`get_train(arch)`, or the DP baseline with adamw), the
batch (`input_specs`) and the caches (`cache_specs`) as fake tensors
(`torch._subclasses.fake_tensor`: shapes and dtypes, nothing allocated,
no device touched) and runs one superstep, DP step, prefill or decode
step under `utils.roofline.StepCost`. The count is the one the same step
gives on the card or the CPU (`step_inputs(..., device=...)` and
`run_step` run it there). A decode step counts its caches filled to
their capacity (seq_len, or the window).

An API-BCD superstep counts one agent's gradient A times (every agent's
gradient has the same shapes) and runs the rest of the step (the
accumulation, the update of every leaf and agent, the token moves) in
full, with a stand-in loss whose gradient moves no byte and does no
product; `tests/test_torch_roofline.py` and `chip_smoke.py` phase 48
hold that count equal to the whole step's.

The JSON keeps the reference's keys where they apply (arch, shape, mode,
window, params, active_params, model_flops, roofline, useful_flop_ratio)
and adds memory_analysis (argument and output bytes; temporaries are not
measured) and fits_one_card (the arguments within 80 GB). The mesh and the second
pod are still to come; a run across processes reckons its collective
bytes from the leaf shapes (`dist.trainer.mesh_collective_bytes`, which
`launch.train --processes` passes to `Roofline`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 get_train)
from repro_torch.configs.base import ArchConfig, ShapeConfig, TrainConfig
from repro_torch.dist.trainer import (_grad, init_train_state,
                                      make_dp_baseline_step, make_train_step)
from repro_torch.models import build_model
from repro_torch.models.model import cache_specs, input_specs
from repro_torch.optim import adamw, constant
from repro_torch.utils.roofline import (CARD, HBM_BYTES, StepCost,
                                        active_params, count_params,
                                        model_flops, tree_bytes)


def _expert_param_count(params):
    """Elements of the leaves under a "moe" key with 3 or more dims (the
    reference's rule, router and shared experts included)."""
    return sum(int(t.numel()) for name, t in params.items()
               if "moe" in name.split(".") and t.dim() >= 3)


def _skip(cfg, shape):
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("SKIP: enc-dec decoder (whisper) has no 500k decode use "
                "(trained context << 500k); see DESIGN.md")
    return None


@dataclasses.dataclass
class Combo:
    """One (arch, shape, mode): the config, the model (with the long-
    context window where the shape asks for one) and, for training, the
    API-BCD TrainConfig."""
    name: str
    cfg: ArchConfig
    shape: ShapeConfig
    baseline_dp: bool
    tcfg: TrainConfig
    window: int
    model: object

    @property
    def mode(self):
        return "baseline_dp" if self.baseline_dp else "apibcd"


def make_combo(arch, shape, baseline_dp=False, train=None) -> Combo:
    """arch: a registered name or an ArchConfig; shape: a name of
    INPUT_SHAPES or a ShapeConfig; train: the TrainConfig (default
    `get_train(arch)`)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    name = cfg.name if isinstance(arch, ArchConfig) else arch
    shape = shape if isinstance(shape, ShapeConfig) else INPUT_SHAPES[shape]
    # long-context decode on full-attention archs -> sliding-window variant
    window = 0
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        window = cfg.long_context_window
    if train is None:
        train = TrainConfig() if isinstance(arch, ArchConfig) \
            else get_train(arch)
    return Combo(name, cfg, shape, baseline_dp, train, window,
                 build_model(cfg, window=window))


def _draw(spec, cfg, device, generator):
    """A real tensor of the spec's shape and dtype: token ids below the
    vocabulary, normal floats otherwise."""
    if spec.dtype == torch.int32:
        return torch.randint(0, cfg.vocab_size, tuple(spec.shape),
                             generator=generator, device=device,
                             dtype=torch.int32)
    return torch.randn(tuple(spec.shape), generator=generator,
                       device=device).to(spec.dtype)


def step_inputs(combo: Combo, device=None, generator=None):
    """The step's arguments: fake tensors (device None; call inside a
    FakeTensorMode) or real ones on `device`, drawn from `generator`
    (parameters from `model.init`, ids and floats at random, decode
    caches zero with every row at its capacity). {"state" | "params"
    [, "opt_state"], "batch", "caches", "position"} as the mode needs."""
    cfg, shape, model = combo.cfg, combo.shape, combo.model
    fake = device is None
    gen = torch.Generator() if fake else generator
    batch = input_specs(cfg, shape, combo.window)
    if not fake:
        batch = {k: _draw(v, cfg, device, gen) for k, v in batch.items()}
    if shape.kind == "train" and not combo.baseline_dp:
        a = combo.tcfg.num_agents
        if shape.global_batch % a:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {a} agents")
        batch = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        return {"state": init_train_state(model, combo.tcfg, gen),
                "batch": batch}
    params = model.init(gen)
    if shape.kind == "train":
        opt = adamw(weight_decay=0.0)
        return {"params": params, "opt_state": opt.init(params),
                "batch": batch}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch}
    position = shape.seq_len - 1
    if fake:
        caches = cache_specs(cfg, shape, combo.window)
    else:
        caches = model.init_cache(shape.global_batch, shape.seq_len,
                                  device=device)
        for seg in (caches if isinstance(caches, list) else [caches]):
            if "ptr" in seg:            # every row holds seq_len tokens
                seg["ptr"].fill_(position)
    return {"params": params, "batch": batch, "caches": caches,
            "position": position}


def run_step(combo: Combo, inputs, model=None):
    """One superstep, DP step, prefill or decode step on `inputs` (from
    `step_inputs`), as the dry run counts it. Returns the step's
    outputs."""
    model = model or combo.model
    kind = combo.shape.kind
    if kind == "train" and combo.baseline_dp:
        step = make_dp_baseline_step(model, adamw(weight_decay=0.0),
                                     constant(3e-4))
        return step(inputs["params"], inputs["opt_state"], inputs["batch"],
                    0)
    if kind == "train":
        return make_train_step(model, combo.tcfg)(inputs["state"],
                                                  inputs["batch"], 0)
    if kind == "prefill":
        return model.prefill(inputs["params"], inputs["batch"])
    return model.decode_step(inputs["params"], inputs["batch"]["token"],
                             inputs["caches"], inputs["position"])


def _free_loss(params, batch, **kw):
    """A stand-in loss of the parameters that counts nothing: a reduction
    and elementwise ops, whose gradient is a broadcast of each leaf's
    shape and dtype, as a real gradient's."""
    del batch, kw
    loss = sum(v.sum() * 0.0 for v in params.values())
    return loss, {"nll": loss, "aux": loss * 0.0}


def count_step(combo: Combo, inputs):
    """(StepCost, outputs) of one step. An API-BCD superstep counts one
    agent's gradient A times and the rest of the step in full (see the
    module's docstring)."""
    if combo.shape.kind != "train" or combo.baseline_dp:
        with StepCost() as cost:
            out = run_step(combo, inputs)
        return cost, out
    state, batch = inputs["state"], inputs["batch"]
    with StepCost() as one:
        _grad(combo.model, {k: v[0] for k, v in state["params"].items()},
              {k: v[0] for k, v in batch.items()})
    stand_in = dataclasses.replace(combo.model, train_loss=_free_loss)
    with StepCost() as cost:
        out = run_step(combo, inputs, model=stand_in)
    cost.add(one, times=combo.tcfg.num_agents)
    return cost, out


def lower_combo(arch, shape, baseline_dp=False, train=None, verbose=True):
    """Count one step of `arch` at `shape` on fake tensors. Returns the
    dry run's JSON record (a "skipped" one where the reference skips)."""
    combo = make_combo(arch, shape, baseline_dp, train)
    shape = combo.shape
    reason = _skip(combo.cfg, shape)
    if reason:
        return {"arch": combo.name, "shape": shape.name, "skipped": reason}
    t0 = time.monotonic()
    with FakeTensorMode():
        inputs = step_inputs(combo)
        cost, out = count_step(combo, inputs)
        args_bytes = tree_bytes(inputs)
        out_bytes = tree_bytes(out)
        if "state" in inputs:
            a = combo.tcfg.num_agents
            n_params = count_params(inputs["state"]["params"]) // a
            n_expert = _expert_param_count(inputs["state"]["params"]) // a
        else:
            n_params = count_params(inputs["params"])
            n_expert = _expert_param_count(inputs["params"])
    count_s = time.monotonic() - t0

    act = active_params(combo.cfg, n_params, n_expert)
    mflops = model_flops(combo.cfg, shape, n_params, act)
    rl = cost.roofline()
    result = {
        "arch": combo.name,
        "shape": shape.name,
        "shape_config": dataclasses.asdict(shape),
        "mode": combo.mode,
        "agents": (combo.tcfg.num_agents
                   if shape.kind == "train" and not baseline_dp else None),
        "window": combo.window,
        "counted_on": "fake tensors (no allocation, no device)",
        "count_s": round(count_s, 1),
        "params": int(n_params),
        "active_params": int(act),
        "model_flops": mflops,
        "roofline": rl.as_dict(),
        "bound_s": rl.bound_s,
        "useful_flop_ratio": (mflops / rl.flops) if rl.flops else None,
        "step_cost": cost.as_dict(),
        "memory_analysis": {"argument_size_in_bytes": args_bytes,
                            "output_size_in_bytes": out_bytes,
                            "temp_size_in_bytes": "not measured"},
        "fits_one_card": args_bytes <= HBM_BYTES,
    }
    if verbose:
        print(f"[{combo.name} x {shape.name} x 1 card] counted on fake "
              f"tensors in {count_s:.1f}s  flops {rl.flops:.3e}  hbm "
              f"{rl.hbm_bytes:.3e}  bound {rl.bound_s * 1e3:.3f} ms "
              f"dominant={rl.dominant}  (peaks of the {CARD})")
        print("memory_analysis:", result["memory_analysis"],
              "fits_one_card:", result["fits_one_card"])
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help=f"one of {list(ARCH_IDS)}, or all")
    ap.add_argument("--shape", required=True,
                    choices=list(INPUT_SHAPES) + ["all"])
    ap.add_argument("--baseline-dp", action="store_true",
                    help="count the synchronous all-reduce DP baseline "
                         "instead of the API-BCD step")
    ap.add_argument("--out", default=None, help="one combination's JSON")
    ap.add_argument("--out-dir", default=None,
                    help="write <arch>__<shape>.json a combination here")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    results = []
    for arch in archs:
        for shape in shapes:
            res = lower_combo(arch, shape, baseline_dp=args.baseline_dp)
            results.append(res)
            if args.out_dir:
                os.makedirs(args.out_dir, exist_ok=True)
                suffix = "__dp" if args.baseline_dp else ""
                path = os.path.join(args.out_dir,
                                    f"{arch}__{shape}{suffix}.json")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results[0] if len(results) == 1 else results, f,
                      indent=1)
    elif not args.out_dir:
        print(json.dumps(results[0] if len(results) == 1 else results,
                         indent=1))
    return results


if __name__ == "__main__":
    main()
