"""One rank of the port's mesh-trainer checks (run by
tests/test_torch_mesh_trainer.py as 4 processes over gloo on the CPU).

    python tests/torch_mesh_script.py --rank R --world 4 \
        --coordinator localhost:PORT --init p0.pt --out DIR

Every rank runs the same scenarios in order, each on a mesh of its own
over the one process group, and writes what it holds to
DIR/<scenario>.rank<R>.pt: its part of the final state, the state after
every superstep where the scenario keeps it, each step's metrics and the
bytes it sent by kind. The test process joins the parts and holds them
against the reference. A scenario's name gives its mesh: agents x
replica, then x model parallel where the model axis is above 1.
"""
import argparse
import dataclasses
import os
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist.collectives import Collectives  # noqa: E402
from repro_torch.dist.trainer import (  # noqa: E402
    init_mesh_train_state, make_mesh_dp_baseline_step, make_mesh_train_step)
from repro_torch.dist.tensor_parallel import shard_params  # noqa: E402
from repro_torch.launch.mesh import (init_distributed,  # noqa: E402
                                     make_training_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import constant, sgd  # noqa: E402

SEQ, ROWS = 16, 2               # tokens and rows an agent
QUAD_P, QUAD_ROWS = 8, 16       # the quadratic model's width and rows
QUAD_TAU, QUAD_RHO = 0.3, 2.0

# name: (model, agents, replica, walks, accumulate, steps, keep every step)
SCENARIOS = {
    "lm_4x1_acc": ("lm", 4, 1, 2, True, 4, False),
    "lm_4x1_paper": ("lm", 4, 1, 2, False, 4, True),
    "lm_2x2_acc": ("lm", 2, 2, 1, True, 4, False),
    "lm_2x2_paper": ("lm", 2, 2, 1, False, 4, True),
    "lm_2x2_mask": ("lm", 2, 2, 1, True, 2, False),
    "quad_4x1_paper": ("quad", 4, 1, 2, False, 12, False),
    "quad_2x2_acc": ("quad", 2, 2, 1, True, 6, False),
    # tensor parallelism over "model" (MODEL_PARALLEL), alone and with
    # replicas
    "lm_2x1x2_acc": ("lm", 2, 1, 1, True, 4, False),
    "lm_2x1x2_paper": ("lm", 2, 1, 1, False, 4, True),
    "lm_1x2x2_acc": ("lm", 1, 2, 1, True, 3, False),
}
# the model axis of each scenario (1 where it is not named)
MODEL_PARALLEL = {"lm_2x1x2_acc": 2, "lm_2x1x2_paper": 2, "lm_1x2x2_acc": 2}
DP_STEPS = 3
# the DP baseline's meshes: (agents, replica, model parallel)
DP_MESHES = {"dp": (4, 1, 1), "dp_2x1x2": (2, 1, 2)}


class QuadModel:
    """Quadratic "LM": loss_i(w) = 0.5 mean (A_i w - b_i)^2."""

    def init(self, generator):
        return {"w": torch.zeros((QUAD_P,), dtype=torch.float32,
                                 device=generator.device)}

    def train_loss(self, params, batch):
        r = batch["a"] @ params["w"] - batch["b"]
        loss = 0.5 * torch.mean(r * r)
        return loss, {"nll": loss, "aux": torch.zeros(())}


def quad_data(agents):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((agents, QUAD_ROWS, QUAD_P)).astype(
        np.float32),
            rng.standard_normal((agents, QUAD_ROWS)).astype(np.float32))


def uneven_mask(agents, rows, seq):
    """A loss mask whose rows keep very different counts of tokens (row 0
    of agent i keeps 2 + i, row 1 keeps seq - 1 - i)."""
    mask = np.zeros((agents, rows, seq), np.float32)
    for i in range(agents):
        mask[i, 0, :2 + i] = 1.0
        mask[i, 1:, :seq - 1 - i] = 1.0
    return mask


def lm_model(p0):
    """The smoke qwen2 in f32, starting from the test's init `p0`."""
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"),
                              compute_dtype="float32")
    model = build_model(cfg)
    return types.SimpleNamespace(
        cfg=cfg, train_loss=model.train_loss,
        init=lambda generator: {k: v.clone() for k, v in p0.items()})


def run_scenario(name, p0, out):
    kind, a, r, m, accumulate, steps, keep = SCENARIOS[name]
    mesh = make_training_mesh(a, r, MODEL_PARALLEL.get(name, 1))
    comm = Collectives(mesh, "cpu")
    if kind == "lm":
        model = lm_model(p0)
        tcfg = TrainConfig(num_agents=a, num_walks=m,
                           accumulate_between_visits=accumulate)
        stream = agent_batches(model.cfg.vocab_size, a, ROWS, SEQ, seed=0)
    else:
        model = QuadModel()
        tcfg = TrainConfig(num_agents=a, num_walks=m, tau=QUAD_TAU,
                           rho=QUAD_RHO, accumulate_between_visits=accumulate)
        a_data, b_data = quad_data(a)
    state = init_mesh_train_state(model, tcfg, mesh, torch.Generator())
    step_fn = make_mesh_train_step(model, tcfg, mesh, comm)
    record = {"coords": mesh.coords, "metrics": [], "sent": [],
              "states": []}
    for step in range(steps):
        if kind == "lm":
            toks, targs = next(stream)
            batch = {"tokens": torch.from_numpy(toks),
                     "targets": torch.from_numpy(targs)}
            if name.endswith("_mask"):
                batch["loss_mask"] = torch.from_numpy(
                    uneven_mask(a, ROWS, SEQ))
        else:
            batch = {"a": torch.from_numpy(a_data),
                     "b": torch.from_numpy(b_data)}
        comm.reset()
        state, metrics = step_fn(state, batch, step)
        record["metrics"].append({k: float(v) for k, v in metrics.items()})
        record["sent"].append(dict(comm.sent))
        if keep:
            record["states"].append({p: {k: v.clone() for k, v in
                                         state[p].items()}
                                     for p in ("params", "token")})
    record["state"] = state
    torch.save(record, os.path.join(out, f"{name}.rank{mesh.rank}.pt"))


def run_dp(name, p0, out):
    """The DP baseline over the 4 ranks of DP_MESHES[name] (sgd with
    momentum), on the global batch [A * B, S] with an uneven loss mask;
    each rank holds its tensor-parallel piece of the params."""
    mesh = make_training_mesh(*DP_MESHES[name])
    comm = Collectives(mesh, "cpu")
    model = lm_model(p0)
    opt = sgd(0.9)
    params = shard_params(model.cfg, model.init(None), mesh)
    opt_state = opt.init(params)
    step_fn = make_mesh_dp_baseline_step(model, opt, constant(0.05), mesh,
                                         comm)
    stream = agent_batches(model.cfg.vocab_size, 4, ROWS, SEQ, seed=0)
    mask = torch.from_numpy(uneven_mask(4, ROWS, SEQ).reshape(-1, SEQ))
    metrics = []
    for step in range(DP_STEPS):
        toks, targs = next(stream)
        batch = {"tokens": torch.from_numpy(toks.reshape(-1, SEQ)),
                 "targets": torch.from_numpy(targs.reshape(-1, SEQ)),
                 "loss_mask": mask}
        comm.reset()
        params, opt_state, met = step_fn(params, opt_state, batch, step)
        metrics.append({k: float(v) for k, v in met.items()})
    torch.save({"coords": mesh.coords, "params": params,
                "opt_state": opt_state, "metrics": metrics,
                "sent": dict(comm.sent)},
               os.path.join(out, f"{name}.rank{mesh.rank}.pt"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    init_distributed(args.rank, args.world, args.coordinator, "gloo", "cpu",
                     timeout_s=300.0)
    p0 = torch.load(args.init)
    for name in SCENARIOS:
        run_scenario(name, p0, args.out)
    for name in DP_MESHES:
        run_dp(name, p0, args.out)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print("MESH_SCRIPT_OK", flush=True)


if __name__ == "__main__":
    main()
