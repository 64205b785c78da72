"""`python -m repro_torch.launch.train --processes N` on the CPU (gloo):
the ranks' digests equal the one-process run's slices, a checkpoint
gathered to rank 0 loads in both packages, replica 2 and the DP baseline
over 2 processes, run at the config's bf16, equal the one-process steps
with the gradient split as the ranks split it (bitwise), and in f32 those
split steps stay within atol 1e-5 of the unsplit steps. At model parallel
2 (API-BCD and the DP baseline) the ranks keep the unsplit leaves bitwise
equal across each model line, and the checkpoint joins the pieces into
the one-process state's format."""
import dataclasses
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; the ranks run one thread
# each too, so products take the same path on both sides
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.checkpoint import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.dist import trainer as jax_trainer  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist import trainer as T  # noqa: E402
from repro_torch.dist.sharding import (local_shard,  # noqa: E402
                                       state_shardings)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import flatten  # noqa: E402
from repro_torch.optim import adamw, constant  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SMOKE = ["--arch", "qwen2-0.5b", "--smoke", "--steps", "3",
         "--batch-per-agent", "2", "--seq", "16", "--device", "cpu",
         "--backend", "gloo", "--log-every", "1"]


def _launch(*flags):
    """Run the launcher as a user would; (exit code, output, [each rank's
    MESH_RANK record])."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *SMOKE, *flags], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    import json

    ranks = [json.loads(line.split("MESH_RANK ", 1)[1])
             for line in res.stdout.splitlines() if "MESH_RANK " in line]
    return res.returncode, res.stdout + res.stderr, ranks


def _config(args, f32):
    """The launcher's config, with f32 products where `f32`."""
    cfg = train_cli._config(args)
    return dataclasses.replace(cfg, compute_dtype="float32") if f32 else cfg


def _one_process(agents, walks, f32=False):
    """The port's one-process run of the same flags (in f32 where `f32`):
    the final state."""
    args = train_cli.parse_args([*SMOKE, "--agents", str(agents), "--walks",
                                 str(walks)])
    cfg = _config(args, f32)
    model = build_model(cfg)
    tcfg = TrainConfig(num_agents=agents, num_walks=walks, tau=args.tau,
                       rho=args.rho)
    state = T.init_train_state(model, tcfg, torch.Generator().manual_seed(0))
    step_fn = T.make_train_step(model, tcfg)
    stream = agent_batches(cfg.vocab_size, agents, 2, 16, seed=0)
    for step in range(3):
        toks, targs = next(stream)
        state, _ = step_fn(state, {"tokens": torch.from_numpy(toks),
                                   "targets": torch.from_numpy(targs)}, step)
    return model, tcfg, state


def test_four_processes_print_the_one_process_digests(tmp_path):
    """--processes 4 (replica 1) exits 0; each rank prints, per part, the
    digest of its agent slot of the one-process state (bitwise equal),
    its superstep ms, hop ms and bytes sent; --checkpoint-dir writes the
    whole state, which both packages' readers load bitwise."""
    rc, out, ranks = _launch("--agents", "4", "--walks", "2",
                             "--processes", "4",
                             "--checkpoint-dir", str(tmp_path / "ck"))
    assert rc == 0, out
    assert "backend=gloo" in out and "hop_ms" in out
    assert len(ranks) == 4
    _, tcfg, want = _one_process(4, 2)
    for rec in ranks:
        agent = rec["coords"]["agent"]
        assert rec["digests"] == train_cli.part_digests(want, slot=agent)
        assert len(rec["step_ms"]) == len(rec["hop_ms"]) == 3
        assert all(s["ring_shift"] > 0 for s in rec["sent"])
    got, step = ckpt.load_checkpoint(str(tmp_path / "ck"), want)
    assert step == 3
    for part, leaves in want.items():
        for k, v in leaves.items():
            assert torch.equal(got[part][k], v), f"{part}/{k}"
    jcfg = jax_get_smoke("qwen2-0.5b")
    like = jax_trainer.init_train_state(
        jax_build_model(jcfg), JaxTrainConfig(num_agents=4, num_walks=2,
                                              model_parallel=1))
    jgot, _ = jax_ckpt.load_checkpoint(str(tmp_path / "ck"), like)
    for part, leaves in want.items():
        flat = flatten(jax.device_get(jgot[part]))
        for k, v in leaves.items():
            np.testing.assert_array_equal(flat[k], v.numpy(), err_msg=k)


def _split_grad(parts):
    """trainer._grad as a run across processes takes a gradient over
    `parts` ranks' rows: each part's rows apart, each gradient and each
    part's (loss, nll, aux) in f32 times its share of the rows, summed in
    the ranks' order (what the reduce-scatter and the all-reduce sum)."""
    plain = T._grad

    def grad(model, params, batch):
        rows = next(iter(batch.values())).shape[0]
        per = rows // parts
        total, vals = {}, None
        for j in range(parts):
            g, (loss, metr) = plain(model, params,
                                    {k: v[j * per:(j + 1) * per]
                                     for k, v in batch.items()})
            for k, gk in g.items():
                gk = gk.float() * (per / rows)
                if j:
                    total[k] += gk
                else:
                    total[k] = gk
            v = torch.stack([loss, metr["nll"], metr["aux"]]).float()
            v = v * (per / rows)
            vals = v if vals is None else vals + v
        return total, (vals[0], {"nll": vals[1], "aux": vals[2]})

    return grad


def test_replica_two_through_the_launcher():
    """--agents 2 over 4 processes (2 replicas an agent) at the config's
    bf16: each rank's digests equal its shard of the one-process step with
    each agent's gradient split over the replicas' rows (bitwise). In f32
    that split step stays within atol 1e-5 of make_train_step (in bf16 the
    products over 1 row and over 2 rows round apart)."""
    rc, out, ranks = _launch("--agents", "2", "--walks", "1",
                             "--processes", "4")
    assert rc == 0, out
    assert "replica=2" in out
    _, _, want = _one_process(2, 1, f32=True)
    with mock.patch.object(T, "_grad", _split_grad(2)):
        _, _, split = _one_process(2, 1, f32=True)
    worst = max(float((split[part][k] - v).abs().max())
                for part, leaves in want.items() for k, v in leaves.items())
    assert worst <= 1e-5, worst
    with mock.patch.object(T, "_grad", _split_grad(2)):
        model, tcfg, split = _one_process(2, 1)
    sizes = {"agent": 2, "replica": 2, "model": 1}
    specs = state_shardings(sizes, T._state_shapes(T._param_shapes(model),
                                                   tcfg))
    for rec in ranks:
        shard = {part: {k: local_shard(v, specs[part][k], sizes,
                                       rec["coords"])
                        for k, v in leaves.items()}
                 for part, leaves in split.items()}
        assert rec["digests"] == train_cli.part_digests(shard)
        assert rec["sent"][0]["all_gather"] > 0


def _one_process_dp(f32=False, grad=None):
    args = train_cli.parse_args([*SMOKE, "--agents", "2", "--baseline"])
    model = build_model(_config(args, f32))
    opt = adamw(weight_decay=0.0)
    params = model.init(torch.Generator().manual_seed(0))
    opt_state = opt.init(params)
    step_fn = T.make_dp_baseline_step(model, opt, constant(3e-4))
    stream = agent_batches(model.cfg.vocab_size, 2, 2, 16, seed=0)
    losses = []
    with mock.patch.object(T, "_grad", grad or T._grad):
        for step in range(3):
            toks, targs = next(stream)
            params, opt_state, met = step_fn(
                params, opt_state,
                {"tokens": torch.from_numpy(toks.reshape(-1, 16)),
                 "targets": torch.from_numpy(targs.reshape(-1, 16))}, step)
            losses.append(float(met["loss"]))
    return params, losses


def test_dp_baseline_over_two_processes():
    """--baseline --processes 2 at the config's bf16: the global batch
    [A * B, S] splits over the ranks and their gradients are all-reduced;
    both ranks print the params digest and the losses of the one-process
    DP step with the gradient split as the ranks split it (bitwise). In
    f32 adamw's 3 split steps stay within atol 1e-5 of the unsplit ones
    (losses within rtol 1e-5); in bf16 adam's first steps, about lr times
    the gradient's sign, turn the rows' other rounding into whole steps
    of lr, as tests/test_torch_train_paths.py notes against the
    reference."""
    rc, out, ranks = _launch("--agents", "2", "--processes", "2",
                             "--baseline")
    assert rc == 0, out
    want, losses = _one_process_dp(f32=True)
    split, split_losses = _one_process_dp(f32=True, grad=_split_grad(2))
    for k, v in want.items():
        np.testing.assert_allclose(split[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(split_losses, losses, rtol=1e-5)
    split, split_losses = _one_process_dp(grad=_split_grad(2))
    digest = train_cli.part_digests({"params": split})
    for rec in ranks:
        assert rec["digests"] == digest
        assert rec["losses"] == split_losses
        assert all(s["all_reduce"] > 0 for s in rec["sent"])


def test_model_parallel_two_through_the_launcher(tmp_path):
    """--agents 2 over 4 processes at --model-parallel 2 (the config's
    bf16): the ranks agree and the parent finds the leaves the model axis
    does not split bitwise equal across each model line; each rank's
    bytes are `superstep_sends`'s; --checkpoint-dir joins the pieces
    (`trainer.state_specs`) into the whole state in the reference's
    format, which loads into the one-process state of the same flags in
    both packages, cuts back into each rank's digests, and stays near the
    one-process run (bf16 sums in another order: losses within rtol
    2e-4, params within atol 2e-3, ~1.6e-4 apart here)."""
    rc, out, ranks = _launch("--agents", "2", "--walks", "1",
                             "--processes", "4", "--model-parallel", "2",
                             "--checkpoint-dir", str(tmp_path / "ck"))
    assert rc == 0, out
    assert "model=2" in out and "bitwise equal across each of the 2" in out
    model, tcfg, want = _one_process(2, 1)
    cfg = model.cfg
    sizes = {"agent": 2, "replica": 1, "model": 2}
    sends = T.superstep_sends(T._param_shapes(model), sizes, 2, cfg=cfg,
                              seq=16)
    got, step = ckpt.load_checkpoint(str(tmp_path / "ck"), want)
    assert step == 3
    specs = T.state_specs(model, tcfg, sizes)
    for rec in ranks:
        rank = rec["rank"]
        assert all(s == sends[rank] for s in rec["sent"]), rec["sent"]
        piece = {part: {k: local_shard(v, specs[part][k], sizes,
                                       rec["coords"])
                        for k, v in leaves.items()}
                 for part, leaves in got.items()}
        assert rec["digests"] == train_cli.part_digests(piece)
    for part, leaves in want.items():
        for k, v in leaves.items():
            assert got[part][k].shape == v.shape, f"{part}/{k}"
            assert got[part][k].dtype == v.dtype, f"{part}/{k}"
    jcfg = jax_get_smoke("qwen2-0.5b")
    like = jax_trainer.init_train_state(
        jax_build_model(jcfg), JaxTrainConfig(num_agents=2, num_walks=1,
                                              model_parallel=1))
    jgot, _ = jax_ckpt.load_checkpoint(str(tmp_path / "ck"), like)
    for part, leaves in got.items():
        flat = flatten(jax.device_get(jgot[part]))
        for k, v in leaves.items():
            np.testing.assert_array_equal(flat[k], v.numpy(), err_msg=k)
    losses = []
    stream = agent_batches(cfg.vocab_size, 2, 2, 16, seed=0)
    step_fn = T.make_train_step(model, tcfg)
    state = T.init_train_state(model, tcfg, torch.Generator().manual_seed(0))
    for i in range(3):
        toks, targs = next(stream)
        state, met = step_fn(state, {"tokens": torch.from_numpy(toks),
                                     "targets": torch.from_numpy(targs)}, i)
        losses.append(float(met["loss"]))
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=2e-4)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   rtol=0, atol=2e-3, err_msg=k)


def test_dp_baseline_on_the_model_axis_through_the_launcher():
    """--baseline over 4 processes at --model-parallel 2: the global batch
    splits over the 2 data-parallel ranks, each model line holds its
    pieces; the ranks agree on the losses and the parent finds the leaves
    the axis does not split bitwise equal across each model line; the
    ranks of one model coordinate hold bitwise-equal pieces."""
    rc, out, ranks = _launch("--agents", "2", "--processes", "4",
                             "--model-parallel", "2", "--baseline")
    assert rc == 0, out
    assert "bitwise equal across each of the 2" in out
    by_model = {}
    for rec in ranks:
        by_model.setdefault(rec["coords"]["model"], []).append(
            rec["digests"])
        assert all(s["all_reduce"] > 0 for s in rec["sent"])
    assert all(d == same[0] for same in by_model.values() for d in same)
    assert by_model[0][0] != by_model[1][0]
