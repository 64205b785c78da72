"""The port's API-BCD superstep across processes (`dist.trainer.
make_mesh_train_step` over `launch.mesh` and `dist.collectives`) against
the JAX reference, on the CPU.

`torch_mesh_script.py` runs as 4 gloo processes and goes through its
scenarios in one launch (each on its own mesh over the one group): the
smoke qwen2 in f32 on the (4, 1, 1) and (2, 2, 1) meshes ("agent",
"replica", "model") with and without accumulation, an uneven loss mask at
replica 2, tensor parallelism on the (2, 1, 2) mesh with and without
accumulation and with replicas on (1, 2, 2), the quadratic model of
`test_mesh_equivalence.py`, and the DP baseline over the 4 ranks on the
(4, 1, 1) and (2, 1, 2) meshes. Here, the ranks' parts are joined
(`sharding.gather_shards` under `trainer.state_specs`) and held:

  * against the reference's superstep on one device (its vmap over the
    agents, which `test_mesh_equivalence.py` ties to its mesh): all four
    state parts within atol 1e-5;
  * against the port's one-process `make_train_step` from the same init:
    bitwise at replica 1 and model parallel 1, within atol 1e-5 with
    replicas or a model axis; the leaves the model axis does not split
    bitwise equal across each model line;
  * to `dist_check_script.py`'s invariants in paper-faithful mode, and
    to the quadratic's numpy reference;
  * the bytes each rank sent, by kind, to the leaf arithmetic, to
    `trainer.superstep_sends` and to the roofline's `collective_bytes`.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU (and every rank of
# the script runs one too, so products take the same path on both sides)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.dist import trainer as jax_trainer  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist import tensor_parallel as TP  # noqa: E402
from repro_torch.dist import trainer as T  # noqa: E402
from repro_torch.dist.sharding import (gather_shards,  # noqa: E402
                                       state_shardings)
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (flatten, params_from_jax,  # noqa: E402
                                        state_from_jax)
from repro_torch.optim import constant, sgd  # noqa: E402
from repro_torch.utils import roofline as RL  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_script as S  # noqa: E402

WORLD = 4
PARTS = ("params", "token", "zhat", "gacc")
LM = [n for n in S.SCENARIOS if n.startswith("lm_") and
      not n.endswith("_mask")]


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def p0():
    """The reference's smoke qwen2 init (f32 compute), as the port's flat
    dict."""
    jmodel = jax_build_model(_jcfg())
    return params_from_jax(jax.device_get(jmodel.init(
        jax.random.PRNGKey(0))))


def _jcfg():
    return dataclasses.replace(jax_get_smoke("qwen2-0.5b"),
                               compute_dtype="float32")


def _cfg():
    return dataclasses.replace(get_smoke("qwen2-0.5b"),
                               compute_dtype="float32")


@pytest.fixture(scope="module")
def launched(tmp_path_factory, p0):
    """The 4 ranks of torch_mesh_script.py, started (the references are
    computed while they run)."""
    out = tmp_path_factory.mktemp("mesh_runs")
    torch.save(p0, out / "p0.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_mesh_script.py"),
         "--rank", str(r), "--world", str(WORLD), "--coordinator",
         f"localhost:{port}", "--init", str(out / "p0.pt"), "--out",
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(WORLD)]
    return out, procs


def _jax_run(scenario, steps=None):
    """The reference's superstep on one device for an lm scenario: (final
    state as flat numpy, losses)."""
    _, a, _, m, accumulate, n, _ = S.SCENARIOS[scenario]
    jcfg = _jcfg()
    jtcfg = JaxTrainConfig(num_agents=a, model_parallel=1, num_walks=m,
                           accumulate_between_visits=accumulate)
    jmodel = jax_build_model(jcfg)
    jstate = jax_trainer.init_train_state(jmodel, jtcfg,
                                          key=jax.random.PRNGKey(0))
    step_fn = jax.jit(jax_trainer.make_train_step(jmodel, jtcfg))
    stream = agent_batches(jcfg.vocab_size, a, S.ROWS, S.SEQ, seed=0)
    losses = []
    for step in range(steps or n):
        toks, targs = next(stream)
        jstate, met = step_fn(jstate, {"tokens": jnp.asarray(toks),
                                       "targets": jnp.asarray(targs)},
                              jnp.int32(step))
        losses.append(float(met["loss"]))
    return ({part: flatten(jax.device_get(jstate[part])) for part in PARTS},
            losses)


def _port_run(scenario, p0):
    """The port's one-process superstep for an lm scenario from the same
    init: (final state, losses)."""
    _, a, _, m, accumulate, n, _ = S.SCENARIOS[scenario]
    tcfg = TrainConfig(num_agents=a, num_walks=m,
                       accumulate_between_visits=accumulate)
    model = S.lm_model(p0)
    state = T.init_train_state(model, tcfg, torch.Generator())
    step_fn = T.make_train_step(build_model(_cfg()), tcfg)
    stream = agent_batches(_cfg().vocab_size, a, S.ROWS, S.SEQ, seed=0)
    losses = []
    for step in range(n):
        toks, targs = next(stream)
        batch = {"tokens": torch.from_numpy(toks),
                 "targets": torch.from_numpy(targs)}
        if scenario.endswith("_mask"):
            batch["loss_mask"] = torch.from_numpy(S.uneven_mask(a, S.ROWS,
                                                                S.SEQ))
        state, met = step_fn(state, batch, step)
        losses.append(float(met["loss"]))
    return state, losses


@pytest.fixture(scope="module")
def references(launched, p0):
    refs = {name: {"jax": _jax_run(name), "port": _port_run(name, p0)}
            for name in LM}
    refs["lm_2x2_mask"] = {"port": _port_run("lm_2x2_mask", p0)}
    return refs


@pytest.fixture(scope="module")
def runs(launched, references):
    """{scenario: [rank 0's record, ..., rank 3's]}, once every rank has
    finished."""
    out, procs = launched
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    assert all("MESH_SCRIPT_OK" in log for log in logs)
    return {name: [torch.load(out / f"{name}.rank{r}.pt")
                   for r in range(WORLD)]
            for name in [*S.SCENARIOS, *S.DP_MESHES]}


def _tcfg(scenario):
    kind, a, _, m, accumulate, _, _ = S.SCENARIOS[scenario]
    if kind == "quad":
        return TrainConfig(num_agents=a, num_walks=m, tau=S.QUAD_TAU,
                           rho=S.QUAD_RHO,
                           accumulate_between_visits=accumulate)
    return TrainConfig(num_agents=a, num_walks=m,
                       accumulate_between_visits=accumulate)


def _sizes(scenario):
    _, a, r, *_ = S.SCENARIOS[scenario]
    return {"agent": a, "replica": r,
            "model": S.MODEL_PARALLEL.get(scenario, 1)}


def _specs(scenario, p_shapes):
    """The state's specs on the scenario's mesh: the tensor-parallel split
    on a model axis above 1 (`tensor_parallel.model_dims`)."""
    sizes = _sizes(scenario)
    dims = TP.model_dims(_cfg(), p_shapes) if sizes["model"] > 1 else None
    return state_shardings(sizes, T._state_shapes(p_shapes, _tcfg(
        scenario)), model_dims=dims)


def _joined(scenario, records, p_shapes, state=None):
    """The whole state from the ranks' parts (`state`: which recorded
    state, default the final one)."""
    sizes = _sizes(scenario)
    specs = _specs(scenario, p_shapes)
    pick = (lambda rec: rec["state"]) if state is None else state
    parts = pick(records[0]).keys()
    return {part: {k: gather_shards([pick(rec)[part][k] for rec in records],
                                    specs[part][k], sizes)
                   for k in pick(records[0])[part]}
            for part in parts}


def _quad_shapes():
    return {"w": torch.empty(S.QUAD_P)}


@pytest.mark.parametrize("scenario", LM)
def test_mesh_superstep_matches_the_reference(scenario, runs, references,
                                              p0):
    """4 supersteps over 4 processes: every part within atol 1e-5 of the
    reference's state, losses within rtol 1e-5."""
    want, jlosses = references[scenario]["jax"]
    got = _joined(scenario, runs[scenario], p0)
    for part in PARTS:
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), v, rtol=0,
                                       atol=1e-5, err_msg=f"{part}/{k}")
    for rec in runs[scenario]:
        np.testing.assert_allclose([m["loss"] for m in rec["metrics"]],
                                   jlosses, rtol=1e-5)


@pytest.mark.parametrize("scenario", LM)
def test_mesh_superstep_against_the_one_process_step(scenario, runs,
                                                     references, p0):
    """Replica 1: each rank runs its agent's slice of the one-process step
    on the same shapes, so the joined state is bitwise the one-process
    state. Replica 2: the reduce-scatter sums the replicas' gradients in
    another order than one backward over all rows; a model axis sums the
    ranks' partial products and gradients in another order than one
    process's products: within atol 1e-5."""
    want, losses = references[scenario]["port"]
    got = _joined(scenario, runs[scenario], p0)
    sizes = _sizes(scenario)
    worst = 0.0
    for part in PARTS:
        for k, v in want[part].items():
            if sizes["replica"] == 1 and sizes["model"] == 1:
                assert torch.equal(got[part][k], v), f"{part}/{k}"
            else:
                worst = max(worst, float((got[part][k] - v).abs().max()))
    assert worst <= 1e-5, worst
    for rec in runs[scenario]:
        np.testing.assert_allclose([m["loss"] for m in rec["metrics"]],
                                   losses, rtol=1e-6)


@pytest.mark.parametrize("scenario", [n for n in LM if "paper" in n])
def test_paper_faithful_invariants_across_ranks(scenario, runs, p0):
    """dist_check_script.py's invariants on the joined states: only the M
    token-holding agents' params change in a superstep (the others are
    bit-untouched), and the tokens' sum moves as the agents' mean
    (sum_m (z_m - z_m^0) = mean_i x_i - mean_i x_i^0) within 1e-5."""
    a, m = _sizes(scenario)["agent"], _tcfg(scenario).num_walks
    period = a // m
    records = runs[scenario]
    prev = {k: v.expand((a,) + v.shape) for k, v in p0.items()}
    x0 = {k: v.double() for k, v in p0.items()}
    for step in range(len(records[0]["states"])):
        cur = _joined(scenario, records, p0,
                      state=lambda rec, s=step: rec["states"][s])
        active = [(i - step) % period == 0 for i in range(a)]
        for k, x in cur["params"].items():
            for i in range(a):
                if not active[i]:
                    assert torch.equal(x[i], prev[k][i]), (step, i, k)
            np.testing.assert_allclose(
                cur["token"][k].double().sum(0).numpy(),
                (x.double().mean(0) - x0[k]).numpy(), rtol=1e-3, atol=1e-5)
        assert sum(active) == m
        prev = cur["params"]


def _np_step(a_data, b_data, x, tok, zh, gacc, step, a, m, accumulate):
    """test_mesh_equivalence.py's numpy superstep, with accumulation."""
    period = a // m
    grads = np.stack([
        (a_data[i].T @ (a_data[i] @ x[i] - b_data[i])) / a_data[i].shape[0]
        for i in range(a)])
    rel = (np.arange(a) - step) % a
    active = (rel % period) == 0
    walk_id = rel // period
    if accumulate:
        gsum = gacc + grads
        g_eff = gsum / period
        gacc = np.where(active[:, None], 0.0, gsum).astype(np.float32)
    else:
        g_eff = grads
    x_new = x.copy()
    for i in range(a):
        if active[i]:
            zsum = zh[i].sum(axis=0)
            x_new[i] = (S.QUAD_RHO * x[i] - g_eff[i] + S.QUAD_TAU * zsum) / (
                S.QUAD_RHO + S.QUAD_TAU * m)
    tok_new = tok + (x_new - x) / a
    zh_new = zh.copy()
    for i in range(a):
        if active[i]:
            zh_new[i, walk_id[i]] = tok_new[i]
    return x_new, np.roll(tok_new, 1, axis=0), zh_new, gacc


@pytest.mark.parametrize("scenario", [n for n in S.SCENARIOS
                                      if n.startswith("quad_")])
def test_quadratic_through_the_mesh_matches_numpy(scenario, runs):
    """The quadratic scenario of test_mesh_equivalence.py through the mesh
    step (its 16 rows split over the replicas where replica = 2): every
    part within 2e-5 of the transparent numpy superstep, as that test
    holds the reference's mesh."""
    _, a, _, m, accumulate, steps, _ = S.SCENARIOS[scenario]
    a_data, b_data = S.quad_data(a)
    x = np.zeros((a, S.QUAD_P), np.float32)
    tok, gacc = np.zeros_like(x), np.zeros_like(x)
    zh = np.zeros((a, m, S.QUAD_P), np.float32)
    for step in range(steps):
        x, tok, zh, gacc = _np_step(a_data, b_data, x, tok, zh, gacc, step,
                                    a, m, accumulate)
    got = _joined(scenario, runs[scenario], _quad_shapes())
    for part, want in (("params", x), ("token", tok), ("zhat", zh),
                       ("gacc", gacc)):
        np.testing.assert_allclose(got[part]["w"].numpy(), want, rtol=2e-5,
                                   atol=2e-5, err_msg=part)
    assert np.abs(x).max() > 0.01          # the walk moved


def test_uneven_loss_mask_weights_each_replica_by_its_tokens(runs,
                                                             references,
                                                             p0):
    """At replica 2 the two rows of an agent keep 2 + i and 15 - i of their
    16 tokens. The loss is sum(nll * mask) / sum(mask), so each replica's
    gradient counts by its share of the mask, not by half: the joined
    state stays within atol 1e-5 of the one-process step."""
    mask = S.uneven_mask(2, S.ROWS, S.SEQ)
    shares = mask[:, 0].sum(-1) / mask.sum((1, 2))
    assert np.all(np.abs(shares - 0.5) > 0.3), shares
    want, losses = references["lm_2x2_mask"]["port"]
    got = _joined("lm_2x2_mask", runs["lm_2x2_mask"], p0)
    for part in PARTS:
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{part}/{k}")
    for rec in runs["lm_2x2_mask"]:
        np.testing.assert_allclose([m["loss"] for m in rec["metrics"]],
                                   losses, rtol=1e-6)


def _dp_reference(p0):
    """The one-process DP step (sgd with momentum, the uneven mask on the
    global batch) from `p0`: (params, losses)."""
    model = S.lm_model(p0)
    opt = sgd(0.9)
    params = model.init(None)
    opt_state = opt.init(params)
    step_fn = T.make_dp_baseline_step(build_model(_cfg()), opt,
                                      constant(0.05))
    stream = agent_batches(_cfg().vocab_size, 4, S.ROWS, S.SEQ, seed=0)
    mask = torch.from_numpy(S.uneven_mask(4, S.ROWS, S.SEQ).reshape(
        -1, S.SEQ))
    losses = []
    for step in range(S.DP_STEPS):
        toks, targs = next(stream)
        params, opt_state, met = step_fn(
            params, opt_state,
            {"tokens": torch.from_numpy(toks.reshape(-1, S.SEQ)),
             "targets": torch.from_numpy(targs.reshape(-1, S.SEQ)),
             "loss_mask": mask}, step)
        losses.append(float(met["loss"]))
    return params, losses


def test_dp_baseline_over_ranks_matches_one_process(runs, p0):
    """The DP baseline over the 4 ranks (sgd with momentum, the uneven
    mask on the global batch): every rank holds the same params, within
    atol 1e-5 of the one-process DP step's; losses within rtol 1e-5."""
    params, losses = _dp_reference(p0)
    recs = runs["dp"]
    for rec in recs:
        for k, v in params.items():
            assert torch.equal(rec["params"][k], recs[0]["params"][k]), k
            np.testing.assert_allclose(rec["params"][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose([m["loss"] for m in rec["metrics"]],
                                   losses, rtol=1e-5)


def test_dp_baseline_on_the_model_axis_matches_one_process(runs, p0):
    """The DP baseline on the (2, 1, 2) mesh: the batch splits over the 2
    data-parallel ranks only, each model line holds its pieces of the
    params and optimizer state, and the gradient is summed over the
    ranks of one model coordinate. The ranks of a model coordinate hold
    bitwise-equal pieces, the leaves the axis does not split are bitwise
    equal on all 4 ranks, the pieces join (`gather_params`) within atol
    1e-5 of the one-process DP step's params, and every rank reports its
    losses within rtol 1e-5."""
    params, losses = _dp_reference(p0)
    recs = runs["dp_2x1x2"]
    cfg = _cfg()
    specs = TP.param_specs(cfg, p0)
    by_model = {}
    for rec in recs:
        by_model.setdefault(rec["coords"]["model"], []).append(rec)
        np.testing.assert_allclose([m["loss"] for m in rec["metrics"]],
                                   losses, rtol=1e-5)
        assert rec["metrics"] == recs[0]["metrics"]
        assert rec["sent"]["all_reduce"] > 0
    for same in by_model.values():
        for rec in same:
            assert all(torch.equal(rec["params"][k], same[0]["params"][k])
                       for k in params)
    for k in params:
        if "model" not in specs[k]:
            assert all(torch.equal(rec["params"][k], recs[0]["params"][k])
                       for rec in recs), k
    joined = TP.gather_params(cfg, [by_model[i][0]["params"]
                                    for i in range(2)], {"model": 2})
    for k, v in params.items():
        np.testing.assert_allclose(joined[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def _leaf_arithmetic(shapes, a, r, world):
    """Bytes each rank sends in a superstep, written out: the f32 token
    shard on the ring (a > 1); where r = 2 splits a leaf (some dim is
    even), half of it in the param dtype to the other replica and half of
    its f32 gradient back; a leaf nothing splits sends its whole f32
    gradient; the 3 metric means' all_reduce over the world."""
    ring = ag = rs = 0
    for v in shapes.values():
        n = v.numel()
        split = r == 2 and any(d % 2 == 0 for d in v.shape)
        shard = n // 2 if split else n
        ring += 4 * shard if a > 1 else 0
        ag += shard * v.element_size() if split else 0
        rs += 4 * shard if r == 2 else 0
    pieces = [1, 1, 1, 0]               # 3 floats over 4 ranks
    out = []
    for rank in range(world):
        sends = {"ring_shift": ring, "all_gather": ag, "reduce_scatter": rs,
                 "all_reduce": 4 * (3 - pieces[rank] + 3 * pieces[rank])}
        out.append({k: v for k, v in sends.items() if v})
    return out


@pytest.mark.parametrize("scenario", [n for n in S.SCENARIOS
                                      if n not in S.MODEL_PARALLEL])
def test_bytes_sent_equal_the_leaf_arithmetic(scenario, runs, p0):
    """Every rank's byte counters, every superstep, equal the arithmetic
    on the leaf shapes written out here and `trainer.superstep_sends`;
    their sum over the ranks is the roofline's collective_bytes."""
    shapes = _quad_shapes() if scenario.startswith("quad") else p0
    sizes = _sizes(scenario)
    want = _leaf_arithmetic(shapes, sizes["agent"], sizes["replica"], WORLD)
    assert T.superstep_sends(shapes, sizes, S.ROWS if scenario.startswith(
        "lm") else S.QUAD_ROWS) == want
    for rec in runs[scenario]:
        rank = M.Mesh(M.TRAINING_AXES, list(sizes.values())).rank_of(
            rec["coords"])
        for sent in rec["sent"]:
            assert sent == want[rank], (rank, sent)
    total = T.mesh_collective_bytes(shapes, sizes, S.ROWS)
    assert total == sum(sum(w.values()) for w in want)
    rl = RL.Roofline({"f32": 1e9}, 1e6, collective_bytes=total,
                     chips=WORLD)
    assert rl.collective_bytes == total and rl.chips == WORLD
    assert rl.collective_s == total / (WORLD * RL.LINK_BW)
    assert rl.as_dict()["collective_bytes"] == total


def _model_axis_arithmetic(shapes, a, r, mp, world):
    """Bytes each rank sends in a superstep on a model axis of 2, written
    out for the f32 smoke qwen2 (tied, no qk-norm): the f32 token shard
    on the ring (a > 1) and, where r = 2, half of each param shard (the
    replica's all_gather) and half of its f32 gradient back; on the axis,
    in f32 over rows x SEQ tokens of d_model: the lookup's sum, per layer
    two forward sums, the attention's again in remat's replay and two
    gradient sums, the head's gradient sum, and the cross-entropy's
    (sum, target) pairs; its maxima gathered; the 3 metric means'
    all_reduce over the world."""
    cfg = _cfg()
    assert mp == 2 and cfg.tie_embeddings and not cfg.qk_norm
    rows = S.ROWS // r
    tokens = rows * S.SEQ
    ring = ag = rs = 0
    for k, spec in TP.param_specs(cfg, shapes).items():
        v = shapes[k]
        n = v.numel() // (2 if "model" in spec else 1)
        # "replica" takes an even dim the model axis leaves
        split = r == 2 and any(d % 2 == 0 for d, e in zip(v.shape, spec)
                               if e is None)
        shard = n // 2 if split else n
        ring += 4 * shard if a > 1 else 0
        ag += shard * v.element_size() if split else 0
        rs += 4 * shard if r == 2 else 0
    sums = (1 + 5 * cfg.num_layers + 1) * tokens * cfg.d_model + 2 * tokens
    pieces = [1, 1, 1, 0]               # 3 floats over 4 ranks
    out = []
    for rank in range(world):
        sends = {"ring_shift": ring, "all_gather": ag + 4 * tokens,
                 "reduce_scatter": rs,
                 "all_reduce": 4 * sums + 4 * (3 - pieces[rank]
                                               + 3 * pieces[rank])}
        out.append({k: v for k, v in sends.items() if v})
    return out


@pytest.mark.parametrize("scenario", list(S.MODEL_PARALLEL))
def test_model_axis_bytes_equal_superstep_sends(scenario, runs, p0):
    """On a model axis every rank's byte counters, every superstep, equal
    the arithmetic written out here and `trainer.superstep_sends` (the
    axis's sums, remat's replay included, beside the ring, the replicas
    and the metrics)."""
    sizes = _sizes(scenario)
    want = _model_axis_arithmetic(p0, sizes["agent"], sizes["replica"],
                                  sizes["model"], WORLD)
    assert T.superstep_sends(p0, sizes, S.ROWS, cfg=_cfg(), seq=S.SEQ) == want
    for rec in runs[scenario]:
        rank = M.Mesh(M.TRAINING_AXES, list(sizes.values())).rank_of(
            rec["coords"])
        for sent in rec["sent"]:
            assert sent == want[rank], (rank, sent)
    assert T.mesh_collective_bytes(p0, sizes, S.ROWS, cfg=_cfg(),
                                   seq=S.SEQ) == sum(sum(w.values())
                                                     for w in want)


@pytest.mark.parametrize("scenario", list(S.MODEL_PARALLEL))
def test_unsplit_leaves_are_bitwise_equal_across_each_model_line(scenario,
                                                                 runs, p0):
    """Every rank of a model line computes the whole gradient of the
    leaves the axis does not split (the norm scales), in the same order,
    so their state parts stay bitwise equal across the line; the split
    leaves' pieces differ."""
    specs = _specs(scenario, p0)
    lines = {}
    for rec in runs[scenario]:
        where = (rec["coords"]["agent"], rec["coords"]["replica"])
        lines.setdefault(where, []).append(rec["state"])
    for same in lines.values():
        assert len(same) == 2
        for part in PARTS:
            for k, v in same[0][part].items():
                if "model" not in specs[part][k]:
                    assert torch.equal(v, same[1][part][k]), (part, k)
        assert not torch.equal(same[0]["params"]["embed.table"],
                               same[1]["params"]["embed.table"])


# ---- refusals, in this process (no process group) ----


def test_moe_with_replicas_is_refused():
    model = build_model(get_smoke("dbrx-132b"))
    tcfg = TrainConfig(num_agents=2, num_walks=1)
    mesh = M.Mesh(M.TRAINING_AXES, (2, 2, 1), rank=0)
    with pytest.raises(NotImplementedError, match="MoE"):
        T.make_mesh_train_step(model, tcfg, mesh, comm=None)
    with pytest.raises(NotImplementedError, match="MoE"):
        T.init_mesh_train_state(model, tcfg, mesh, torch.Generator())
    # replica 1 runs every family
    T._check_mesh(model, tcfg, M.Mesh(M.TRAINING_AXES, (2, 1, 1)))


def test_model_axis_and_bad_meshes_are_refused():
    """A model axis trains the dense attention stack; the families it
    splits only to serve raise: the recurrent families and the
    encoder-decoder naming ROADMAP item 6.1f, MoE and MLA item 6.1e,
    in the mesh step and in the launcher before any process starts; bad
    meshes raise."""
    model = build_model(get_smoke("qwen2-0.5b"))
    tcfg = TrainConfig(num_agents=2, num_walks=1)
    model_axis = M.Mesh(M.TRAINING_AXES, (2, 1, 2))
    T._check_mesh(model, tcfg, model_axis)
    assert train_cli._replica(train_cli.parse_args(
        ["--smoke", "--processes", "4", "--agents", "2",
         "--model-parallel", "2", "--device", "cpu"])) == 1
    for arch, item in (("dbrx-132b", "6.1e"), ("deepseek-v2-236b", "6.1e"),
                       ("rwkv6-1.6b", "6.1f"), ("recurrentgemma-2b", "6.1f"),
                       ("whisper-small", "6.1f")):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            T._check_mesh(build_model(get_smoke(arch)), tcfg, model_axis)
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            train_cli.main(["--arch", arch, "--smoke", "--processes", "4",
                            "--agents", "2", "--model-parallel", "2",
                            "--device", "cpu"])
    with pytest.raises(ValueError, match="agent axis"):
        T._check_mesh(model, tcfg, M.Mesh(M.TRAINING_AXES, (4, 1, 1)))
    with pytest.raises(ValueError, match="give --processes"):
        train_cli.main(["--smoke", "--model-parallel", "2", "--device",
                        "cpu"])
    with pytest.raises(ValueError, match="not a multiple"):
        train_cli.main(["--smoke", "--processes", "3", "--agents", "2",
                        "--device", "cpu"])


def test_nccl_is_refused_with_more_ranks_than_gpus(monkeypatch):
    """The transport is chosen by name and checked before any process
    starts: NCCL needs CUDA tensors and a GPU a rank."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        train_cli.main(["--smoke", "--processes", "4", "--backend",
                        "nccl", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one GPU a rank"):
        M.check_backend("nccl", 4, "cuda")
    M.check_backend("nccl", 1, "cuda")
    M.check_backend("gloo", 4, "cuda")
    with pytest.raises(ValueError, match="backend"):
        M.check_backend("mpi", 4, "cpu")
