"""Parity of the port's API-BCD superstep with the JAX reference.

Both sides start from the reference's train state (converted with
`state_from_jax`) and see the same `agent_batches`; the port takes each
agent's gradient with `torch.autograd.grad` through its checkpointed
layers. The model runs in
f32, where the two frameworks differ only in the order of f32 sums, so
after every superstep params, token, zhat and gacc agree to atol 1e-5.
The quadratic scenario of `test_mesh_equivalence.py` checks the same
step against a transparent numpy re-implementation.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.data.tokens import agent_batches as jax_agent_batches  # noqa: E402
from repro.dist import trainer as jax_trainer  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist.trainer import (  # noqa: E402
    init_train_state, make_train_step,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import flatten, state_from_jax  # noqa: E402

A, M = 4, 2
STATE_KEYS = ("params", "token", "zhat", "gacc")


def _assert_state_close(state, jstate, atol):
    for part in STATE_KEYS:
        want = flatten(jax.device_get(jstate[part]))
        assert set(state[part]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(state[part][k].numpy(), v, rtol=0,
                                       atol=atol, err_msg=f"{part}/{k}")


def _superstep_parity(accumulate, window=0, seq=16):
    arch = "qwen2-0.5b"
    jcfg = dataclasses.replace(jax_get_smoke(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    jtcfg = JaxTrainConfig(num_agents=A, model_parallel=1, num_walks=M,
                           accumulate_between_visits=accumulate)
    tcfg = TrainConfig(num_agents=A, num_walks=M,
                       accumulate_between_visits=accumulate)
    jmodel = jax_build_model(jcfg, window=window)
    jstate = jax_trainer.init_train_state(jmodel, jtcfg,
                                          key=jax.random.PRNGKey(0))
    state = state_from_jax(jstate)
    jstep = jax.jit(jax_trainer.make_train_step(jmodel, jtcfg))
    step_fn = make_train_step(build_model(cfg, window=window), tcfg)

    jbatches = jax_agent_batches(jcfg.vocab_size, A, 2, seq, seed=0)
    batches = agent_batches(cfg.vocab_size, A, 2, seq, seed=0)
    for step in range(4):
        jtoks, jtargs = next(jbatches)
        toks, targs = next(batches)
        np.testing.assert_array_equal(toks, jtoks)
        jstate, jmetrics = jstep(jstate, {"tokens": jnp.asarray(jtoks),
                                          "targets": jnp.asarray(jtargs)},
                                 jnp.int32(step))
        state, metrics = step_fn(state, {"tokens": torch.from_numpy(toks),
                                         "targets": torch.from_numpy(targs)},
                                 step)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), rtol=1e-5)
        _assert_state_close(state, jstate, atol=1e-5)


@pytest.mark.parametrize("accumulate", [True, False])
def test_superstep_matches_jax_for_four_steps(accumulate):
    _superstep_parity(accumulate)


def test_windowed_superstep_matches_jax_for_four_steps():
    """A windowed model (window 24 at S = 64, so the window binds), its
    gradients through the port's remat: the same atol 1e-5."""
    _superstep_parity(True, window=24, seq=64)


# ---- the quadratic scenario of test_mesh_equivalence.py ----

P = 8
TAU, RHO = 0.3, 2.0


class QuadModel:
    """Quadratic "LM": loss_i(w) = 0.5 mean (A_i w - b_i)^2."""

    def init(self, generator):
        return {"w": torch.zeros((P,), dtype=torch.float32,
                                 device=generator.device)}

    def train_loss(self, params, batch):
        r = batch["a"] @ params["w"] - batch["b"]
        loss = 0.5 * torch.mean(r * r)
        return loss, {"nll": loss, "aux": torch.zeros(())}


def _np_step(a_data, b_data, x, tok, zh, gacc, step, accumulate):
    period = A // M
    grads = np.stack([
        (a_data[i].T @ (a_data[i] @ x[i] - b_data[i])) / a_data[i].shape[0]
        for i in range(A)])
    rel = (np.arange(A) - step) % A
    active = (rel % period) == 0
    walk_id = rel // period
    if accumulate:
        gsum = gacc + grads
        g_eff = gsum / period
        gacc = np.where(active[:, None], 0.0, gsum).astype(np.float32)
    else:
        g_eff = grads
    x_new = x.copy()
    for i in range(A):
        if active[i]:
            zsum = zh[i].sum(axis=0)
            x_new[i] = (RHO * x[i] - g_eff[i] + TAU * zsum) / (RHO + TAU * M)
    tok_new = tok + (x_new - x) / A
    zh_new = zh.copy()
    for i in range(A):
        if active[i]:
            zh_new[i, walk_id[i]] = tok_new[i]
    return x_new, np.roll(tok_new, 1, axis=0), zh_new, gacc


@pytest.mark.parametrize("accumulate", [False, True])
def test_quadratic_superstep_matches_numpy_reference(accumulate):
    rng = np.random.default_rng(0)
    a_data = rng.standard_normal((A, 16, P)).astype(np.float32)
    b_data = rng.standard_normal((A, 16)).astype(np.float32)
    tcfg = TrainConfig(num_agents=A, num_walks=M, tau=TAU, rho=RHO,
                       accumulate_between_visits=accumulate)
    model = QuadModel()
    state = init_train_state(model, tcfg, torch.Generator())
    step_fn = make_train_step(model, tcfg)
    batch = {"a": torch.from_numpy(a_data), "b": torch.from_numpy(b_data)}

    x = np.zeros((A, P), np.float32)
    tok = np.zeros((A, P), np.float32)
    zh = np.zeros((A, M, P), np.float32)
    gacc = np.zeros((A, P), np.float32)
    for step in range(3 * A):
        state, _ = step_fn(state, batch, step)
        x, tok, zh, gacc = _np_step(a_data, b_data, x, tok, zh, gacc, step,
                                    accumulate)
        for part, want in (("params", x), ("token", tok), ("zhat", zh),
                           ("gacc", gacc)):
            np.testing.assert_allclose(state[part]["w"].numpy(), want,
                                       rtol=2e-5, atol=2e-5, err_msg=part)


def test_init_train_state_replicates_one_model():
    tcfg = TrainConfig(num_agents=A, num_walks=M)
    state = init_train_state(build_model(get_smoke("qwen2-0.5b")), tcfg,
                             torch.Generator().manual_seed(0))
    for k, v in state["params"].items():
        assert torch.equal(v, v[:1].expand_as(v)), k
        assert state["token"][k].shape == v.shape
        assert state["zhat"][k].shape == (A, M) + v.shape[1:]
        assert state["gacc"][k].shape == v.shape
    with pytest.raises(ValueError):
        init_train_state(QuadModel(), TrainConfig(num_agents=3, num_walks=2),
                         torch.Generator())
