"""Parity of the port's training paths past the API-BCD superstep with the
JAX reference: the optimizers and schedules, the all-reduce DP baseline,
the online-softmax `chunked_attention` past one chunk of 1024, `train_loss`
with a window and with or without remat, checkpoints read by both
packages, and the launcher's `--baseline` and `--checkpoint-dir`.

Inputs come from numpy seeds; the reference's models start from its own
`model.init`, converted with `params_from_jax`. Everything runs in f32
unless a test says otherwise; each tolerance is named where it is used.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro.checkpoint import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.data.tokens import agent_batches as jax_agent_batches  # noqa: E402
from repro.dist import trainer as jax_trainer  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import optimizers as jax_optimizers  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data.tokens import agent_batches  # noqa: E402
from repro_torch.dist.trainer import make_dp_baseline_step  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.models.convert import flatten, params_from_jax  # noqa: E402
from repro_torch.optim.optimizers import apply_updates  # noqa: E402

ARCH = "qwen2-0.5b"


def _f32_reference():
    """The reference's schedules and optimizers as its jitted step runs
    them without x64: the int32 step and its rates in f32
    (tests/conftest.py turns x64 on)."""
    return jax.enable_x64(False)


def _np(tree):
    return flatten(jax.device_get(tree))


def _bf16_ulp(x):
    """One bf16 ulp of |x| (the spacing at x's exponent; 2^-133 at 0)."""
    x = np.abs(np.asarray(x, np.float32))
    e = np.floor(np.log2(np.maximum(x, np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - 7)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda m: m.sgd(),
    "sgd_momentum": lambda m: m.sgd(momentum=0.9),
    "adam": lambda m: m.adam(),
    "adamw": lambda m: m.adamw(weight_decay=0.1),
}


def _assert_tree_close(got, want, f32_tol, what):
    """f32 leaves within f32_tol; bf16 leaves (the reference's come back as
    ml_dtypes bf16) within one bf16 ulp, as XLA may keep an elementwise
    chain in f32 where PyTorch rounds each op to bf16."""
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        if g.dtype == torch.bfloat16:
            gv, wv = g.float().numpy(), np.asarray(w, np.float32)
            np.testing.assert_array_less(np.abs(gv - wv),
                                         _bf16_ulp(wv) + 1e-30,
                                         err_msg=f"{what}/{k}")
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=f32_tol,
                                       atol=f32_tol, err_msg=f"{what}/{k}")


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_and_state_match_reference(name):
    """Five steps on a tree with an f32 and a bf16 leaf, the same grads on
    both sides (no summation order differs): updates, state and params
    within 2e-6 in f32 (the bias corrections' pow and the sqrt round
    differently in XLA and PyTorch by an ulp or two; gradients here are
    far from zero, so Adam's sign caveat does not arise), bf16 leaves
    within one bf16 ulp."""
    rng = np.random.default_rng(0)
    p_np = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}
    jparams = {"w": jnp.asarray(p_np["w"]),
               "b": jnp.asarray(p_np["b"], jnp.bfloat16)}
    params = params_from_jax(jax.device_get(jparams))
    assert params["b"].dtype == torch.bfloat16
    with _f32_reference():
        jopt = OPTIMIZERS[name](jax_optim.optimizers)
        jstate = jopt.init(jparams)
        jlr = jax_optim.constant(1e-2)(jnp.int32(0))
        opt = OPTIMIZERS[name](optim.optimizers)
        state = opt.init(params)
        for step in range(5):
            g_np = {k: rng.standard_normal(v.shape).astype(np.float32)
                    for k, v in p_np.items()}
            jgrads = {k: jnp.asarray(v, jparams[k].dtype)
                      for k, v in g_np.items()}
            grads = params_from_jax(jax.device_get(jgrads))
            jupd, jstate = jopt.update(jgrads, jstate, jparams, jlr)
            jparams = jax_optimizers.apply_updates(jparams, jupd)
            upd, state = opt.update(grads, state, params,
                                    optim.constant(1e-2)(step))
            params = apply_updates(params, upd)
            assert all(u.dtype == torch.float32 for u in upd.values())
            _assert_tree_close(upd, _np(jupd), 2e-6, f"update {step}")
            _assert_tree_close(params, _np(jparams), 2e-6, f"params {step}")
            if name.startswith("adam"):
                assert int(state["count"]) == int(jstate["count"]) == step + 1
                for part in ("mu", "nu"):
                    _assert_tree_close(state[part], _np(jstate[part]), 2e-6,
                                       f"{part} {step}")
                    assert state[part]["b"].dtype == torch.float32
            elif name == "sgd_momentum":
                _assert_tree_close(state, _np(jstate), 2e-6,
                                   f"momentum {step}")
                assert state["b"].dtype == torch.bfloat16
            else:
                assert state == () and jstate == ()


SCHEDULES = {
    "constant": lambda s: s.constant(3e-4),
    "cosine_decay": lambda s: s.cosine_decay(1e-3, 17, final_fraction=0.2),
    "warmup_cosine": lambda s: s.warmup_cosine(1e-3, 5, 23),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    """Steps 0..30, across the warmup boundary (5) and past the decay's
    end: the rate in f32, within rtol 3e-7, two f32 ulps of the
    reference's (XLA's f32 cos is off PyTorch's by up to two ulps: at
    step 14 of a 18-step decay, cos(2.4434612) is -0.7660446 in XLA and
    -0.76604456 in PyTorch and numpy)."""
    with _f32_reference():
        jf = SCHEDULES[name](jax_optim.schedules)
        want = np.array([np.float32(jf(jnp.int32(s))) for s in range(31)])
    f = SCHEDULES[name](optim.schedules)
    got = [f(s) for s in range(31)]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    np.testing.assert_allclose(np.array([float(g) for g in got]), want,
                               rtol=3e-7, atol=0)


# ---------------------------------------------------------------------------
# the DP baseline
# ---------------------------------------------------------------------------

DP_ARMS = {
    "adamw_constant": (lambda m: m.adamw(weight_decay=0.0),
                       lambda s: s.constant(3e-4)),
    "sgd_momentum_warmup_cosine": (lambda m: m.sgd(momentum=0.9),
                                   lambda s: s.warmup_cosine(0.1, 2, 3)),
}
DP_STEPS, DP_LR = 3, 3e-4


@pytest.mark.parametrize("arm", sorted(DP_ARMS))
def test_dp_baseline_matches_reference_for_three_steps(arm):
    """make_dp_baseline_step on the smoke config, global batch [A*B, S] =
    [8, 16], against the reference's jitted step from its model.init.

    Loss rtol 1e-5 every step. sgd with momentum: params and velocity
    within 1e-5. adamw: Adam's first steps move each parameter by about
    lr * sign(g), so a gradient near zero whose sign flips between XLA's
    and PyTorch's f32 summation orders can move a parameter by up to
    2 * lr a step; params are held within 2 * lr * steps everywhere and
    1e-5 (rtol 1e-5) on all but 0.1 % of elements; mu within 1e-5 and nu
    within 1e-7 (squares of gradients of ~1e-3)."""
    make_opt, make_sched = DP_ARMS[arm]
    jcfg = dataclasses.replace(jax_get_smoke(ARCH), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    with _f32_reference():
        jopt = make_opt(jax_optim.optimizers)
        jstate = jopt.init(jparams)
        jstep = jax.jit(jax_trainer.make_dp_baseline_step(
            jmodel, jopt, make_sched(jax_optim.schedules)))
        opt = make_opt(optim.optimizers)
        state = opt.init(params)
        step_fn = make_dp_baseline_step(build_model(cfg), opt,
                                        make_sched(optim.schedules))
        jb = jax_agent_batches(jcfg.vocab_size, 4, 2, 16, seed=0)
        tb = agent_batches(cfg.vocab_size, 4, 2, 16, seed=0)
        for step in range(DP_STEPS):
            (jt, jg), (t, g) = next(jb), next(tb)
            np.testing.assert_array_equal(t, jt)
            jparams, jstate, jm = jstep(
                jparams, jstate, {"tokens": jnp.asarray(jt.reshape(-1, 16)),
                                  "targets": jnp.asarray(jg.reshape(-1, 16))},
                step)
            params, state, m = step_fn(
                params, state, {"tokens": torch.from_numpy(t.reshape(-1, 16)),
                                "targets": torch.from_numpy(g.reshape(-1, 16))},
                step)
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       rtol=1e-5)
            assert set(m) == {"loss", "nll", "aux"}
    want = _np(jparams)
    if arm.startswith("sgd"):
        _assert_tree_close(params, want, 1e-5, "params")
        _assert_tree_close(state, _np(jstate), 1e-5, "velocity")
        return
    bound = 2 * DP_LR * DP_STEPS
    off, total = 0, 0
    for k, w in want.items():
        err = np.abs(params[k].numpy() - w)
        assert err.max() <= bound, (k, err.max())
        off += int((err > 1e-5 + 1e-5 * np.abs(w)).sum())
        total += err.size
    assert off <= total // 1000, (off, total)
    _assert_tree_close(state["mu"], _np(jstate["mu"]), 1e-5, "mu")
    _assert_tree_close(state["nu"], _np(jstate["nu"]), 1e-7, "nu")
    assert int(state["count"]) == int(jstate["count"]) == DP_STEPS


# ---------------------------------------------------------------------------
# chunked_attention past one chunk
# ---------------------------------------------------------------------------


def _attention_case(s, t, seed, q_offset=0, window=0):
    """Output and the gradient of sum(out * w) with respect to q, k, v, on
    both sides: q [1, S, 2, 2, 8] (GQA G = 2), k/v [1, T, 2, 8]."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, s, 2, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, t, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, t, 2, 8)).astype(np.float32)
    w = rng.standard_normal((1, s, 2, 2, 8)).astype(np.float32)

    def jf(q_, k_, v_):
        out = jax_attention.chunked_attention(q_, k_, v_, window=window,
                                              q_offset=q_offset)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention.chunked_attention(tq, tk, tv, window=window,
                                      q_offset=q_offset)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    return (out.detach(), grads), (np.asarray(jout),
                                   [np.asarray(g) for g in jgrads])


@pytest.mark.parametrize("window", [0, 300, 1500])
@pytest.mark.parametrize("s", [1024, 1100, 2100])
def test_chunked_attention_and_gradient_past_one_chunk(s, window):
    """K/V chunks of 1024 (one, two with a cut last chunk, three), with
    and without a window that crosses a chunk: output and q/k/v gradients
    within atol 1e-5 (only the order of f32 sums differs)."""
    (out, grads), (jout, jgrads) = _attention_case(s, s, s + window,
                                                   window=window)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-5)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-5,
                                   err_msg=name)


def test_chunked_attention_with_q_offset():
    """300 queries at positions 1800..2099 against 2100 keys (the causal
    mask at the offset, three K/V chunks), window 700."""
    (out, grads), (jout, jgrads) = _attention_case(300, 2100, 7,
                                                   q_offset=1800, window=700)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-5)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# train_loss past one chunk, windowed, with and without remat
# ---------------------------------------------------------------------------

LONG_S = 1100


@pytest.fixture(scope="module")
def long_batch():
    cfg = jax_get_smoke(ARCH)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (1, LONG_S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module")
def long_params():
    jcfg = dataclasses.replace(jax_get_smoke(ARCH), compute_dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jparams, params_from_jax(jax.device_get(jparams))


def _port_loss_and_grads(window, remat, params, toks, targs):
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    model = build_model(cfg, window=window)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = model.train_loss(leaves, {"tokens": torch.from_numpy(toks),
                                        "targets": torch.from_numpy(targs)},
                               remat=remat)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("window", [0, 300])
def test_train_loss_and_every_gradient_leaf_past_one_chunk(
        long_params, long_batch, window, remat):
    """S = 1100 (two K/V chunks), the reference's train_loss under
    jax.grad with the same window and remat: loss rtol 1e-5, every
    gradient leaf within rtol 1e-4 / atol 1e-5 (test_torch_model.py's
    bound for the f32 gradient)."""
    jparams, params = long_params
    toks, targs = long_batch
    jcfg = dataclasses.replace(jax_get_smoke(ARCH), compute_dtype="float32")
    jmodel = jax_build_model(jcfg, window=window)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.train_loss(p, b, remat=remat), has_aux=True))(
        jparams, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(targs)})
    jgrads = _np(jgrads)
    loss, grads = _port_loss_and_grads(window, remat, params, toks, targs)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert set(grads) == set(jgrads)
    for k in sorted(jgrads):
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("window", [0, 300])
def test_port_remat_leaves_loss_and_gradients_bitwise(long_params,
                                                     long_batch, window):
    """Checkpointing recomputes the same ops on the same inputs, so on the
    CPU the loss and every gradient leaf are bitwise those without it."""
    _, params = long_params
    loss_r, grads_r = _port_loss_and_grads(window, True, params, *long_batch)
    loss_n, grads_n = _port_loss_and_grads(window, False, params,
                                           *long_batch)
    assert loss_r == loss_n
    for k in grads_n:
        assert torch.equal(grads_r[k], grads_n[k]), k


# ---------------------------------------------------------------------------
# checkpoints, read by both packages
# ---------------------------------------------------------------------------


def _jax_dp_state(arch="qwen2-0.5b", **overrides):
    """A reference state with every kind of leaf: params, Adam's moments
    (after one update, so nonzero) and its int32 count."""
    jcfg = dataclasses.replace(jax_get_smoke(arch), **overrides)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    opt = jax_optim.adam()
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), jparams)
    _, ostate = opt.update(grads, opt.init(jparams), jparams,
                           jnp.float32(1e-3))
    return {"params": jparams, "opt": ostate}


def _port_state(jstate):
    return {"params": params_from_jax(jax.device_get(jstate["params"])),
            "opt": {"mu": params_from_jax(jax.device_get(jstate["opt"]["mu"])),
                    "nu": params_from_jax(jax.device_get(jstate["opt"]["nu"])),
                    "count": torch.tensor(
                        np.asarray(jstate["opt"]["count"]))}}


def _template(tree):
    """Zeros of the tree's shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: _template(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_bitwise(got[k], w)
        else:
            assert got[k].dtype == w.dtype, k
            assert torch.equal(got[k], w), k


def _npz_keys(path):
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return set(data.files)


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def test_reference_checkpoint_loads_in_port(tmp_path):
    """The reference's save_checkpoint of a state, read by the port's
    load_checkpoint into a template of zeros: bitwise, step carried."""
    jstate = _jax_dp_state()
    jax_ckpt.save_checkpoint(str(tmp_path), jstate, step=7,
                             metadata={"arch": "qwen2-smoke"})
    want = _port_state(jstate)
    got, step = ckpt.load_checkpoint(str(tmp_path), _template(want))
    assert step == 7
    _assert_bitwise(got, want)
    assert got["opt"]["count"].dtype == torch.int32


def test_port_checkpoint_loads_in_reference(tmp_path):
    """The port's save_checkpoint of the converted state, read by the
    reference's load_checkpoint into its own state: bitwise, with the
    same key set in arrays.npz as the reference writes, and step and
    metadata carried."""
    jstate = _jax_dp_state()
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(ref_dir, jstate, step=7,
                             metadata={"arch": "qwen2-smoke"})
    ckpt.save_checkpoint(port_dir, _port_state(jstate), step=7,
                         metadata={"arch": "qwen2-smoke"})
    assert _npz_keys(port_dir) == _npz_keys(ref_dir)
    assert set(_meta(port_dir)["keys"]) == set(_meta(ref_dir)["keys"])
    for key in ("step", "metadata"):
        assert _meta(port_dir)[key] == _meta(ref_dir)[key]
    zeros = jax.tree.map(jnp.zeros_like, jstate)
    got, step = jax_ckpt.load_checkpoint(port_dir, zeros)
    assert step == 7
    for k, w in _np(jstate).items():
        g = _np(got)[k]
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_bf16_checkpoint_round_trips_through_port(tmp_path):
    """nemotron's smoke state on bf16 parameters: written as bf16 bits in
    the reference's raw 2-byte records (never as <u2 numbers), read back
    bitwise with the dtypes kept."""
    jstate = _jax_dp_state("nemotron-4-15b", param_dtype="bfloat16")
    state = _port_state(jstate)
    assert {v.dtype for v in state["params"].values()} == {torch.bfloat16}
    ckpt.save_checkpoint(str(tmp_path), state, step=2)
    with np.load(os.path.join(str(tmp_path), "arrays.npz")) as data:
        kinds = {data[k].dtype.str for k in data.files
                 if k.startswith("params/")}
    assert kinds == {"|V2"}
    got, step = ckpt.load_checkpoint(str(tmp_path), _template(state))
    assert step == 2
    _assert_bitwise(got, state)


def test_port_reads_reference_bf16_checkpoint(tmp_path):
    """A bf16 state the reference wrote (ml_dtypes bf16 arrays, stored as
    raw 2-byte records) loads into the port's bf16 template bitwise."""
    jstate = _jax_dp_state("nemotron-4-15b", param_dtype="bfloat16")
    jax_ckpt.save_checkpoint(str(tmp_path), jstate, step=3)
    want = _port_state(jstate)
    got, step = ckpt.load_checkpoint(str(tmp_path), _template(want))
    assert step == 3
    _assert_bitwise(got, want)


def test_checkpoint_refuses_raw_records_for_a_non_bf16_leaf(tmp_path):
    state = {"w": torch.ones(3, dtype=torch.bfloat16)}
    ckpt.save_checkpoint(str(tmp_path), state)
    with pytest.raises(TypeError, match="bf16"):
        ckpt.load_checkpoint(str(tmp_path), {"w": torch.zeros(3)})


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

CLI = ["--smoke", "--agents", "4", "--walks", "2", "--steps", "3",
       "--batch-per-agent", "2", "--seq", "16", "--device", "cpu",
       "--log-every", "0"]


def test_train_cli_baseline_on_cpu():
    out = train_cli.train(train_cli.parse_args(CLI + ["--baseline"]))
    assert out["device"] == "cpu" and len(out["losses"]) == 3
    assert np.all(np.isfinite(out["losses"])) and out["peak_bytes"] is None


def test_train_cli_checkpoint_loads_back(tmp_path):
    """--checkpoint-dir writes the API-BCD state after the loop, with the
    step count and the arch, and it loads back into the state's shapes
    (each leaf finite, the params moved off their common init)."""
    path = str(tmp_path / "ck")
    out = train_cli.train(train_cli.parse_args(CLI + ["--checkpoint-dir",
                                                      path]))
    assert np.all(np.isfinite(out["losses"]))
    meta = _meta(path)
    assert meta["step"] == 3 and meta["metadata"] == {"arch": "qwen2-smoke"}
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.trainer import init_train_state
    model = build_model(get_smoke(ARCH))
    like = init_train_state(model, TrainConfig(num_agents=4, num_walks=2),
                            torch.Generator().manual_seed(0))
    state, step = ckpt.load_checkpoint(path, like)
    assert step == 3 and set(state) == {"params", "token", "zhat", "gacc"}
    for part, leaves in state.items():
        for k, v in leaves.items():
            assert v.shape == like[part][k].shape and bool(
                torch.isfinite(v).all()), (part, k)
    moved = state["params"]["segments.0.attn.wq"]
    assert not torch.equal(moved, like["params"]["segments.0.attn.wq"])
