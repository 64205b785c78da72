"""The port's tensor parallelism over the "model" axis (`repro_torch.dist.
tensor_parallel`, `dist.serving`) in one process, on the CPU.

The ranks of a model line run as threads here, over `_Line`, an
in-process stand-in for `dist.collectives.Collectives` that sums and
gathers in the line's order as it does (tests/test_torch_serve_mesh.py
runs the real transport across processes). Held:

  * `local_config`, `shard_params` and `gather_params`: the pieces join
    back bitwise, for every dense smoke config and for the reference's
    parameters converted;
  * each rank's arena and pool after a prefill and a decode step are
    `local_shard` of the one-process ones under `cache_shardings` /
    `pool_shardings` (f32, atol 1e-5), and the tokens are the
    one-process tokens;
  * `serve_param_shardings` equals the reference's for every
    architecture at full width on the (1, 2) and (16, 16) meshes;
  * the vocabulary-parallel lookup is the one-process lookup bitwise,
    and `ModelAxis.argmax` breaks ties to the lowest global id;
  * training on the axis: for every dense smoke config (phi-3-vision
    with its patch prefix), with and without a loss mask, the loss and
    every leaf's gradient of `train_loss(axis=)` on the ranks, joined by
    `gather_params`, equal one process's (f32, atol 1e-5), and the
    leaves the axis does not split get bitwise-equal gradients on every
    rank; the vocabulary-parallel cross-entropy (`ModelAxis.nll`) and
    its gradient equal one process's wherever the targets fall;
  * a model axis of 1 changes nothing, and what the module does not
    split raises, naming its ROADMAP item;
  * MoE and MLA (to serve): their leaves split as `param_specs` says
    (experts over the axis, MLA heads with the latents whole) and join
    back bitwise, `local_config` keeps `cfg.moe` and `cfg.mla` whole,
    `init_shard` draws each rank's piece bitwise `shard_params` of the
    whole init without holding it, counts the axis does not divide
    raise naming item 6.1d, and `moe_apply(axis=)` (drops at capacity
    included) and every `mla_*` function on the ranks, summed over the
    axis, equal one process's (f32, atol 1e-5), the latent caches
    whole on every rank;
  * the recurrent families and the encoder-decoder (to serve): every
    leaf of rwkv6, recurrentgemma, whisper (also with a vocabulary of
    515, which stays whole) and phi-3 splits as `param_specs` says and
    joins back bitwise, `init_shard` is `shard_params` of the init
    bitwise, an RWKV6 block, an RG-LRU block and recurrentgemma's MQA
    block (its one kv head whole on both ranks) on the ranks equal one
    process's, their caches the rank's piece, and so do the encoder
    and the decoder's layers; training them on the axis, a shared kv
    head or a whole vocabulary raise naming item 6.1f.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.dist import serving as JDS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import ArchConfig, MLAConfig  # noqa: E402
from repro_torch.dist import serving as DS  # noqa: E402
from repro_torch.dist import tensor_parallel as TP  # noqa: E402
from repro_torch.dist.sharding import (cache_shardings,  # noqa: E402
                                       local_shard, pool_shardings,
                                       shard_shape)
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import stacked_layers  # noqa: E402
from repro_torch.models.model import param_specs  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

DENSE = ("qwen2-0.5b", "qwen3-8b", "internlm2-1.8b", "nemotron-4-15b",
         "phi-3-vision-4.2b")
MP = 2
ATOL = 1e-5


class _Line:
    """One model line of `mp` ranks as threads: each exchange posts this
    rank's tensor, waits for every rank, and reads all of them in the
    line's order, as `Collectives` receives them."""

    def __init__(self, mp):
        self.mp = mp
        self.slots = [None] * mp
        self.barrier = threading.Barrier(mp, timeout=60)

    def comm(self, rank):
        line = self

        class Comm:
            def _exchange(self, t):
                line.slots[rank] = t
                line.barrier.wait()
                got = list(line.slots)
                line.barrier.wait()
                return got

            def all_gather(self, t, axis):
                assert axis == "model"
                return self._exchange(t)

            def all_reduce(self, t, axis):
                assert axis == "model"
                got = self._exchange(t)
                total = got[0].clone()
                for g in got[1:]:
                    total += g
                return total

        return Comm()


def mesh_of(rank, mp=MP):
    return Mesh(("data", "model"), (1, mp), rank=rank)


def run_ranks(fn, mp=MP):
    """[fn(rank, ModelAxis) for each rank], the ranks as threads."""
    line = _Line(mp)
    out, errors = [None] * mp, []

    def one(rank):
        try:
            out[rank] = fn(rank, TP.ModelAxis(line.comm(rank),
                                              mesh_of(rank, mp)))
        except BaseException as e:      # re-raised in the test's thread
            errors.append(e)
            line.barrier.abort()

    threads = [threading.Thread(target=one, args=(r,)) for r in range(mp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------


def _jax_params(cfg_name, **kw):
    jcfg = dataclasses.replace(jax_get_smoke(cfg_name), **kw)
    return params_from_jax(jax_build_model(jcfg).init(
        jax.random.PRNGKey(0)))


@pytest.mark.parametrize("arch", DENSE)
def test_shards_join_back_bitwise(arch):
    cfg = get_smoke(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    local = TP.local_config(cfg, MP)
    assert (local.num_heads, local.num_kv_heads, local.d_ff) == (
        cfg.num_heads // MP, cfg.num_kv_heads // MP, cfg.d_ff // MP)
    assert (local.d_model, local.head_dim, local.vocab_size) == (
        cfg.d_model, cfg.head_dim, cfg.vocab_size)
    pieces = [TP.shard_params(cfg, params, mesh_of(r)) for r in range(MP)]
    # each piece has the shapes of the rank's model (its vocab rows aside)
    want = build_model(local).init(torch.Generator().manual_seed(0))
    for piece in pieces:
        assert set(piece) == set(want)
        for k, v in piece.items():
            shape = tuple(want[k].shape)
            if k in ("embed.table", "head"):
                dim = TP.param_specs(cfg, params)[k].index("model")
                shape = shape[:dim] + (shape[dim] // MP,) + shape[dim + 1:]
            assert tuple(v.shape) == shape, k
    joined = TP.gather_params(cfg, pieces, {"data": 1, "model": MP})
    assert all(torch.equal(joined[k], params[k]) for k in params)


def test_reference_params_shard_and_join_back():
    params = _jax_params("qwen2-0.5b")
    cfg = get_smoke("qwen2-0.5b")
    pieces = [TP.shard_params(cfg, params, mesh_of(r)) for r in range(MP)]
    joined = TP.gather_params(cfg, pieces, {"data": 1, "model": MP})
    assert all(torch.equal(joined[k], params[k]) for k in params)
    # rank 1 holds kv head 1 with its query heads 2 and 3 (G = 2)
    hd = cfg.head_dim
    wq = params["segments.0.attn.wq"]
    assert torch.equal(pieces[1]["segments.0.attn.wq"],
                       wq[..., 2 * hd:4 * hd])
    assert torch.equal(pieces[1]["segments.0.attn.wk"],
                       params["segments.0.attn.wk"][..., hd:2 * hd])


def _tp_serve(cfg, params, prompts, paged, axis=None, mesh=None):
    """Admit `prompts` into slots (one-process: axis None) and run one
    decode step; returns (first tokens, decode logits, next tokens, the
    arena or pool)."""
    model = build_model(cfg) if axis is None else build_model(
        cfg, model_axis=axis)
    if mesh is not None:
        params = TP.shard_params(cfg, params, mesh)
    b = len(prompts)
    if paged:
        bs, nb = 4, 16
        caches = model.init_pool(nb, bs, dtype=torch.float32)
        tables = torch.zeros((b, 4), dtype=torch.int32)
        for i in range(b):
            tables[i] = torch.arange(1 + 4 * i, 5 + 4 * i)
        firsts = []
        for i, p in enumerate(prompts):
            tok, caches = model.prefill_chunk_into_blocks_token(
                params, torch.tensor(p[None]), len(p), 0, tables[i], caches)
            firsts.append(tok)
        lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
        tok_in = torch.stack(firsts)
        logits, _ = model.decode_rows_paged(params, tok_in[:, None], caches,
                                            tables, lengths)
        nxt, caches, _ = model.decode_rows_paged_tokens(
            params, tok_in, caches, tables, lengths)
    else:
        caches = model.init_arena(b, 16, dtype=torch.float32)
        firsts = []
        for i, p in enumerate(prompts):
            tok, caches = model.prefill_into_slot_token(
                params, torch.tensor(p[None]), len(p), i, caches)
            firsts.append(tok)
        pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
        tok_in = torch.stack(firsts)
        logits, _ = model.decode_rows(params, tok_in[:, None],
                                      [{k: v.clone() for k, v in s.items()}
                                       for s in caches], pos)
        nxt, caches, _ = model.decode_rows_tokens(params, tok_in, caches, pos)
    if axis is not None:
        logits = axis.gather_vocab(logits)
    return torch.stack(firsts), logits, nxt, caches


@pytest.mark.parametrize("paged", [False, True], ids=["arena", "pool"])
def test_rank_caches_are_local_shards_of_the_whole(paged):
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"),
                              compute_dtype="float32")
    params = _jax_params("qwen2-0.5b", compute_dtype="float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 8, 3)]
    first, logits, nxt, caches = _tp_serve(cfg, params, prompts, paged)
    ranks = run_ranks(lambda r, axis: _tp_serve(cfg, params, prompts, paged,
                                                axis, mesh_of(r)))
    sizes = {"data": 1, "model": MP}
    specs = (pool_shardings if paged else cache_shardings)(sizes, caches)
    scale = float(logits.abs().max())
    for r, (f_r, l_r, n_r, c_r) in enumerate(ranks):
        assert torch.equal(f_r, first) and torch.equal(n_r, nxt)
        assert float((l_r - logits).abs().max()) <= ATOL * scale
        for seg, seg_r, spec in zip(caches, c_r, specs):
            for name, leaf in seg.items():
                want = local_shard(leaf, spec[name], sizes,
                                   mesh_of(r).coords)
                assert tuple(seg_r[name].shape) == shard_shape(
                    tuple(leaf.shape), spec[name], sizes)
                if name == "ptr":
                    assert torch.equal(seg_r[name], want)
                else:
                    torch.testing.assert_close(seg_r[name], want, rtol=0,
                                               atol=ATOL)


def test_mixed_step_halves_equal_their_standalone_steps_on_the_axis():
    """The overlapped engine's gate on the axis: the mixed step's decode
    rows and prompt token are the standalone steps' (tokens equal,
    decode logits bitwise through the per-half products)."""
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"),
                              compute_dtype="float32")
    params = _jax_params("qwen2-0.5b", compute_dtype="float32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 8)]
    new = rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32)

    def rank(r, axis):
        model = build_model(cfg, model_axis=axis)
        p = TP.shard_params(cfg, params, mesh_of(r))
        arena = model.init_arena(3, 16, dtype=torch.float32)
        toks = []
        for i, pr in enumerate(prompts):
            t, arena = model.prefill_into_slot_token(
                p, torch.tensor(pr[None]), len(pr), i, arena)
            toks.append(t)
        toks.append(torch.tensor(0, dtype=torch.int32))
        toks = torch.stack(toks)
        pos = torch.tensor([5, 8, 0], dtype=torch.int32)
        split = [{k: v.clone() for k, v in s.items()} for s in arena]
        d_toks, split, _ = model.decode_rows_tokens(p, toks, split, pos)
        p_tok, split = model.prefill_into_slot_token(
            p, torch.tensor(new[None]), len(new), 2, split)
        m_toks, arena, _, m_tok = model.mixed_step_tokens(
            p, toks, arena, pos, torch.tensor(new[None]), len(new), 2)
        return d_toks, p_tok, m_toks, m_tok, split, arena

    for d_toks, p_tok, m_toks, m_tok, split, fused in run_ranks(rank):
        assert torch.equal(d_toks[:2], m_toks[:2])
        assert torch.equal(p_tok, m_tok)
        for a, b in zip(split, fused):
            assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# the reference's serving specs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_shapes():
    return {}


def _ref_flat(shardings, shapes):
    flat_sh = jax.tree_util.tree_flatten_with_path(shardings)[0]
    flat_shape = jax.tree_util.tree_leaves(shapes)
    out = {}
    for (path, sh), leaf in zip(flat_sh, flat_shape):
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        spec = tuple(sh.spec)
        out[key] = spec + (None,) * (len(leaf.shape) - len(spec))
    return out


@pytest.mark.parametrize("sizes", [(1, 2), (16, 16)], ids=["1x2", "16x16"])
@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_serve_param_shardings_equal_the_reference(arch, sizes, ref_shapes):
    if arch not in ref_shapes:
        ref_shapes[arch] = jax.eval_shape(
            jax_build_model(jax_get_config(arch)).init,
            jax.random.PRNGKey(0))
    jshapes = ref_shapes[arch]
    names = ("data", "model")
    want = _ref_flat(JDS.serve_param_shardings(AbstractMesh(sizes, names),
                                               jshapes), jshapes)
    with FakeTensorMode() as mode:
        shapes = param_specs(get_config(arch), mode)
        got = DS.serve_param_shardings(Mesh(names, sizes), shapes)
    assert got == want
    assert DS.data_axes(Mesh(names, sizes)) == ("data",)


# ---------------------------------------------------------------------------
# the axis's collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vocab_parallel_lookup_is_the_lookup_bitwise(dtype):
    vocab, d = 64, 16
    table = torch.randn((vocab, d), generator=torch.Generator().manual_seed(0)
                        ).to(dtype)
    tokens = torch.tensor([[0, 31, 32, 63, 5, 40, 32]])
    want = torch.nn.functional.embedding(tokens, table)
    got = run_ranks(lambda r, axis: axis.embed(
        table[r * vocab // MP:(r + 1) * vocab // MP], tokens))
    for g in got:
        assert g.dtype == dtype and torch.equal(g, want)


@pytest.mark.parametrize("case", ["across_ranks", "within_rank", "all_equal",
                                  "random"])
def test_argmax_breaks_ties_to_the_lowest_global_id(case):
    vocab = 12
    logits = torch.randn((4, vocab), generator=torch.Generator().manual_seed(1))
    if case == "across_ranks":
        logits[:, 8] = logits[:, 3] = 10.0      # rank 1's and rank 0's
    elif case == "within_rank":
        logits[:, 9] = logits[:, 7] = 10.0      # both on rank 1
    elif case == "all_equal":
        logits[:] = 1.0
    want = torch.argmax(logits, -1).to(torch.int32)
    per = vocab // MP
    got = run_ranks(lambda r, axis: axis.argmax(
        logits[:, r * per:(r + 1) * per]))
    for g in got:
        assert g.dtype == torch.int32 and torch.equal(g, want)


def test_serve_step_sends_counts_every_sum_and_pick():
    """Each step sums the embedding in bf16 and each layer's two products
    in f32 (10 B an element here), then gathers a (value, id) f32 pair a
    greedy row. On a line of 2 a rank sends its whole tensor; on a line
    of 3 the other ranks' pieces of the flat tensor, then its own to
    each of them (`Collectives.all_reduce`). The vocabulary, 510, divides
    over both lines (one the axis does not divide is whole: no embedding
    sum, no pick)."""
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"), num_layers=1,
                              layer_types=("attn",), d_model=5,
                              vocab_size=510)
    # elements a step (rows x d_model), and the line of 3's pieces
    steps = {"decode": (10, (4, 3, 3), 2), "admission": (20, (7, 7, 6), 1),
             "mixed": (30, (10, 10, 10), 3)}
    for mp in (2, 3):
        sends = DS.serve_step_sends(cfg, {"data": 1, "model": mp}, 2, 4)
        assert len(sends) == mp
        for i, rank in enumerate(sends):
            for step, (n, pieces, picks) in steps.items():
                elems = n if mp == 2 else n + pieces[i]
                assert rank[step] == {"all_reduce": (2 + 2 * 4) * elems,
                                      "all_gather": (mp - 1) * picks * 8}
            # a first token is gathered over the data axes only
            assert rank["first_token"] == {}
    assert DS.serve_step_sends(cfg, {"data": 1, "model": 1}, 2, 4) == [
        {"decode": {}, "admission": {}, "mixed": {}, "first_token": {},
         "wave_prefill": {}, "wave_decode": {}}]


# ---------------------------------------------------------------------------
# training on the axis
# ---------------------------------------------------------------------------


def _train_batch(cfg, mask, b=2, s=8):
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (b, s))),
             "targets": torch.tensor(rng.integers(0, cfg.vocab_size,
                                                  (b, s)))}
    if mask:
        keep = np.zeros((b, s), np.float32)
        keep[0, :3] = keep[1:, :s - 2] = 1.0
        batch["loss_mask"] = torch.from_numpy(keep)
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32))
    return batch


def _loss_and_grads(model, params, batch):
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, metrics = model.train_loss(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics["nll"].detach(), dict(zip(leaves, grads))


@pytest.mark.parametrize("mask", [False, True], ids=["all", "loss_mask"])
@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_gradients_on_the_axis_equal_one_process(arch, mask):
    """The loss and every leaf's gradient on mp = 2 ranks: the ranks'
    losses are bitwise equal, within atol 1e-5 of one process's, and the
    gradients, joined by `gather_params`, within atol 1e-5 of one
    process's gradient of the whole params (qwen3's qk-norm scales, which
    act on each rank's heads, included); the leaves the axis does not
    split get bitwise-equal gradients on both ranks."""
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32",
                              param_dtype="float32")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    batch = _train_batch(cfg, mask)
    loss, nll, grads = _loss_and_grads(build_model(cfg), params, batch)
    ranks = run_ranks(lambda r, axis: _loss_and_grads(
        build_model(cfg, model_axis=axis),
        TP.shard_params(cfg, params, mesh_of(r)), batch))
    for r_loss, r_nll, _ in ranks:
        assert torch.equal(r_loss, ranks[0][0])
        assert float((r_loss - loss).abs()) <= ATOL
        assert float((r_nll - nll).abs()) <= ATOL
    specs = TP.param_specs(cfg, params)
    for k, spec in specs.items():
        if "model" not in spec:
            assert torch.equal(ranks[0][2][k], ranks[1][2][k]), k
    joined = TP.gather_params(cfg, [g for *_, g in ranks],
                              {"data": 1, "model": MP})
    assert set(joined) == set(grads)
    for k, g in grads.items():
        torch.testing.assert_close(joined[k], g, rtol=0, atol=ATOL,
                                   msg=k)


@pytest.mark.parametrize("where", ["rank0", "rank1", "both"])
def test_vocab_parallel_nll_equals_the_cross_entropy(where):
    """`ModelAxis.nll` on each rank's half of the vocabulary equals the
    one-process cross-entropy (train_loss's max-shifted log-sum-exp less
    the target's logit), and so does its gradient of the logits, with
    every target on rank 0's half, on rank 1's, or on both."""
    vocab = 16
    gen = torch.Generator().manual_seed(2)
    logits = torch.randn((3, 5, vocab), generator=gen) * 4
    half = vocab // MP
    lo, hi = {"rank0": (0, half), "rank1": (half, vocab),
              "both": (0, vocab)}[where]
    targets = torch.randint(lo, hi, (3, 5), generator=gen)
    if where == "both":
        targets[0, 0], targets[0, 1] = 0, vocab - 1

    def one(x):
        m = x.amax(dim=-1).detach()
        logz = m + torch.log(torch.sum(torch.exp(x - m[..., None]), dim=-1))
        return logz - torch.gather(x, -1, targets[..., None])[..., 0]

    x = logits.clone().requires_grad_()
    want = one(x)
    (want_grad,) = torch.autograd.grad(want.sum(), x)

    def rank(r, axis):
        piece = logits[..., r * half:(r + 1) * half].clone().requires_grad_()
        nll = axis.nll(piece, targets)
        (g,) = torch.autograd.grad(nll.sum(), piece)
        return nll.detach(), g

    got = run_ranks(rank)
    for nll, _ in got:
        torch.testing.assert_close(nll, want.detach(), rtol=0, atol=ATOL)
    torch.testing.assert_close(torch.cat([g for _, g in got], dim=-1),
                               want_grad, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# a model axis of 1, and the refusals
# ---------------------------------------------------------------------------


def test_a_model_axis_of_one_changes_nothing():
    cfg = get_smoke("qwen2-0.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    one = Mesh(("data", "model"), (1, 1), rank=0)
    assert TP.local_config(cfg, 1) is cfg
    assert TP.shard_params(cfg, params, one) is params
    assert TP.model_axis(one, comm=None) is None
    assert DS.local_model(model, one, comm=None) is model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 9, 3)]

    def serve(**kw):
        eng = Engine(model, params, max_batch=2, max_len=32, **kw)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        return eng, {r.uid: r.output.tolist() for r in eng.run()}

    eng, got = serve(mesh=one)
    assert eng.comm is None
    assert got == serve()[1]


@pytest.mark.parametrize("arch,mp", [
    ("qwen2-0.5b", 4),              # 2 kv heads over 4 ranks
    ("dbrx-132b", 2), ("deepseek-v2-236b", 2), ("rwkv6-1.6b", 2),
    ("recurrentgemma-2b", 2), ("whisper-small", 2)])
def test_what_the_axis_does_not_split_raises(arch, mp):
    cfg = get_config(arch)
    axis = TP.ModelAxis(None, Mesh(("data", "model"), (1, mp), rank=0))
    if arch != "qwen2-0.5b":
        # MoE, MLA, the recurrent families and the encoder-decoder serve
        # on the axis at full width; training them there raises, naming
        # its item
        assert build_model(cfg, model_axis=axis).cfg == TP.local_config(
            cfg, mp)
        item = "6.1e" if cfg.moe is not None else "6.1f"
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            TP.check_tensor_parallel(cfg, mp, training=True)
        return
    # 14 query heads over 4 ranks
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6.1"):
        TP.local_config(cfg, mp)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6.1"):
        build_model(cfg, model_axis=axis)


def test_a_data_axis_and_training_raise():
    # a data axis serves (tests/test_torch_serve_mesh_data.py): a rank's
    # model axis is its model line, whatever its data coordinate, and a
    # data-only mesh has none
    axis = TP.model_axis(Mesh(("data", "model"), (2, 2), rank=3), comm=None)
    assert isinstance(axis, TP.ModelAxis)
    assert (axis.size, axis.index) == (2, 1)
    assert TP.model_axis(Mesh(("data", "model"), (2, 1), rank=1),
                         comm=None) is None
    cfg = get_smoke("qwen2-0.5b")
    model = build_model(cfg)
    eng = Engine(model, model.init(torch.Generator().manual_seed(0)),
                 max_batch=2, max_len=16,
                 mesh=Mesh(("data", "model"), (2, 1), rank=0))
    assert eng.rows.size == 2 and eng.comm is not None
    # training on the axis: the dense stack trains (both ranks report
    # the one loss); the families the axis does not split raise, naming
    # their ROADMAP item
    params = model.init(torch.Generator().manual_seed(0))
    batch = _train_batch(cfg, mask=False)
    losses = run_ranks(lambda r, axis: build_model(
        cfg, model_axis=axis).train_loss(TP.shard_params(
            cfg, params, mesh_of(r)), batch)[0])
    assert torch.equal(losses[0], losses[1])
    assert torch.isfinite(losses[0])
    axis = TP.ModelAxis(None, mesh_of(0))
    # the recurrent families and the encoder-decoder build on the axis to
    # serve; their training raises
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b", "whisper-small"):
        rec_cfg = get_smoke(arch)
        pieces = TP.init_shard(rec_cfg, torch.Generator().manual_seed(0),
                               mesh_of(0))
        with pytest.raises(NotImplementedError, match="item 6.1f"):
            build_model(rec_cfg, model_axis=axis).train_loss(
                pieces, _train_batch(rec_cfg, mask=False))
    # MoE and MLA build on the axis to serve; their training raises
    for arch in ("dbrx-132b", "deepseek-v2-236b"):
        moe_cfg = get_smoke(arch)
        pieces = TP.init_shard(moe_cfg, torch.Generator().manual_seed(0),
                               mesh_of(0))
        with pytest.raises(NotImplementedError, match="item 6.1e"):
            build_model(moe_cfg, model_axis=axis).train_loss(
                pieces, _train_batch(moe_cfg, mask=False))
    params = dict(params)
    params["segments.0.attn.bo"] = torch.zeros((cfg.num_layers,
                                                cfg.d_model))
    with pytest.raises(NotImplementedError, match="attn.bo"):
        TP.param_specs(cfg, params)


@pytest.mark.parametrize("paged", [False, True], ids=["arena", "pool"])
def test_step_builders_serve_the_one_process_tokens(paged):
    """The rank-local steps (the entry points of `dist.serving.
    local_model`, which stand for the reference's step builders) over the
    rank's shard (`serving_params`) and caches: an admission, a decode
    step and a mixed step give the one-process tokens."""
    cfg = dataclasses.replace(get_smoke("qwen2-0.5b"),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = _jax_params("qwen2-0.5b", compute_dtype="float32")
    rng = np.random.default_rng(2)
    a, b = (torch.tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                         dtype=torch.int32) for n in (8, 4))
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)

    def serve(mesh=None, comm=None):
        steps = model if mesh is None else DS.local_model(model, mesh, comm)
        p = TP.serving_params(cfg, params, mesh)
        if paged:
            prefill = steps.prefill_chunk_into_blocks_token
            decode = steps.decode_rows_paged_tokens
            mixed = steps.mixed_step_paged_tokens
            pool = steps.init_pool(4, 8, dtype=torch.float32)
            first, pool = prefill(p, a, 8, 0, tables[0], pool)
            toks = torch.stack([first, torch.tensor(0, dtype=torch.int32)])
            live = tables * torch.tensor([[1], [0]], dtype=torch.int32)
            lengths = torch.tensor([8, 0], dtype=torch.int32)
            nxt, pool, lengths = decode(p, toks, pool, live, lengths)
            m_toks, pool, _, c_tok = mixed(p, nxt, pool, live, lengths, b, 4,
                                           0, tables[1])
        else:
            prefill = steps.prefill_into_slot_token
            decode = steps.decode_rows_tokens
            mixed = steps.mixed_step_tokens
            arena = steps.init_arena(2, 16, dtype=torch.float32)
            first, arena = prefill(p, a, 8, 0, arena)
            toks = torch.stack([first, torch.tensor(0, dtype=torch.int32)])
            pos = torch.tensor([8, 0], dtype=torch.int32)
            nxt, arena, pos = decode(p, toks, arena, pos)
            m_toks, arena, _, c_tok = mixed(p, nxt, arena, pos, b, 4, 1)
        return first, nxt[0], m_toks[0], c_tok

    want = serve()
    for got in run_ranks(lambda r, axis: serve(mesh_of(r), axis.comm)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# MoE and MLA on the axis (serving)
# ---------------------------------------------------------------------------

FAMILY_CFGS = {
    "dbrx": get_smoke("dbrx-132b"),
    "deepseek": get_smoke("deepseek-v2-236b"),
    # tests/test_server.py's dense MLA stack
    "mla": ArchConfig(name="mla-overlap-t", family="dense", source="test",
                      num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                      d_ff=128, vocab_size=256, tie_embeddings=True,
                      mla=MLAConfig(kv_lora_rank=16, q_lora_rank=32,
                                    qk_nope_head_dim=16, qk_rope_head_dim=8,
                                    v_head_dim=16)),
}
# the split dim of each MoE and MLA leaf below its segment (None: whole)
FAMILY_SPLIT = {
    "attn.wq_a": None, "attn.q_norm.scale": None, "attn.wkv_a": None,
    "attn.kv_norm.scale": None, "attn.wq_b": 2, "attn.wk_b": 2,
    "attn.wv_b": 2, "attn.wo": 1, "moe.router": None, "moe.w_gate": 1,
    "moe.w_up": 1, "moe.w_down": 1, "moe.shared.w_gate": 2,
    "moe.shared.w_up": 2, "moe.shared.w_down": 1}


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


@pytest.mark.parametrize("family", list(FAMILY_CFGS))
def test_moe_and_mla_leaves_split_and_join_back_bitwise(family):
    cfg = FAMILY_CFGS[family]
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    specs = TP.param_specs(cfg, params)
    seen = set()
    for key, spec in specs.items():
        leaf = key.split(".", 2)[-1]
        if leaf in FAMILY_SPLIT:
            dim = FAMILY_SPLIT[leaf]
            assert spec == tuple("model" if d == dim else None
                                 for d in range(params[key].dim())), key
            seen.add(leaf)
    want = {"attn.wq_b", "attn.wk_b", "attn.wv_b", "attn.wq_a",
            "attn.wkv_a"} if cfg.mla is not None else set()
    if cfg.moe is not None:
        want |= {"moe.router", "moe.w_gate", "moe.w_up", "moe.w_down"}
        if cfg.moe.num_shared_experts:
            want |= {"moe.shared.w_gate", "moe.shared.w_up",
                     "moe.shared.w_down"}
    assert want <= seen
    local = TP.local_config(cfg, MP)
    # routing and capacity run over every expert; the latents stay whole
    assert local.moe == cfg.moe and local.mla == cfg.mla
    assert local.num_heads == cfg.num_heads // MP
    pieces = [TP.shard_params(cfg, params, mesh_of(r)) for r in range(MP)]
    for r, piece in enumerate(pieces):
        if cfg.moe is not None:
            e = cfg.moe.num_experts // MP
            assert piece["segments.0.moe.w_gate"].shape[1] == e
            assert torch.equal(piece["segments.0.moe.w_down"],
                               params["segments.0.moe.w_down"][
                                   :, r * e:(r + 1) * e])
        if cfg.mla is not None:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            h = local.num_heads
            assert torch.equal(piece["segments.0.attn.wq_b"],
                               params["segments.0.attn.wq_b"][
                                   ..., r * h * qk:(r + 1) * h * qk])
            assert torch.equal(piece["segments.0.attn.wkv_a"],
                               params["segments.0.attn.wkv_a"])
    joined = TP.gather_params(cfg, pieces, {"data": 1, "model": MP})
    assert all(torch.equal(joined[k], params[k]) for k in params)


@pytest.mark.parametrize("family", ["dbrx", "deepseek", "mla", "qwen2",
                                    "dbrx-bf16"])
def test_init_shard_is_shard_params_of_the_init_bitwise(family):
    cfg = (get_smoke("qwen2-0.5b") if family == "qwen2" else
           FAMILY_CFGS[family.split("-")[0]])
    if family.endswith("bf16"):
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    whole = build_model(cfg).init(torch.Generator().manual_seed(0))
    # a model line of a (2, 2) mesh: the data coordinate changes nothing
    for mesh in [mesh_of(r) for r in range(MP)] + [
            Mesh(("data", "model"), (2, MP), rank=3)]:
        got = TP.init_shard(cfg, torch.Generator().manual_seed(0), mesh)
        want = TP.shard_params(cfg, whole, mesh)
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
            # a piece of its own, not a view of a whole leaf
            assert v.untyped_storage().nbytes() == v.numel() * v.itemsize
        assert TP.is_piece(cfg, got, mesh)
        assert not TP.is_piece(cfg, whole, mesh)
        served = TP.serving_params(cfg, got, mesh)
        assert all(torch.equal(served[k], v) for k, v in
                   TP.serving_params(cfg, whole, mesh).items())
    with pytest.raises(ValueError, match="neither"):
        TP.is_piece(cfg, {**whole, "embed.table": whole["embed.table"][1:]},
                    mesh_of(0))


@pytest.mark.parametrize("case", ["experts", "shared_width", "mla_heads"])
def test_undivided_moe_and_mla_counts_raise(case):
    if case == "experts":
        base = get_smoke("dbrx-132b")
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, num_experts=3))
        what = "num_experts 3"
    elif case == "shared_width":
        base = get_smoke("deepseek-v2-236b")
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, d_ff_expert=63))
        what = "shared experts' width 63"
    else:
        cfg = dataclasses.replace(get_smoke("deepseek-v2-236b"),
                                  num_heads=3, num_kv_heads=3)
        what = "3 query and 3 kv heads"
    with pytest.raises(NotImplementedError, match="item 6.1d") as err:
        TP.local_config(cfg, MP)
    assert what in str(err.value)


def _moe_layer(params):
    return stacked_layers(params, "segments.0", 2)[0]["moe"]


@pytest.mark.parametrize("scatter", [False, True], ids=["grouped",
                                                        "scatter"])
@pytest.mark.parametrize("family", ["dbrx", "deepseek"])
def test_moe_apply_on_the_axis_equals_one_process(family, scatter):
    """Each rank runs its experts' buckets of a batch whose routing drops
    slots at capacity; the sum over the axis is one process's output."""
    cfg = _f32(FAMILY_CFGS[family])
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    # tokens near one common row, so the router sends most of them to
    # the same experts
    g = torch.Generator().manual_seed(1)
    x = (torch.randn((cfg.d_model,), generator=g)
         + 0.5 * torch.randn((2, 24, cfg.d_model), generator=g))
    fn = MOE.moe_apply_scatter if scatter else MOE.moe_apply
    layer = _moe_layer(params)
    want, _ = fn(layer, cfg, x, with_aux=False)
    # the batch drops slots at capacity
    _, _, gate_i = MOE.route(layer, cfg, x)
    if scatter:
        counts = MOE._one_hot(gate_i.reshape(-1), cfg.moe.num_experts).sum(0)
        cap = MOE.capacity(cfg, x.shape[0] * x.shape[1])
        assert int((counts - cap).clamp_min(0).sum()) > 0
    else:
        pos = MOE.bucket_positions(gate_i, cfg.moe.num_experts)
        assert int((pos >= MOE.capacity(cfg, x.shape[1])).sum()) > 0
    local = TP.local_config(cfg, MP)
    got = run_ranks(lambda r, axis: fn(
        _moe_layer(TP.shard_params(cfg, params, mesh_of(r))), local, x,
        with_aux=False, axis=axis)[0])
    assert torch.equal(got[0], got[1])
    scale = float(want.abs().max())
    assert float((got[0] - want).abs().max()) <= ATOL * scale


def _mla_case(fn, cfg, params, product=torch.matmul):
    """`attention.mla_<fn>` of layer 0 on fixed inputs (seeded caches, a
    pool with block 0 the null block): (its output, its cache)."""
    m = cfg.mla
    g = torch.Generator().manual_seed(4)
    d, r, rope = cfg.d_model, m.kv_lora_rank, m.qk_rope_head_dim
    lp = stacked_layers(params, "segments.0", cfg.num_layers)[0]["attn"]

    def arena(b, t):
        return {"ckv": torch.randn((b, t, r), generator=g),
                "kpe": torch.randn((b, t, rope), generator=g),
                "ptr": torch.tensor([5, 3], dtype=torch.int32)[:b]}

    def pool(nb, bs):
        return {"ckv": torch.randn((nb, bs, r), generator=g),
                "kpe": torch.randn((nb, bs, rope), generator=g)}

    def x(b, s):
        return torch.randn((b, s, d), generator=g)

    tables = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    lengths = torch.tensor([6, 9], dtype=torch.int32)
    if fn == "prefill":
        out, entries = A.mla_prefill(lp, cfg, x(2, 6),
                                     torch.arange(6)[None].expand(2, 6),
                                     product=product)
        return out, dict(zip(("ckv", "kpe"), entries))
    if fn == "decode":
        cache = arena(2, 8)
        return A.mla_decode(lp, cfg, x(2, 1), cache,
                            cache["ptr"].reshape(2, 1).long(),
                            product=product)
    if fn == "prefill_paged":
        return A.mla_prefill_paged(lp, cfg, x(1, 4), pool(8, 4),
                                   torch.tensor([7, 1, 2], dtype=torch.int32),
                                   5, product=product)
    if fn == "decode_paged":
        return A.mla_decode_paged(lp, cfg, x(2, 1), pool(8, 4), tables,
                                  lengths, product=product)
    pos_d = torch.tensor([[5, 3]])
    pos_p = torch.arange(4)[None]
    if fn == "mixed":
        cache = arena(2, 8)
        return A.mla_mixed(lp, cfg, x(1, 6), 2, pos_d, pos_p, cache, 4, 1,
                           product=product)
    return A.mla_mixed_paged(lp, cfg, x(1, 6), 2, pos_d, pos_p, pool(8, 4),
                             tables, lengths, 2,
                             torch.tensor([7, 0, 0], dtype=torch.int32),
                             product=product)


@pytest.mark.parametrize("fn", ["prefill", "decode", "prefill_paged",
                                "decode_paged", "mixed", "mixed_paged"])
@pytest.mark.parametrize("family", ["deepseek", "mla"])
def test_mla_functions_on_the_axis_equal_one_process(family, fn):
    """A rank's heads over the whole latents: the output summed over the
    axis is one process's, and every rank's latent cache is one
    process's whole cache."""
    cfg = _f32(FAMILY_CFGS[family])
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    want, want_cache = _mla_case(fn, cfg, params)
    local = TP.local_config(cfg, MP)
    got = run_ranks(lambda r, axis: (lambda out, cache: (
        axis.reduce(out), cache))(*_mla_case(
            fn, local, TP.shard_params(cfg, params, mesh_of(r)),
            axis.row_product)))
    scale = float(want.abs().max())
    for out, cache in got:
        assert out.dtype == torch.float32
        assert float((out - want).abs().max()) <= ATOL * scale
        for name in ("ckv", "kpe"):
            assert torch.equal(cache[name], want_cache[name]), name


# ---------------------------------------------------------------------------
# the recurrent families and the encoder-decoder on the axis (serving)
# ---------------------------------------------------------------------------

RECURRENT_CFGS = {
    "rwkv6": get_smoke("rwkv6-1.6b"),
    # MQA: its one kv head on both ranks, 1 query head each
    "recurrentgemma": get_smoke("recurrentgemma-2b"),
    "whisper": get_smoke("whisper-small"),
    # a vocabulary the axis does not divide: the table and head whole
    "whisper515": dataclasses.replace(get_smoke("whisper-small"),
                                      vocab_size=515),
    "phi3": get_smoke("phi-3-vision-4.2b"),
}
# the split dim of every leaf of these families by its name below its
# segment or stack (None: whole on every rank)
RECURRENT_SPLIT = {
    **{f"mix.mu.{n}": None for n in "rkvgw"}, "mix.wr": 2, "mix.wk": 2,
    "mix.wv": 2, "mix.wg": 2, "mix.w0": 1, "mix.w_lora_a": None,
    "mix.w_lora_b": 2, "mix.u": 1, "mix.ln_out_scale": 1, "mix.wo": 1,
    "mix.cm_mu.r": None, "mix.cm_mu.k": None, "mix.cm_wr": None,
    "mix.cm_wk": 2, "mix.cm_wv": 1,
    "rnn.w_x": None, "rnn.conv_kernel": None, "rnn.conv_bias": None,
    "rnn.w_a": 2, "rnn.w_i": 2, "rnn.b_a": 1, "rnn.b_i": 1, "rnn.lamb": 1,
    "rnn.w_y": 2, "rnn.w_out": 1,
    "attn.wq": 2, "attn.wk": 2, "attn.wv": 2, "attn.wo": 1,
    "self.wq": 2, "self.wk": 2, "self.wv": 2, "self.wo": 1,
    "cross.wq": 2, "cross.wk": 2, "cross.wv": 2, "cross.wo": 1,
    "mlp.w_gate": 2, "mlp.w_up": 2, "mlp.w_down": 1,
    **{f"{n}.{leaf}": None for n in ("ln1", "ln2", "ln_x")
       for leaf in ("scale", "bias")},
    "final_norm.scale": None, "final_norm.bias": None,
    "enc_norm.scale": None, "enc_norm.bias": None,
    "embed.table": 0, "head": 1,
}


def _leaf_name(key):
    parts = key.split(".")
    if parts[0] == "segments":
        return ".".join(parts[2:])
    if parts[0] in ("encoder", "decoder"):
        return ".".join(parts[1:])
    return key


@pytest.mark.parametrize("family", list(RECURRENT_CFGS))
def test_recurrent_and_encdec_leaves_split_and_join_back_bitwise(family):
    cfg = RECURRENT_CFGS[family]
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    specs = TP.param_specs(cfg, params, MP)
    assert set(specs) == set(params)
    for key, spec in specs.items():
        dim = RECURRENT_SPLIT[_leaf_name(key)]
        if key in ("embed.table", "head") and cfg.vocab_size % MP:
            dim = None
        assert spec == tuple("model" if d == dim else None
                             for d in range(params[key].dim())), key
    local = TP.local_config(cfg, MP)
    assert (local.d_model, local.vocab_size, local.head_dim) == (
        cfg.d_model, cfg.vocab_size, cfg.head_dim)
    assert local.num_kv_heads == max(cfg.num_kv_heads // MP, 1)
    pieces = [TP.shard_params(cfg, params, mesh_of(r)) for r in range(MP)]
    for r, piece in enumerate(pieces):
        if family == "rwkv6":
            h = cfg.d_model // cfg.rwkv_head_dim // MP
            assert torch.equal(piece["segments.0.mix.u"],
                               params["segments.0.mix.u"][:, r * h:(r + 1) * h])
        if family == "recurrentgemma":
            # the one kv head whole on each rank, the RG-LRU's channels
            # split, w_x and the conv whole
            for leaf in ("segments.1.attn.wk", "segments.1.attn.wv",
                         "segments.0.rnn.w_x", "segments.0.rnn.conv_kernel"):
                assert torch.equal(piece[leaf], params[leaf]), leaf
            w = cfg.rnn_width // MP
            assert torch.equal(piece["segments.0.rnn.lamb"],
                               params["segments.0.rnn.lamb"][
                                   :, r * w:(r + 1) * w])
        if family == "whisper515":
            for leaf in ("embed.table", "head"):
                assert torch.equal(piece[leaf], params[leaf])
    joined = TP.gather_params(cfg, pieces, {"data": 1, "model": MP})
    assert all(torch.equal(joined[k], params[k]) for k in params)


@pytest.mark.parametrize("family", list(RECURRENT_CFGS))
def test_recurrent_and_encdec_init_shard_is_shard_params_bitwise(family):
    cfg = RECURRENT_CFGS[family]
    whole = build_model(cfg).init(torch.Generator().manual_seed(0))
    for mesh in [mesh_of(r) for r in range(MP)] + [
            Mesh(("data", "model"), (2, MP), rank=3)]:
        got = TP.init_shard(cfg, torch.Generator().manual_seed(0), mesh)
        want = TP.shard_params(cfg, whole, mesh)
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
            assert v.untyped_storage().nbytes() == v.numel() * v.itemsize
        assert TP.is_piece(cfg, got, mesh)
        assert not TP.is_piece(cfg, whole, mesh)
    # a mix of whole leaves and pieces is neither
    mixed = dict(got)
    key = "segments.0.mlp.w_down" if family == "recurrentgemma" else next(
        k for k, s in TP.param_specs(cfg, whole, MP).items()
        if "model" in s)
    mixed[key] = whole[key]
    with pytest.raises(ValueError, match="some leaves are whole"):
        TP.is_piece(cfg, mixed, mesh_of(0))


def _on_ranks(fn, cfg, params):
    """(one process's fn(cfg, params, None), each rank's fn(local config,
    its piece, its ModelAxis))."""
    want = fn(cfg, params, None)
    got = run_ranks(lambda r, axis: fn(
        TP.local_config(cfg, MP), TP.shard_params(cfg, params, mesh_of(r)),
        axis))
    return want, got


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= ATOL * scale


def _block_run(kind):
    """A function (cfg, params, axis) -> (prefill out, decode out, cache
    leaves) of layer 0 of a `kind` segment: a prefill of 6 tokens over 2
    rows (recurrentgemma's MQA layer: 40, past its 32-token window), then
    a decode step, from a zero cache of the rank's widths."""
    from repro_torch.models import transformer as TF

    def run(cfg, params, axis):
        parts = 1 if axis is None else MP
        si = [k for k, _ in TF.segments(cfg)].index(kind)
        s = 40 if kind == "attn" else 6
        g = torch.Generator().manual_seed(5)
        x = torch.randn((2, s, cfg.d_model), generator=g)
        x1 = torch.randn((2, 1, cfg.d_model), generator=g)
        caches = TF.init_cache(cfg, 2, 64, dtype=torch.float32, parts=parts)
        seg = caches[si]
        lp = stacked_layers(params, f"segments.{si}", 1 if kind == "attn"
                            else 2)[0]
        if kind == "rwkv":
            out = TF._rwkv_block(cfg, lp, x, seg, 0, axis)
            dec = TF._rwkv_block(cfg, lp, x1, seg, 0, axis)
        elif kind == "rglru":
            out = TF._rglru_block(cfg, lp, x, seg, 0, axis)
            dec = TF._rglru_block(cfg, lp, x1, seg, 0, axis)
        else:
            pos = torch.arange(s)[None].expand(2, s)
            out = TF._attn_block(cfg, lp, x, pos, "prefill", seg, 0, None,
                                 cfg.attn_window, axis)
            seg["ptr"] = seg["ptr"][:, None].expand(-1, 2).contiguous()
            dec = TF._attn_block(cfg, lp, x1, torch.full((2, 1), s), "decode",
                                 seg, 0, None, cfg.attn_window, axis)
        return out, dec, {k: v[0] for k, v in seg.items() if k != "ptr"}

    return run


@pytest.mark.parametrize("kind,family", [("rwkv", "rwkv6"),
                                         ("rglru", "recurrentgemma"),
                                         ("attn", "recurrentgemma")])
def test_recurrent_blocks_on_the_axis_equal_one_process(kind, family):
    """A rank's RWKV6 heads, RG-LRU channels or MQA query heads (over the
    one kv head it holds whole) in f32: the block's prefill and decode
    outputs are one process's, and its cache is the rank's piece of one
    process's (the WKV state's heads, h's channels; the shifts, the conv
    state and the one kv head's K/V whole)."""
    cfg = _f32(RECURRENT_CFGS[family])
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    want, got = _on_ranks(_block_run(kind), cfg, params)
    split = {"wkv": 1, "h": 1}
    for r, (out, dec, cache) in enumerate(got):
        _close(out, want[0])
        _close(dec, want[1])
        for name, leaf in cache.items():
            whole = want[2][name]
            if name in split:
                n = leaf.shape[split[name]]
                whole = whole.narrow(split[name], r * n, n)
            assert leaf.shape == whole.shape, name
            torch.testing.assert_close(leaf, whole, rtol=0,
                                       atol=ATOL * float(whole.abs().max()))


@pytest.mark.parametrize("family", ["whisper", "whisper515"])
def test_encoder_and_decoder_layers_on_the_axis_equal_one_process(family):
    """The encoder (its heads' non-causal attention and MLP, two sums a
    layer) and the decoder's layers (self-attention, cross-attention and
    MLP, three sums a layer) on 2 ranks in f32: a prefill's and a decode
    step's logits are one process's, and each rank's caches are its
    heads' piece of one process's."""
    from repro_torch.models import encdec as ED

    cfg = _f32(RECURRENT_CFGS[family])
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(6)
    batch = {"frames": torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                   generator=g),
             "tokens": torch.randint(0, cfg.vocab_size, (2, 5), generator=g)}

    def run(c, p, axis):
        enc = ED.encode(c, p, batch["frames"], kernel=True, axis=axis)
        logits, caches = ED.prefill(c, p, batch, cache_len=8,
                                    cache_dtype=torch.float32, axis=axis)
        step, caches = ED.decode_step(c, p, batch["tokens"][:, :1], caches,
                                      5, axis=axis)
        if axis is not None and logits.shape[-1] != cfg.vocab_size:
            logits, step = axis.gather_vocab(logits), axis.gather_vocab(step)
        return enc, logits, step, caches

    want, got = _on_ranks(run, cfg, params)
    h = cfg.num_heads // MP
    for r, (enc, logits, step, caches) in enumerate(got):
        for a, b in zip((enc, logits, step), want[:3]):
            assert a.shape == b.shape
            _close(a, b)
        for name in ("k", "v", "ek", "ev"):
            whole = want[3][name][..., r * h:(r + 1) * h, :]
            torch.testing.assert_close(caches[name], whole, rtol=0,
                                       atol=ATOL * float(whole.abs().max()))


def test_whole_vocabulary_and_shared_kv_head_refuse_training():
    """A kv head shared by ranks and a whole vocabulary serve but do not
    train on the axis (item 6.1f), also in a dense stack; counts 6.1d
    still lists raise."""
    dense = get_smoke("qwen2-0.5b")
    for cfg in (dataclasses.replace(dense, num_kv_heads=1),
                dataclasses.replace(dense, vocab_size=511)):
        TP.check_tensor_parallel(cfg, MP)
        with pytest.raises(NotImplementedError, match="item 6.1f"):
            TP.check_tensor_parallel(cfg, MP, training=True)
    # 3 kv heads over 2 ranks, an RG-LRU width and RWKV heads the axis
    # does not divide
    for cfg, what in (
            (dataclasses.replace(dense, num_heads=6, num_kv_heads=3),
             "6 query and 3 kv heads"),
            (dataclasses.replace(get_smoke("recurrentgemma-2b"),
                                 rnn_width=127), "rnn_width 127"),
            (dataclasses.replace(get_smoke("rwkv6-1.6b"), d_model=192),
             "the RWKV heads 3")):
        with pytest.raises(NotImplementedError, match="item 6.1d") as err:
            TP.local_config(cfg, MP)
        assert what in str(err.value)
