"""The port's sharding specs (`repro_torch.dist.sharding`) and meshes
(`repro_torch.launch.mesh`) against the reference's, on the CPU.

The reference's functions build `NamedSharding`s on a mesh; here they get
an `AbstractMesh` of the same axes (no devices), and their specs, padded
with None to each leaf's rank, must equal the port's tuples:

  * greedy_spec on random shapes and axis sizes (hypothesis) and on the
    reference's pinned cases;
  * for all 10 architectures at full width, on the (4, 2, 1), (2, 2, 2)
    and (1, 1, 16) ("agent", "replica", "model") meshes, the (16, 16)
    ("data", "model") and (2, 16, 16) ("pod", "data", "model") meshes:
    the params, the API-BCD state and [A, B, ...] batches (training
    meshes), the prefill and decode batches, the decode caches and the
    paged pools.

Also: local_shard and gather_shards invert each other, and the meshes lay
ranks out row-major as the reference reshapes its devices.
"""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

pytest.importorskip("hypothesis")

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.dist import sharding as JS  # noqa: E402
from repro.dist.trainer import init_train_state as jax_state  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.dist.trainer import _state_shapes  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.model import (cache_specs, input_specs,  # noqa: E402
                                      param_specs)

MESHES = {
    "train_4x2x1": (("agent", "replica", "model"), (4, 2, 1)),
    "train_2x2x2": (("agent", "replica", "model"), (2, 2, 2)),
    "train_1x1x16": (("agent", "replica", "model"), (1, 1, 16)),
    "serve_16x16": (("data", "model"), (16, 16)),
    "pod_2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
DIMS = [1, 2, 3, 4, 6, 7, 8, 12, 13, 16, 64, 96, 128, 51865]
NAMES = ["model", "replica", "data", "pod"]


def _ref_spec(spec, ndim):
    """A reference PartitionSpec as the port's tuple: one entry a dim."""
    entries = tuple(spec)
    return entries + (None,) * (ndim - len(entries))


# ---------------------------------------------------------------------------
# greedy_spec
# ---------------------------------------------------------------------------


@settings(max_examples=300, derandomize=True, deadline=None, database=None)
@given(shape=st.lists(st.sampled_from(DIMS), min_size=1, max_size=4),
       axes=st.dictionaries(st.sampled_from(NAMES),
                            st.sampled_from([1, 2, 3, 4, 8, 16]),
                            min_size=1, max_size=3),
       skip=st.integers(0, 4))
def test_greedy_spec_equals_the_reference(shape, axes, skip):
    skip = min(skip, len(shape))
    got = S.greedy_spec(tuple(shape), axes, skip_leading=skip)
    want = JS.greedy_spec(tuple(shape), axes, skip_leading=skip)
    assert got == _ref_spec(want, len(shape))
    assert len(got) == len(shape)
    used = [e for e in got if e is not None]
    assert len(used) == len(set(used))
    for i, e in enumerate(got):
        if e is not None:
            assert i >= skip and shape[i] % axes[e] == 0


def test_greedy_spec_pinned_cases():
    assert S.greedy_spec((51865, 768), {"model": 16}) == (None, "model")
    assert S.greedy_spec((7, 13), {"model": 16, "replica": 6}) == (None,
                                                                   None)
    assert S.greedy_spec((24, 896, 4864), {"replica": 16, "model": 8},
                         skip_leading=1) in ((None, "model", "replica"),
                                             (None, "replica", "model"))


# ---------------------------------------------------------------------------
# every architecture's trees on every mesh
# ---------------------------------------------------------------------------


def _flat_ref(shardings, shapes):
    """{dotted path: port-style spec} of a reference NamedSharding tree."""
    flat_sh = jax.tree_util.tree_flatten_with_path(shardings)[0]
    flat_shape = jax.tree_util.tree_leaves(shapes)
    out = {}
    for (path, sh), leaf in zip(flat_sh, flat_shape):
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = _ref_spec(sh.spec, len(leaf.shape))
    return out


def _flat(tree, prefix=""):
    """{dotted path: spec} of a port spec tree (a spec tuple is a leaf)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _same(got, want, what):
    got = _flat(got)
    assert set(got) == set(want), (what, set(got) ^ set(want))
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, (what, bad)


@pytest.fixture(scope="module")
def ref_params():
    """{arch: the reference's params as ShapeDtypeStructs}."""
    return {}


def _walks(a):
    return 2 if a % 2 == 0 else 1


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_specs_equal_the_reference(arch, mesh_name, ref_params):
    names, sizes = MESHES[mesh_name]
    jmesh = AbstractMesh(sizes, names)
    mesh = M.Mesh(names, sizes)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jmodel = jax_build_model(jcfg)
    if arch not in ref_params:
        ref_params[arch] = jax.eval_shape(jmodel.init,
                                          jax.random.PRNGKey(0))
    jparams = ref_params[arch]
    with FakeTensorMode() as mode:
        params = param_specs(cfg, mode)
        # the params, unstacked (serving, the DP baseline)
        _same(S.param_shardings(mesh, params, leading_axis=None),
              _flat_ref(JS.param_shardings(jmesh, jparams,
                                           leading_axis=None), jparams),
              "params")
        if "agent" in names:
            a = mesh.shape["agent"]
            tcfg = TrainConfig(num_agents=a, num_walks=_walks(a))
            jstate = jax_state(jmodel, JaxTrainConfig(
                num_agents=a, num_walks=_walks(a), model_parallel=1))
            want = JS.state_shardings(jmesh, jstate)
            got = S.state_shardings(mesh, _state_shapes(params, tcfg))
            for part in ("params", "token", "zhat", "gacc"):
                _same(got[part], _flat_ref(want[part], jstate[part]), part)
            train = input_specs(cfg, INPUT_SHAPES["train_4k"], mode=mode)
            stacked = {k: (a, v.shape[0] // a) + tuple(v.shape[1:])
                       for k, v in train.items()}
            jstacked = {k: jax.ShapeDtypeStruct(s, "int32")
                        for k, s in stacked.items()}
            _same(S.train_batch_shardings(mesh, stacked),
                  _flat_ref(JS.train_batch_shardings(jmesh, jstacked),
                            jstacked), "train batch")
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            if shape == "long_500k" and arch == "whisper-small":
                continue
            batch = input_specs(cfg, INPUT_SHAPES[shape], mode=mode)
            jbatch = JM.input_specs(jcfg, JAX_SHAPES[shape])
            jbatch = {k: v for k, v in jbatch.items() if k in batch}
            _same(S.batch_shardings(mesh, batch),
                  _flat_ref(JS.batch_shardings(jmesh, jbatch), jbatch),
                  f"{shape} batch")
        caches = cache_specs(cfg, INPUT_SHAPES["decode_32k"], mode=mode)
        jcaches = JM.cache_specs(jcfg, JAX_SHAPES["decode_32k"])
        _same(S.cache_shardings(mesh, caches),
              _flat_ref(JS.cache_shardings(jmesh, jcaches), jcaches),
              "caches")
        try:
            jpool = jax.eval_shape(lambda: JTF.init_pool(jcfg, 64, 16))
        except NotImplementedError:
            with pytest.raises(NotImplementedError):
                TF.init_pool(cfg, 64, 16)
        else:
            pool = TF.init_pool(cfg, 64, 16)
            _same(S.pool_shardings(mesh, pool),
                  _flat_ref(JS.pool_shardings(jmesh, jpool), jpool),
                  "pool")


# ---------------------------------------------------------------------------
# cutting and joining
# ---------------------------------------------------------------------------


@settings(max_examples=60, derandomize=True, deadline=None,
          database=None)
@given(dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12]), min_size=1,
                     max_size=3),
       sizes=st.tuples(st.sampled_from([1, 2, 3]), st.sampled_from([1, 2]),
                       st.sampled_from([1, 2, 4])),
       joint=st.booleans())
def test_local_shard_and_gather_shards_invert_each_other(dims, sizes, joint):
    """Every rank's piece, joined, is the tensor again; a dim may split
    over two axes together (major to minor), as a production batch does."""
    names = ("agent", "replica", "model")
    mesh = dict(zip(names, sizes))
    spec = list(S.greedy_spec(tuple(dims), {"model": sizes[2]}))
    if joint and dims[0] % (sizes[0] * sizes[1]) == 0 and spec[0] is None:
        spec[0] = ("agent", "replica")
    spec = tuple(spec)
    t = torch.arange(math.prod(dims), dtype=torch.float32).reshape(dims)
    pieces = [S.local_shard(t, spec, mesh, S.mesh_coords(mesh, r))
              for r in range(math.prod(sizes))]
    for p in pieces:
        assert p.is_contiguous()
        assert tuple(p.shape) == S.shard_shape(tuple(dims), spec, mesh)
    assert torch.equal(S.gather_shards(pieces, spec, mesh), t)


def test_restrict_keeps_only_the_named_axes():
    spec = ("agent", ("pod", "replica"), "model", None)
    assert S.restrict(spec, ("replica",)) == (None, "replica", None, None)
    assert S.restrict(spec, ("pod", "replica", "model")) == (
        None, ("pod", "replica"), "model", None)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_ranks_are_row_major_over_the_axes():
    """As the reference reshapes its devices into ("agent", "replica",
    "model"): rank = (agent * R + replica) * mp + model."""
    sizes = (2, 3, 2)
    for rank in range(12):
        mesh = M.Mesh(M.TRAINING_AXES, sizes, rank=rank)
        c = mesh.coords
        assert rank == (c["agent"] * 3 + c["replica"]) * 2 + c["model"]
        assert mesh.rank_of(c) == rank
        line = mesh.line("agent")
        assert len(line) == 2 and rank in line
        assert all(M.Mesh(M.TRAINING_AXES, sizes, rank=r).coords["replica"]
                   == c["replica"] for r in line)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_shapes_equal_the_reference(multi_pod):
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    want = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else (
        (16, 16), ("data", "model"))
    assert (mesh.sizes, mesh.axis_names) == want
    assert mesh.rank is None
    total = 512 if multi_pod else 256
    for a, mp in ((4, 16), (16, 16), (2, 8)):
        t = M.training_mesh_shape(a, mp, multi_pod=multi_pod)
        assert t.shape == {"agent": a, "replica": total // (a * mp),
                           "model": mp}
    with pytest.raises(ValueError, match="tile"):
        M.training_mesh_shape(3, 16)


# the training meshes of the tensor-parallel state specs: (agent, replica,
# model)
TP_MESHES = [(4, 2, 1), (2, 1, 1), (2, 1, 2), (2, 2, 2), (1, 2, 2)]
TP_ARCHS = ("qwen2-0.5b", "qwen3-8b", "internlm2-1.8b", "nemotron-4-15b",
            "phi-3-vision-4.2b")


@pytest.mark.parametrize("arch,sizes", [
    pytest.param(arch, sizes, id=f"{arch}-{'x'.join(map(str, sizes))}")
    for arch in ARCH_IDS for sizes in TP_MESHES
    if sizes[2] == 1 or arch in TP_ARCHS])
def test_tensor_parallel_state_specs(arch, sizes):
    """`trainer.state_specs` at full width: where the model axis is 1 it
    is `state_shardings` (the reference's, `test_specs_equal_the_
    reference`) leaf by leaf, for every architecture; above 1 (the dense
    attention stacks) "agent" holds dim 0, "model" the dim that
    `tensor_parallel.param_specs` splits behind the leading dims (one
    for params, token and gacc, two for zhat), and "replica" the largest
    of the other dims that it divides, where one does."""
    from repro_torch.dist import tensor_parallel as TP
    from repro_torch.dist.trainer import state_specs
    from repro_torch.models import build_model

    names = ("agent", "replica", "model")
    mesh = M.Mesh(names, sizes)
    a, r, mp = sizes
    cfg = get_config(arch)
    tcfg = TrainConfig(num_agents=a, num_walks=_walks(a))
    with FakeTensorMode() as mode:
        params = param_specs(cfg, mode)
        got = state_specs(build_model(cfg), tcfg, mesh, params)
        if mp == 1:
            assert got == S.state_shardings(mesh, _state_shapes(params,
                                                                tcfg))
            return
        tp = TP.param_specs(cfg, params)
        shapes = _state_shapes(params, tcfg)
        for part, leaves in got.items():
            lead = 2 if part == "zhat" else 1
            for k, spec in leaves.items():
                shape = shapes[part][k]
                assert spec[0] == "agent" and set(spec[1:lead]) <= {None}
                assert spec[lead:].count("model") == tp[k].count("model")
                if "model" in tp[k]:
                    assert spec[lead + tp[k].index("model")] == "model"
                free = [d for d in range(lead, len(shape))
                        if r > 1 and spec[d] != "model"
                        and shape[d] % r == 0]
                assert ("replica" in spec) == bool(free), (k, spec)
                if free:
                    d = spec.index("replica")
                    assert shape[d] == max(shape[i] for i in free), (k, spec)
