"""The data axis of the port's serving mesh (`dist.serving.RowSplit`,
`Engine(mesh=...)` with "data" above 1, `launch.serve_mesh`) against the
JAX reference, on the CPU.

`torch_serve_mesh_script.py` runs as 4 gloo processes on the ("data",
"model") = (2, 2) mesh and as 2 on (2, 1), and serves in f32, from the
reference's parameters, every scenario of the script: mixed prompts and
budgets on the arena and the pool, overlapped and serialized; the
reference's ring test (a 16-token window wrapped, a 7-block ring pool
that preempts and replays); a pool too small for its requests under
"recompute" (it preempts rows of both lines) and "reserve" (it never
preempts). Each line holds one of the 2 decode rows. Held here:

  * every rank serves the same tokens, the overlapped scheduler
    ("async", which "auto" picks on a data axis) serves the serialized
    one's, and the pools serve the arena's;
  * the tokens equal the reference's Engine on its own (2, 2) mesh (4
    forced host devices, in a subprocess) and the port's one-process
    engine's;
  * the scarce pools preempt on both lines, re-admit their victims and
    return every block;
  * every rank's bytes equal what `dist.serving.serve_step_sends`
    reckons for the steps it ran;
  * the first decode step's logits, each line's row gathered, are within
    1e-5 of the largest |logit| of one process's;

and `python -m repro_torch.launch.serve_mesh` serves both meshes with
equal digests on every rank and arm. The row split, the overlap mode's
resolution and the data gathers' bytes are held without processes.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.base import ArchConfig as JaxArchConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.dist import serving as DS  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import flatten, params_from_jax  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_serve_mesh_script as script  # noqa: E402

# (processes, model parallel) of each mesh the ranks run
MESHES = {"2x2": (4, 2), "2x1": (2, 1)}
PAIRS = [("arena", "arena_serialized"), ("paged", "paged_serialized"),
         ("ring_paged", "ring_paged_serialized"),
         ("scarce_paged", "scarce_paged_serialized")]
# each scenario's workload, window and the arena scenario it serves
LOADS = {"arena": "mixed", "arena_serialized": "mixed", "paged": "mixed",
         "paged_serialized": "mixed", "ring_arena": "ring",
         "ring_paged": "ring", "ring_paged_serialized": "ring",
         "scarce_paged": "scarce", "scarce_paged_serialized": "scarce",
         "scarce_paged_reserve": "scarce"}

# the reference's arena engine on its (2, 2) mesh, each workload of the
# script (its paged GQA engine fails two of its own tests, so the pools
# are held to the arena's tokens)
REFERENCE = r"""
import json, sys
sys.path.insert(0, "src")
sys.path.insert(0, "tests")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.base import ArchConfig
from repro.models import build_model
from repro.serve import Engine
import torch_serve_mesh_script as script

cfg = ArchConfig(name="t", family="dense", source="test", num_layers=2,
                 d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                 d_ff=256, vocab_size=512, tie_embeddings=True,
                 compute_dtype="float32")
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
flat = np.load(sys.argv[2])    # the parameters the ranks serve


def leaf(path, _):
    key = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
    return jnp.asarray(flat[key])


loads = script.workloads()
out = {}
for load, window, max_len in (("mixed", 0, 32), ("ring", script.WINDOW, 64),
                              ("scarce", 0, 32)):
    model = build_model(cfg, window=window)
    params = jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    prompts, budgets = loads[load]
    eng = Engine(model, params, max_batch=2, max_len=max_len,
                 cache_dtype=jnp.float32, mesh=mesh)
    for p, b in zip(prompts, budgets):
        eng.submit(p, max_new_tokens=b)
    out[load] = {str(r.uid): r.output.tolist() for r in eng.run()}
json.dump(out, open(sys.argv[1], "w"))
print("REFERENCE_OK")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """The reference's init of the script's config, flattened to a .npz
    the ranks load, and as the port's params."""
    jcfg = JaxArchConfig(**{f.name: getattr(script.CFG, f.name)
                            for f in dataclasses.fields(script.CFG)})
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("serve_mesh_data") / "params.npz"
    np.savez(path, **flatten(jparams))
    return path, params_from_jax(jparams)


@pytest.fixture(scope="module")
def served(params, tmp_path_factory):
    """({mesh: (each rank's record, the mesh's logits)}, the reference's
    outputs): both meshes' ranks and the reference's subprocess run side
    by side."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    runs = {}
    for name, (world, mp) in MESHES.items():
        out = tmp_path_factory.mktemp(f"serve_mesh_{name}")
        port = _free_port()
        runs[name] = (out, [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_serve_mesh_script.py"),
             "--rank", str(r), "--world", str(world), "--model-parallel",
             str(mp), "--coordinator", f"localhost:{port}", "--params",
             str(params[0]), "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)])
    ref_env = dict(os.environ)
    ref_env.pop("JAX_PLATFORMS", None)
    ref_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    ref_path = tmp_path_factory.mktemp("serve_mesh_data_ref") / "ref.json"
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(ref_path),
                          str(params[0])],
                         env=ref_env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    records = {}
    for name, (out, ranks) in runs.items():
        logs = []
        for p in ranks:
            try:
                logs.append(p.communicate(timeout=300)[0])
            except subprocess.TimeoutExpired:
                for q in ranks:
                    q.kill()
                raise
        assert all(p.returncode == 0 for p in ranks), "\n".join(logs)
        recs = []
        for r in range(len(ranks)):
            with open(out / f"rank{r}.json") as f:
                recs.append(json.load(f))
        records[name] = (recs, torch.load(out / "logits.pt"))
    assert "REFERENCE_OK" in ref.stdout, ref.stdout + ref.stderr
    with open(ref_path) as f:
        reference = json.load(f)
    return records, reference


def _one_process(params, load, window, **kw):
    model = build_model(script.CFG, window=window)
    prompts, budgets = script.workloads()[load]
    _, outputs = script.serve(model, params, prompts, budgets, **kw)
    return {str(u): t for u, t in outputs.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_agree_and_overlapped_equals_serialized(served, mesh):
    recs, _ = served[0][mesh]
    rec = recs[0]
    for other in recs[1:]:
        for name in LOADS:
            assert other[name]["outputs"] == rec[name]["outputs"], name
    assert all(r["all_reduce_is_the_line_order_sum"] for r in recs)
    for overlapped, serialized in PAIRS:
        assert rec[overlapped]["overlap_mode"] == "async"
        assert rec[serialized]["overlap_mode"] == ""
        assert rec[overlapped]["outputs"] == rec[serialized]["outputs"]
    # the pools serve the arena's tokens (the scarce ones each other's:
    # the reference's arena holds them in the next test); a windowed
    # arena stays serialized
    assert rec["paged"]["paged"] and rec["scarce_paged_reserve"]["paged"]
    assert rec["paged"]["outputs"] == rec["arena"]["outputs"]
    assert rec["ring_paged"]["outputs"] == rec["ring_arena"]["outputs"]
    assert rec["scarce_paged_reserve"]["outputs"] == \
        rec["scarce_paged"]["outputs"]
    assert not rec["ring_arena"]["overlap"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tokens_equal_the_reference_and_one_process(served, params, mesh):
    recs, _ = served[0][mesh]
    reference = served[1]
    rec = recs[0]
    ones = {"mixed": _one_process(params[1], "mixed", 0, max_len=32),
            "ring": _one_process(params[1], "ring", script.WINDOW,
                                 max_len=64),
            "scarce": _one_process(params[1], "scarce", 0, max_len=32)}
    for name, load in LOADS.items():
        got = {str(u): t for u, t in rec[name]["outputs"].items()}
        assert got == reference[load], name
        assert got == ones[load], name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_scarce_pools_preempt_on_both_lines_and_return_every_block(
        served, mesh):
    recs, _ = served[0][mesh]
    for rec in recs:
        for name in ("ring_paged", "ring_paged_serialized", "scarce_paged",
                     "scarce_paged_serialized", "scarce_paged_reserve"):
            assert rec[name]["free_blocks"] == rec[name]["num_blocks"], name
        assert rec["ring_paged"]["preemptions"] >= 1
        assert rec["scarce_paged_reserve"]["preemptions"] == 0
    # under "recompute" each line preempts one of its rows, and the
    # lines' preemptions add up to all of them (a line's model ranks
    # count the same)
    world, mp = MESHES[mesh]
    for name in ("scarce_paged", "scarce_paged_serialized"):
        per_line = [recs[r * mp][name]["line_preemptions"]
                    for r in range(world // mp)]
        assert all(recs[r][name]["line_preemptions"] == per_line[r // mp]
                   for r in range(world)), name
        assert min(per_line) >= 1, name
        assert sum(per_line) == recs[0][name]["preemptions"], name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_bytes_equal_serve_step_sends(served, mesh):
    recs, _ = served[0][mesh]
    world, mp = MESHES[mesh]
    kinds = {"all_gather"} | ({"all_reduce"} if mp > 1 else set())
    for rec in recs:
        for name in LOADS:
            assert rec[name]["sent"] == rec[name]["sent_reckoned"], name
            assert set(rec[name]["sent"]) == kinds, name
    # each admission prefills on one line: the lines' counts add up to
    # every admission once (a line's model ranks count the same)
    for name in LOADS:
        per_line = [recs[r * mp][name]["line_admissions"]
                    for r in range(world // mp)]
        assert all(recs[r][name]["line_admissions"]
                   == per_line[r // mp] for r in range(world))
        assert sum(per_line) == len(recs[0][name]["outputs"]) + \
            recs[0][name]["preemptions"], name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_logits_match_one_process(served, params, mesh):
    _, logits = served[0][mesh]
    prompts = script.workloads()["mixed"][0][:2]
    want = script.first_decode_logits(build_model(script.CFG), params[1],
                                      prompts, 32)
    assert logits.shape == want.shape == (2, 1, script.CFG.vocab_size)
    scale = float(want.abs().max())
    assert float((logits - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("mesh", list(MESHES))
def test_launcher_serves_a_data_axis(mesh):
    world, mp = MESHES[mesh]
    arms = ("arena", "arena-serialized", "paged", "paged-serialized")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_mesh",
         "--processes", str(world), "--model-parallel", str(mp),
         "--backend", "gloo", "--device", "cpu", "--arch", "qwen2-0.5b",
         "--smoke", "--requests", "6", "--max-batch", "4", "--new-tokens",
         "12", "--mixed", "--block-size", "4", "--num-blocks", "8",
         "--arms", ",".join(arms)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    recs = [json.loads(line.split("SERVE_MESH_ARM ", 1)[1])
            for line in p.stdout.splitlines() if "SERVE_MESH_ARM " in line]
    assert len(recs) == world * len(arms)
    for rec in recs:
        assert rec["mesh"] == {"data": world // mp, "model": mp}
        assert rec["data_index"] == rec["process"] // mp
        assert rec["overlap_mode"] == ("" if "serialized" in rec["arm"]
                                       else "async")
        assert rec["sent"] == rec["sent_reckoned"] and rec["sent"]
        assert rec["engine_stats"]["decode_fetch_elems"] == 4
        assert set(rec["axis_ms_by_axis"]) == (
            {"data", "model"} if mp > 1 else {"data"})
    # one digest for every rank and arm; the 8-block pool preempts
    assert len({r["digest"] for r in recs}) == 1
    assert any(r["engine_stats"]["preemptions"] for r in recs)
    for arm in arms:
        assert f"[parent] {world} processes agree on {arm}" in p.stdout


# ---------------------------------------------------------------------------
# without processes: the row split, the overlap mode, the bytes
# ---------------------------------------------------------------------------


def test_the_slot_to_line_map():
    lines = []
    for rank in range(4):
        rows = DS.RowSplit(6, Mesh(("data", "model"), (2, 2), rank=rank))
        assert rows.size == 2 and rows.rows == 3
        assert rows.index == rank // 2
        assert (rows.lo, rows.hi) == (3 * rows.index, 3 * rows.index + 3)
        assert [rows.owns(s) for s in range(6)] == [
            rows.owner(s) == rows.index for s in range(6)]
        assert [rows.local(s) for s in range(rows.lo, rows.hi)] == [0, 1, 2]
        lines.append(rows.index)
    assert lines == [0, 0, 1, 1]
    assert [DS.RowSplit(6, None).owner(s) for s in range(6)] == [0] * 6
    # pod-major over the data axes
    got = [DS.RowSplit(8, Mesh(("pod", "data", "model"), (2, 2, 1),
                               rank=r)).index for r in range(4)]
    assert got == [0, 1, 2, 3]
    rows = DS.RowSplit(4, Mesh(("data", "model"), (2, 1), rank=1))
    np.testing.assert_array_equal(rows.mine(np.arange(8).reshape(4, 2)),
                                  [[4, 5], [6, 7]])


def _engine(mesh, **kw):
    model = build_model(get_smoke("qwen2-0.5b"))
    return Engine(model, model.init(torch.Generator().manual_seed(0)),
                  max_len=16, mesh=mesh, **kw)


def test_max_batch_must_be_a_multiple_of_the_data_size():
    mesh = Mesh(("data", "model"), (2, 1), rank=0)
    with pytest.raises(ValueError, match="multiple of the data size"):
        DS.RowSplit(3, mesh)
    with pytest.raises(ValueError, match="multiple of the data size"):
        _engine(mesh, max_batch=3)


def test_auto_resolves_to_async_on_a_data_axis():
    for sizes, mode in (((2, 1), "async"), ((2, 2), "async"),
                        ((1, 1), "fused")):
        eng = _engine(Mesh(("data", "model"), sizes, rank=0), max_batch=2)
        assert eng.overlap and eng.overlap_mode == mode, sizes
        assert eng.rows.rows == 2 // sizes[0]
    assert _engine(None, max_batch=2).overlap_mode == "fused"
    paged = _engine(Mesh(("data", "model"), (2, 1), rank=1), max_batch=2,
                    paged=True, block_size=4)
    assert paged.overlap_mode == "async" and paged.rows.index == 1
    assert _engine(Mesh(("data", "model"), (2, 1), rank=0), max_batch=2,
                   overlap=False).overlap_mode == ""


def test_fused_on_a_data_axis_raises():
    with pytest.raises(ValueError, match="'fused' on a data axis of 2"):
        _engine(Mesh(("data", "model"), (2, 1), rank=0), max_batch=2,
                overlap_mode="fused")
    # explicit "async" and one data line's "fused" stay as asked
    assert _engine(Mesh(("data", "model"), (2, 1), rank=0), max_batch=2,
                   overlap_mode="async").overlap_mode == "async"
    assert _engine(Mesh(("data", "model"), (1, 1), rank=0), max_batch=2,
                   overlap_mode="fused").overlap_mode == "fused"


@pytest.mark.parametrize("sizes", [(2, 1), (2, 2), (4, 2)])
def test_serve_step_sends_counts_the_data_gathers(sizes):
    cfg = get_smoke("qwen2-0.5b")
    data, mp = sizes
    batch, unit = 8, 16
    got = DS.serve_step_sends(cfg, {"data": data, "model": mp}, batch, unit)
    # the model axis's share: a (1, mp) mesh serving one line's rows
    line = DS.serve_step_sends(cfg, {"data": 1, "model": mp}, batch // data,
                               unit)
    assert len(got) == data * mp
    for rank, steps in enumerate(got):
        model = line[rank % mp]
        ids = (data - 1) * (batch // data) * 4     # the line's int32 ids
        assert steps["decode"] == {
            **model["decode"],
            "all_gather": model["decode"].get("all_gather", 0) + ids}
        # an admission sums over its line's model axis only
        assert steps["admission"] == model["admission"]
        assert steps["first_token"] == {"all_gather": (data - 1) * 4}
    # a mesh of one rank sends nothing
    one = DS.serve_step_sends(cfg, {"data": 1, "model": 1}, batch, unit)
    assert one == [{"decode": {}, "admission": {}, "mixed": {},
                    "first_token": {}, "wave_prefill": {},
                    "wave_decode": {}}]
