"""The port's serving across processes (`Engine(mesh=...)`, `dist.serving`,
`launch.serve_mesh`) against the JAX reference, on the CPU.

`torch_serve_mesh_script.py` runs as 2 gloo processes on the ("data",
"model") = (1, 2) mesh and serves, in f32, from the reference's
parameters: mixed prompts and budgets on the arena and the pool,
overlapped and serialized; the reference's ring test (a 16-token window
wrapped, a 7-block ring pool that preempts and replays); and a pool too
small for its requests, which preempts and replays. Held here:

  * both ranks serve the same tokens, and the overlapped scheduler
    serves the serialized one's (the reference's RE-BASELINE rule);
  * the tokens equal the reference's Engine on its own (1, 2) mesh (2
    forced host devices, in a subprocess) and on one device, and the
    port's one-process engine's;
  * the first decode step's logits on the mesh are within 1e-5 of the
    largest |logit| of the one-process ones;
  * every preempting pool preempts, returns every block and serves the
    arena's tokens;

and `python -m repro_torch.launch.serve_mesh` passes on the arena and
the pool with equal digests (and its ranks' bytes as `dist.serving.
serve_step_sends` reckons them), and fails fast when a rank is killed.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.base import ArchConfig as JaxArchConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import flatten, params_from_jax  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_serve_mesh_script as script  # noqa: E402

WORLD = 2
PAIRS = [("arena", "arena_serialized"), ("paged", "paged_serialized"),
         ("ring_paged", "ring_paged_serialized"),
         ("scarce_paged", "scarce_paged_serialized")]

# the reference's engines: on its (1, 2) mesh and on one device, each
# workload of the script on the arena (the reference's paged GQA engine
# fails two of its own tests, so the pools are held to the arena's
# tokens instead)
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
mesh = Mesh(np.array(jax.devices()).reshape(1, 2), ("data", "model"))
flat = np.load(sys.argv[2])    # the parameters the ranks serve


def leaf(path, _):
    key = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
    return jnp.asarray(flat[key])


loads = script.workloads()
out = {}
for name, load, window, max_len, meshes in (
        ("mixed", "mixed", 0, 32, (True, False)),
        ("ring", "ring", script.WINDOW, 64, (True, False)),
        ("scarce", "scarce", 0, 32, (False,))):
    model = build_model(cfg, window=window)
    params = jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    prompts, budgets = loads[load]
    for on_mesh in meshes:
        eng = Engine(model, params, max_batch=2, max_len=max_len,
                     cache_dtype=jnp.float32, mesh=mesh if on_mesh else None)
        for p, b in zip(prompts, budgets):
            eng.submit(p, max_new_tokens=b)
        out[f"{name}_{'mesh' if on_mesh else 'one'}"] = {
            str(r.uid): r.output.tolist() for r in eng.run()}
json.dump(out, open(sys.argv[1], "w"))
print("REFERENCE_OK")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_cfg():
    return JaxArchConfig(**{f.name: getattr(script.CFG, f.name)
                            for f in dataclasses.fields(script.CFG)})


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """The reference's init of the script's config, flattened to a .npz
    the ranks load, and as the port's params."""
    jparams = jax_build_model(_jax_cfg()).init(jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp("serve_mesh") / "params.npz"
    np.savez(path, **flatten(jparams))
    return path, params_from_jax(jparams)


@pytest.fixture(scope="module")
def served(params, tmp_path_factory):
    """(each rank's record, the mesh's logits, the reference's outputs):
    the ranks and the reference's subprocess run side by side."""
    out = tmp_path_factory.mktemp("serve_mesh_ranks")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    port = _free_port()
    ranks = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_serve_mesh_script.py"),
         "--rank", str(r), "--world", str(WORLD), "--coordinator",
         f"localhost:{port}", "--params", str(params[0]), "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]
    ref_env = dict(os.environ)
    ref_env.pop("JAX_PLATFORMS", None)
    ref_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    ref_path = out / "reference.json"
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(ref_path),
                          str(params[0])],
                         env=ref_env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    logs = []
    for p in ranks:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in ranks:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in ranks), "\n".join(logs)
    assert "REFERENCE_OK" in ref.stdout, ref.stdout + ref.stderr
    records = []
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as f:
            records.append(json.load(f))
    with open(ref_path) as f:
        reference = json.load(f)
    return records, torch.load(out / "logits.pt"), reference


def _one_process(params, load, window, **kw):
    model = build_model(script.CFG, window=window)
    prompts, budgets = script.workloads()[load]
    _, outputs = script.serve(model, params, prompts, budgets, **kw)
    return {str(u): t for u, t in outputs.items()}


def test_ranks_agree_and_overlapped_equals_serialized(served):
    records, _, _ = served
    # on 2 ranks every rank also sends what it receives
    assert records[0] == records[1]
    rec = dict(records[0])
    assert rec.pop("all_reduce_is_the_line_order_sum") is True
    for overlapped, serialized in PAIRS:
        assert rec[overlapped]["overlap"] and not rec[serialized]["overlap"]
        assert rec[overlapped]["outputs"] == rec[serialized]["outputs"]
    # the pools serve the arena's tokens; a windowed arena stays serialized
    assert rec["paged"]["outputs"] == rec["arena"]["outputs"]
    assert rec["ring_paged"]["outputs"] == rec["ring_arena"]["outputs"]
    assert not rec["ring_arena"]["overlap"] and rec["ring_paged"]["paged"]
    for name in rec:
        assert set(rec[name]["sent"]) == {"all_reduce", "all_gather"}


def test_tokens_equal_the_reference_and_one_process(served, params):
    records, _, reference = served
    rec = records[0]
    for load, scenario, window in (("mixed", "arena", 0),
                                   ("ring", "ring_arena", script.WINDOW)):
        got = rec[scenario]["outputs"]
        assert got == reference[f"{load}_mesh"]
        assert got == reference[f"{load}_one"]
        assert got == _one_process(params[1], load, window,
                                   max_len=64 if window else 32)
    assert rec["scarce_paged"]["outputs"] == reference["scarce_one"]


def test_step_logits_match_one_process(served, params):
    _, logits, _ = served
    prompts = script.workloads()["mixed"][0][:2]
    want = script.first_decode_logits(build_model(script.CFG), params[1],
                                      prompts, 32)
    assert logits.shape == want.shape == (2, 1, script.CFG.vocab_size)
    scale = float(want.abs().max())
    assert float((logits - want).abs().max()) <= 1e-5 * scale


def test_preempting_pools_replay_and_return_every_block(served):
    rec = served[0][0]
    for name in ("ring_paged", "ring_paged_serialized", "scarce_paged",
                 "scarce_paged_serialized"):
        assert rec[name]["preemptions"] >= 1, name
        assert rec[name]["free_blocks"] == rec[name]["num_blocks"], name


def _launcher(*flags, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_mesh",
         "--processes", "2", "--model-parallel", "2", "--backend", "gloo",
         "--device", "cpu", *flags], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_launcher_serves_the_arena_and_the_pool(tmp_path):
    stats = tmp_path / "stats.json"
    p = _launcher("--arch", "qwen2-0.5b", "--smoke", "--requests", "6",
                  "--max-batch", "3", "--new-tokens", "12", "--mixed",
                  "--arms", "arena,paged", "--out", str(stats))
    out = p.communicate(timeout=300)[0]
    assert p.returncode == 0, out
    digests = {}
    for line in out.splitlines():
        if "SERVE_MESH_ARM " in line:
            rec = json.loads(line.split("SERVE_MESH_ARM ", 1)[1])
            assert rec["sent"] == rec["sent_reckoned"] and rec["sent"]
            assert rec["engine_stats"]["decode_fetch_elems"] == 3
            digests.setdefault(rec["arm"], set()).add(rec["digest"])
    assert set(digests) == {"arena", "paged"}
    assert len(digests["arena"] | digests["paged"]) == 1
    assert "[parent] 2 processes agree on arena" in out
    assert "[parent] 2 processes agree on paged" in out
    with open(stats) as f:
        arms = json.load(f)
    assert [a["backend"] for a in arms] == ["arena", "paged"]
    for a in arms:
        assert {"backend", "num_processes", "devices", "mesh", "arch",
                "workload", "completed", "tokens", "wall_s", "free_blocks",
                "num_blocks", "engine_stats", "derived",
                "output_digest"} <= set(a)
        assert a["completed"] == 6 and a["mesh"] == {"data": 1, "model": 2}


def _children(pid):
    kids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                kids.append(int(entry))
    return kids


def test_a_killed_rank_fails_the_launch_at_once():
    timeout = 240
    t0 = time.monotonic()
    p = _launcher("--requests", "64", "--new-tokens", "64", "--timeout",
                  str(timeout))
    kids = []
    while len(kids) < 2 and time.monotonic() - t0 < 60:
        time.sleep(0.2)
        kids = _children(p.pid)
    assert len(kids) == 2, kids
    time.sleep(2.0)
    os.kill(max(kids), signal.SIGKILL)
    out = p.communicate(timeout=timeout)[0]
    assert p.returncode != 0, out
    assert "[parent] FAILED" in out
    assert time.monotonic() - t0 < timeout / 2, out
