"""The recurrent families on the model axis of the port's serving mesh
(RWKV6's heads and RG-LRU's channels split with their recurrent state,
recurrentgemma's one kv head on every rank) against the JAX reference and
one process, on the CPU.

`torch_serve_mesh_script.py --arch rwkv6,recurrentgemma` runs as 2 gloo
processes on the ("data", "model") = (1, 2) mesh and as 4 on (2, 2), and
serves in f32, from the reference's parameters, rwkv6-1.6b's and
recurrentgemma-2b's smoke configs through `Engine(mesh=...)` on the
arena, every prompt at its exact length (their `FamilyCaps`), two of
recurrentgemma's past its 32-token window. Held here:

  * every rank serves the same tokens, from the serialized arena;
  * the tokens equal the reference's Engine on its own (2, 2) mesh (4
    forced host devices, in a subprocess) and the port's one-process
    engine's;
  * every rank's bytes equal what `dist.serving.serve_step_sends`
    reckons for the steps it ran (two row sums a layer);
  * the first decode step's logits are within 1e-5 of the largest
    |logit| of one process's.
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
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import flatten, params_from_jax  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_serve_mesh_script as script  # noqa: E402

# (processes, model parallel) of each mesh the ranks run
MESHES = {"1x2": (2, 2), "2x2": (4, 2)}
FAMILIES = list(script.RECURRENT)
ATOL = 1e-5

# the reference's arena engine on its (2, 2) mesh, each family's workload
REFERENCE = r"""
import json, os, sys
sys.path.insert(0, "src")
sys.path.insert(0, "tests")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models import build_model
from repro.serve import Engine
import test_torch_serve_mesh_recurrent as test
import torch_serve_mesh_script as script

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for name in script.RECURRENT:
    flat = np.load(os.path.join(sys.argv[2], f"{name}.npz"))
    model = build_model(test.jax_config(name))

    def leaf(path, _):
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        return jnp.asarray(flat[key])

    params = jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    load, kw = script.SCENARIOS_OF[name]["arena"]
    prompts, budgets = script.family_workloads(
        script.RECURRENT[name].vocab_size)[load]
    eng = Engine(model, params, max_batch=2, max_len=kw["max_len"],
                 cache_dtype=jnp.float32, mesh=mesh)
    for p, b in zip(prompts, budgets):
        eng.submit(p, max_new_tokens=b)
    out[name] = {str(r.uid): r.output.tolist() for r in eng.run()}
json.dump(out, open(sys.argv[1], "w"))
print("REFERENCE_OK")
"""


def jax_config(name):
    """The reference's config of the script's recurrent family `name`."""
    cfg = script.RECURRENT[name]
    return JaxArchConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(cfg)})


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """(the directory of each family's .npz of the reference's init, the
    ranks load, {family: the port's params})."""
    path = tmp_path_factory.mktemp("serve_mesh_recurrent")
    port = {}
    for name in FAMILIES:
        jparams = jax_build_model(jax_config(name)).init(
            jax.random.PRNGKey(0))
        np.savez(path / f"{name}.npz", **flatten(jparams))
        port[name] = params_from_jax(jparams)
    return path, port


@pytest.fixture(scope="module")
def served(params, tmp_path_factory):
    """({mesh: (each rank's record, {family: its logits})}, the
    reference's outputs): both meshes' ranks and the reference's
    subprocess run side by side."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    runs = {}
    for mesh, (world, mp) in MESHES.items():
        out = tmp_path_factory.mktemp(f"serve_mesh_recurrent_{mesh}")
        port = _free_port()
        runs[mesh] = (out, [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_serve_mesh_script.py"),
             "--rank", str(r), "--world", str(world), "--model-parallel",
             str(mp), "--coordinator", f"localhost:{port}", "--params",
             str(params[0]), "--out", str(out), "--arch",
             ",".join(FAMILIES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)])
    ref_env = dict(os.environ)
    ref_env.pop("JAX_PLATFORMS", None)
    ref_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    ref_path = tmp_path_factory.mktemp("serve_mesh_recurrent_ref") / "r.json"
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(ref_path),
                          str(params[0])],
                         env=ref_env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    records = {}
    for mesh, (out, ranks) in runs.items():
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
        records[mesh] = (recs, {
            name: torch.load(out / f"logits.{name}.pt") for name in FAMILIES})
    assert "REFERENCE_OK" in ref.stdout, ref.stdout + ref.stderr
    with open(ref_path) as f:
        reference = json.load(f)
    return records, reference


@pytest.fixture(scope="module")
def one_process(params):
    """{family: {"arena": tokens by uid, "logits"}} of the port's
    one-process engine and steps."""
    out = {}
    for name in FAMILIES:
        cfg = script.RECURRENT[name]
        model = build_model(cfg)
        p = params[1][name]
        load, kw = script.SCENARIOS_OF[name]["arena"]
        prompts, budgets = script.family_workloads(cfg.vocab_size)[load]
        _, outputs = script.serve(model, p, prompts, budgets, **kw)
        out[name] = {"arena": {str(u): t for u, t in outputs.items()},
                     "logits": script.first_decode_logits(
                         model, p, *script.logit_prompts(name))}
    return out


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_agree_on_the_serialized_arena(served, mesh, family):
    recs, _ = served[0][mesh]
    for other in recs[1:]:
        assert (other[family]["arena"]["outputs"]
                == recs[0][family]["arena"]["outputs"])
    for rec in recs:
        arena = rec[family]["arena"]
        # recurrent state has no pages and no mixed step
        assert not arena["overlap"] and not arena["paged"]
        assert arena["overlap_mode"] == ""


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tokens_equal_reference_and_one_process(served, one_process, mesh,
                                                family):
    recs, _ = served[0][mesh]
    got = recs[0][family]["arena"]["outputs"]
    assert got == served[1][family]
    assert got == one_process[family]["arena"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_bytes_equal_serve_step_sends(served, mesh, family):
    recs, _ = served[0][mesh]
    for rec in recs:
        got = rec[family]["arena"]
        assert got["sent"] == got["sent_reckoned"]
        assert got["sent"]["all_reduce"] > 0


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_first_decode_logits_match_one_process(served, one_process, mesh,
                                               family):
    _, logits = served[0][mesh]
    want = one_process[family]["logits"]
    assert logits[family].shape == want.shape
    assert _gap(logits[family], want) <= ATOL
