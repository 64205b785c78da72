"""MoE and MLA on the model axis of the port's serving mesh (experts split
over "model", MLA heads split with the whole latent cache on each rank)
against the JAX reference and one process, on the CPU.

`torch_serve_mesh_script.py --arch dbrx,deepseek,mla` runs as 2 gloo
processes on the ("data", "model") = (1, 2) mesh and as 4 on (2, 2), and
serves in f32, from the reference's parameters, dbrx-132b's and
deepseek-v2-236b's smoke configs (the serialized arena, prompts at their
exact lengths, as one process serves MoE) and a dense MLA stack (the
arena and the pool, overlapped and serialized, and a pool too small for
its requests, which preempts). Held here:

  * every rank serves the same tokens, the MLA stack's overlapped
    scheduler ("fused" on (1, 2), "async" on (2, 2)) the serialized
    one's and its pools the arena's;
  * the tokens equal the reference's Engine on its own (2, 2) mesh (4
    forced host devices, in a subprocess) and the port's one-process
    engine's;
  * the scarce pool preempts and returns every block;
  * every rank's bytes equal what `dist.serving.serve_step_sends`
    reckons for the steps it ran (the MoE layers' sums among them);
  * the first decode step's logits are within 1e-5 of the largest
    |logit| of one process's;
  * a prefill whose MoE layers drop slots at capacity drops the slots
    one process drops, on every rank, and gives one process's logits.
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
from repro.configs.base import MLAConfig as JaxMLAConfig  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import flatten, params_from_jax  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_serve_mesh_script as script  # noqa: E402

# (processes, model parallel) of each mesh the ranks run
MESHES = {"1x2": (2, 2), "2x2": (4, 2)}
FAMILIES = list(script.FAMILIES)
MOE = ("dbrx", "deepseek")
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
import test_torch_serve_mesh_moe as test
import torch_serve_mesh_script as script

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for name in script.FAMILIES:
    flat = np.load(os.path.join(sys.argv[2], f"{name}.npz"))
    model = build_model(test.jax_config(name))

    def leaf(path, _):
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        return jnp.asarray(flat[key])

    params = jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    prompts, budgets = script.family_workloads(
        script.FAMILIES[name].vocab_size)["family"]
    eng = Engine(model, params, max_batch=2, max_len=32,
                 cache_dtype=jnp.float32, mesh=mesh)
    for p, b in zip(prompts, budgets):
        eng.submit(p, max_new_tokens=b)
    out[name] = {str(r.uid): r.output.tolist() for r in eng.run()}
json.dump(out, open(sys.argv[1], "w"))
print("REFERENCE_OK")
"""


def jax_config(name):
    """The reference's config of the script's family `name`."""
    cfg = script.FAMILIES[name]
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    if cfg.moe is not None:
        fields["moe"] = JaxMoEConfig(**dataclasses.asdict(cfg.moe))
    if cfg.mla is not None:
        fields["mla"] = JaxMLAConfig(**dataclasses.asdict(cfg.mla))
    return JaxArchConfig(**fields)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """(the directory of each family's .npz of the reference's init, the
    ranks load, {family: the port's params})."""
    path = tmp_path_factory.mktemp("serve_mesh_moe")
    port = {}
    for name in FAMILIES:
        jparams = jax_build_model(jax_config(name)).init(
            jax.random.PRNGKey(0))
        np.savez(path / f"{name}.npz", **flatten(jparams))
        port[name] = params_from_jax(jparams)
    return path, port


@pytest.fixture(scope="module")
def served(params, tmp_path_factory):
    """({mesh: (each rank's record, {family: its logits}, {family: its
    drops prefill's logits})}, the reference's outputs): both meshes'
    ranks and the reference's subprocess run side by side."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    runs = {}
    for mesh, (world, mp) in MESHES.items():
        out = tmp_path_factory.mktemp(f"serve_mesh_moe_{mesh}")
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
    ref_path = tmp_path_factory.mktemp("serve_mesh_moe_ref") / "ref.json"
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
            name: torch.load(out / f"logits.{name}.pt") for name in FAMILIES},
            {name: torch.load(out / f"drops.{name}.pt") for name in FAMILIES})
    assert "REFERENCE_OK" in ref.stdout, ref.stdout + ref.stderr
    with open(ref_path) as f:
        reference = json.load(f)
    return records, reference


@pytest.fixture(scope="module")
def one_process(params):
    """{family: {scenario: tokens by uid, "logits", "drops",
    "drop_logits"}} of the port's one-process engine and steps."""
    out = {}
    for name in FAMILIES:
        cfg = script.FAMILIES[name]
        model = build_model(cfg)
        p = params[1][name]
        loads = script.family_workloads(cfg.vocab_size)
        got = {}
        for scenario, (load, kw) in script.SCENARIOS_OF[name].items():
            prompts, budgets = loads[load]
            _, outputs = script.serve(model, p, prompts, budgets, **kw)
            got[scenario] = {str(u): t for u, t in outputs.items()}
        got["logits"] = script.first_decode_logits(
            model, p, loads["family"][0][:2], 32)
        with script.DropCount() as drops:
            got["drop_logits"] = script.first_decode_logits(
                model, p, loads["drops"][0], 64)
        got["drops"] = drops.calls
        out[name] = got
    return out


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_ranks_agree_and_overlapped_equals_serialized(served, mesh, family):
    recs, _, _ = served[0][mesh]
    scenarios = script.SCENARIOS_OF[family]
    for other in recs[1:]:
        for name in scenarios:
            assert (other[family][name]["outputs"]
                    == recs[0][family][name]["outputs"]), name
    rec = recs[0][family]
    if family in MOE:
        # MoE serves from the serialized arena, as in one process
        assert not rec["arena"]["overlap"] and not rec["arena"]["paged"]
        return
    mode = "fused" if mesh == "1x2" else "async"
    assert rec["arena"]["overlap_mode"] == mode
    assert rec["paged"]["overlap_mode"] == mode
    assert rec["arena_serialized"]["overlap_mode"] == ""
    assert rec["paged"]["paged"] and rec["scarce_paged"]["paged"]
    for name in scenarios:
        load = scenarios[name][0]
        base = "arena" if load == "family" else "scarce_paged"
        assert rec[name]["outputs"] == rec[base]["outputs"], name
    assert rec["paged"]["outputs"] == rec["arena"]["outputs"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tokens_equal_reference_and_one_process(served, one_process, mesh,
                                                family):
    recs, _, _ = served[0][mesh]
    reference = served[1][family]
    rec = recs[0][family]
    assert rec["arena"]["outputs"] == reference
    for name, want in one_process[family].items():
        if name in script.SCENARIOS_OF[family]:
            assert rec[name]["outputs"] == want, name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mla_scarce_pool_preempts_and_returns_blocks(served, mesh):
    recs, _, _ = served[0][mesh]
    world, mp = MESHES[mesh]
    for rec in recs:
        scarce = rec["mla"]["scarce_paged"]
        assert scarce["preemptions"] > 0
        assert scarce["free_blocks"] == scarce["num_blocks"]
    # the preemptions of each line's rows add up to the pool's
    per_line = [recs[r * mp]["mla"]["scarce_paged"]["line_preemptions"]
                for r in range(world // mp)]
    assert sum(per_line) == recs[0]["mla"]["scarce_paged"]["preemptions"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_bytes_equal_serve_step_sends(served, mesh, family):
    recs, _, _ = served[0][mesh]
    reckoned = 0
    for rec in recs:
        for name, got in rec[family].items():
            if name == "drops" or "sent_reckoned" not in got:
                continue
            assert got["sent"] == got["sent_reckoned"], name
            assert got["sent"]["all_reduce"] > 0
            reckoned += 1
    # every MoE scenario and every serialized MLA one is reckoned
    assert reckoned >= len(recs) * (1 if family in MOE else 2)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_first_decode_logits_match_one_process(served, one_process, mesh,
                                               family):
    _, logits, _ = served[0][mesh]
    want = one_process[family]["logits"]
    assert logits[family].shape == want.shape
    assert _gap(logits[family], want) <= ATOL


@pytest.mark.parametrize("family", MOE)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_drops_at_capacity_equal_one_process(served, one_process, mesh,
                                                 family):
    recs, _, drop_logits = served[0][mesh]
    want = one_process[family]["drops"]
    layers = script.FAMILIES[family].num_layers
    # the two prefills' MoE calls, then the decode step's
    assert len(want) == 3 * layers and sum(want[:2 * layers]) > 0
    lines = MESHES[mesh][0] // MESHES[mesh][1]
    for r, rec in enumerate(recs):
        got = rec[family]["drops"]
        if lines == 1:
            assert got == want
        else:
            # a line prefills its own row: prompt r // mp's calls
            row = r // MESHES[mesh][1]
            assert got[:layers] == want[row * layers:(row + 1) * layers]
    assert _gap(drop_logits[family], one_process[family]["drop_logits"]
                ) <= ATOL
