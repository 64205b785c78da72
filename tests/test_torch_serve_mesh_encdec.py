"""The encoder-decoder and the VLM on the model axis of the port's serving
mesh, through the ported wave steps (`dist.serving.make_prefill_step` /
`make_decode_step`), against the JAX reference's mesh wave path and one
process's raw loop, on the CPU.

`torch_serve_mesh_script.py --wave whisper,whisper515,phi3` runs as 2
gloo processes on the ("data", "model") = (1, 2) mesh and as 4 on
(2, 2), and serves in f32, from the reference's parameters, the raw
loop's batch (`launch.serve.raw_prompt`: prompts and frames or patches)
of whisper-small's smoke config, of the same with an odd vocabulary of
515 (the axis keeps the embedding and the head whole, the lookup and the
argmax local) in 3 rows (which the data axis does not divide: every line
serves them all), and of phi-3-vision's with its patch prefix. Held
here:

  * every rank's tokens equal the reference's `make_prefill_step` /
    `make_decode_step` shardings on its own (2, 2) mesh (4 forced host
    devices, in a subprocess; the caches put back onto the decode step's
    shardings after every step) and one process's `serve_raw`;
  * every rank's bytes equal what `dist.serving.serve_step_sends`
    reckons for a wave prefill and the decode steps (two row sums an
    encoder layer over its frames, three a decoder layer, no embedding
    sum or argmax gather where the vocabulary is whole);
  * the first decode step's logits (an f32 cache) are within 1e-5 of the
    largest |logit| of one process's.
"""
import argparse
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
from repro_torch.launch.serve import serve_raw  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import flatten, params_from_jax  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import torch_serve_mesh_script as script  # noqa: E402

# (processes, model parallel) of each mesh the ranks run
MESHES = {"1x2": (2, 2), "2x2": (4, 2)}
FAMILIES = list(script.WAVE)
ATOL = 1e-5

# the reference's wave path on its (2, 2) mesh: make_prefill_step's and
# make_decode_step's shardings, the prefill at the raw loop's capacity,
# the caches put back onto the decode step's shardings after every step
REFERENCE = r"""
import json, os, sys
sys.path.insert(0, "src")
sys.path.insert(0, "tests")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.dist.serving import make_decode_step, make_prefill_step
from repro.models import build_model
import test_torch_serve_mesh_encdec as test
import torch_serve_mesh_script as script

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
out = {}
for name in script.WAVE:
    flat = np.load(os.path.join(sys.argv[2], f"{name}.npz"))
    model = build_model(test.jax_config(name))

    def leaf(path, _):
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        return jnp.asarray(flat[key])

    params = jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    batch, prefix = script.wave_batch(name)
    batch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    b, p, new = script.WAVE_RUNS[name]
    total = p + prefix + new
    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          batch)
    _, (p_sh, b_sh) = make_prefill_step(model, mesh, shapes)
    prefill = jax.jit(lambda prm, bt: model.prefill(prm, bt,
                                                    cache_len=total),
                      in_shardings=(p_sh, b_sh))
    params = jax.device_put(params, p_sh)
    logits, caches = prefill(params, batch)
    token = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    decode, (_, _, c_sh) = make_decode_step(
        model, mesh, jax.ShapeDtypeStruct(token.shape, token.dtype),
        jax.eval_shape(lambda c: c, caches))
    caches = jax.device_put(caches, c_sh)
    tokens = [token]
    for i in range(new):
        logits, caches = decode(params, token, caches, p + prefix + i)
        caches = jax.device_put(caches, c_sh)
        token = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        tokens.append(token)
    out[name] = np.concatenate([np.asarray(t) for t in tokens], 1).tolist()
json.dump(out, open(sys.argv[1], "w"))
print("REFERENCE_OK")
"""


def jax_config(name):
    """The reference's config of the script's wave family `name`."""
    cfg = script.WAVE[name]
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
    path = tmp_path_factory.mktemp("serve_mesh_encdec")
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
    reference's tokens): both meshes' ranks and the reference's
    subprocess run side by side."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    runs = {}
    for mesh, (world, mp) in MESHES.items():
        out = tmp_path_factory.mktemp(f"serve_mesh_encdec_{mesh}")
        port = _free_port()
        runs[mesh] = (out, [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_serve_mesh_script.py"),
             "--rank", str(r), "--world", str(world), "--model-parallel",
             str(mp), "--coordinator", f"localhost:{port}", "--params",
             str(params[0]), "--out", str(out), "--wave",
             ",".join(FAMILIES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)])
    ref_env = dict(os.environ)
    ref_env.pop("JAX_PLATFORMS", None)
    ref_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    ref_path = tmp_path_factory.mktemp("serve_mesh_encdec_ref") / "r.json"
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
            name: torch.load(out / f"wave.{name}.pt") for name in FAMILIES})
    assert "REFERENCE_OK" in ref.stdout, ref.stdout + ref.stderr
    with open(ref_path) as f:
        reference = json.load(f)
    return records, reference


@pytest.fixture(scope="module")
def one_process(params):
    """{family: {"tokens": `serve_raw`'s, "logits": the first decode
    step's of an f32 cache}} in one process."""
    out = {}
    for name in FAMILIES:
        cfg = script.WAVE[name]
        b, p, new = script.WAVE_RUNS[name]
        args = argparse.Namespace(device="cpu", requests=b, prompt_len=p,
                                  new_tokens=new, layers=0)
        raw = serve_raw(args, cfg=cfg, params=params[1][name])
        model = build_model(cfg)
        batch, prefix = script.wave_batch(name)
        _, logits = script.wave_serve(model, params[1][name], batch, prefix,
                                      1, cache_dtype=torch.float32)
        out[name] = {"tokens": raw["tokens"], "logits": logits()}
    return out


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_tokens_equal_reference_and_serve_raw(served, one_process, mesh,
                                              family):
    recs, _ = served[0][mesh]
    for rec in recs:
        assert rec[family]["tokens"] == served[1][family]
        assert rec[family]["tokens"] == one_process[family]["tokens"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_bytes_equal_serve_step_sends(served, mesh, family):
    recs, _ = served[0][mesh]
    cfg = script.WAVE[family]
    for rec in recs:
        got = rec[family]
        assert got["sent"] == got["sent_reckoned"]
        assert got["sent"]["all_reduce"] > 0
        # a whole vocabulary gathers no argmax over the axis, and 3 rows
        # on every line gather no ids over the data axis
        gathers = cfg.vocab_size % 2 == 0
        assert ("all_gather" in got["sent"]) == (
            gathers or (mesh == "2x2" and script.WAVE_RUNS[family][0] % 2
                        == 0))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_first_decode_logits_match_one_process(served, one_process, mesh,
                                               family):
    _, logits = served[0][mesh]
    want = one_process[family]["logits"]
    assert logits[family].shape == want.shape
    assert _gap(logits[family], want) <= ATOL
