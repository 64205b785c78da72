"""Rules of the PyTorch port: what it may import, and that no path hides
the device or the kernel."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

from repro_torch.examples import decentralized_lsq, quickstart  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import serve, train, train_async  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_variants.py"]


def _forbidden(module):
    return (module == "jax" or module.startswith("jax.")
            or module == "repro" or module.startswith("repro."))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_port_files_cover_every_package():
    """The import rule scans every package of the port, the optimizers
    and checkpoints among them."""
    packages = {p.parent.name for p in PORT_FILES
                if p.name == "__init__.py"}
    assert {"configs", "core", "data", "dist", "examples", "kernels",
            "launch", "models", "optim", "checkpoint", "serve",
            "utils"} <= packages
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/optim/optimizers.py",
            "src/repro_torch/optim/schedules.py",
            "src/repro_torch/checkpoint/checkpoint.py",
            "src/repro_torch/core/graph.py",
            "src/repro_torch/data/synthetic.py",
            "src/repro_torch/examples/quickstart.py",
            "src/repro_torch/examples/decentralized_lsq.py",
            "src/repro_torch/examples/train_lm_apibcd.py",
            "src/repro_torch/examples/serve_batched.py",
            "src/repro_torch/kernels/costs.py",
            "src/repro_torch/utils/roofline.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/roofline_table.py",
            "src/repro_torch/dist/sharding.py",
            "src/repro_torch/dist/collectives.py",
            "src/repro_torch/launch/mesh.py"} <= names


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.launch.train, repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print('LOADED', len([m for m in sys.modules\n"
        "                     if m.startswith('repro_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED" in res.stdout


def test_train_without_cpu_request_raises_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--smoke", "--steps", "1", "--seq", "8",
                    "--batch-per-agent", "1"])


def test_train_on_cpu_when_asked():
    out = train.main(["--smoke", "--steps", "2", "--seq", "8",
                      "--batch-per-agent", "1", "--device", "cpu",
                      "--log-every", "0"])
    assert out["device"] == "cpu" and len(out["losses"]) == 2
    assert out["peak_bytes"] is None


def test_train_async_without_cpu_request_raises_when_no_gpu(monkeypatch,
                                                          tmp_path):
    """The parent raises before it spawns a process, and a child given
    no --device cpu raises before it touches its transport."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_async.main(["--processes", "2"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_async.main(["--processes", "2", "--process-id", "1",
                          "--transport", "file", "--kv-dir",
                          str(tmp_path / "kv")])
    assert not (tmp_path / "kv").exists()


def test_quickstart_without_cpu_request_raises_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        decentralized_lsq.main(["--figures", "fig3_cpusmall"])


def test_convex_entry_points_raise_when_no_gpu(monkeypatch):
    from repro_torch.core import IBCD, centralized_solution
    from repro_torch.data import make_problem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = make_problem("cpusmall", num_agents=4, subsample=200)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        IBCD(problem, tau=1.0)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        centralized_solution(problem)


def test_quickstart_on_cpu_when_asked(capsys):
    out = quickstart.main(["--device", "cpu", "--max-iterations", "40"])
    printed = capsys.readouterr().out
    assert "cut: 40 of 400" in printed and "simulated time" in printed
    ibcd, apibcd = out["I-BCD"], out["API-BCD"]
    assert ibcd.trace[-1].iteration == apibcd.trace[-1].iteration == 40
    for res in (ibcd, apibcd):
        assert res.trace[-1].metric < res.trace[0].metric
    # 5 walks finish 40 activations in less simulated time than one
    assert apibcd.trace[-1].time < ibcd.trace[-1].time


def test_ops_rejects_devices_without_a_kernel():
    x = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.prox_update(x, x, x, tau=0.1, rho=20.0, num_walks=2,
                        num_agents=4)


def test_serve_without_cpu_request_raises_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--smoke", "--requests", "1", "--prompt-len", "4",
                    "--new-tokens", "2"])


def test_serve_on_cpu_when_asked():
    out = serve.main(["--smoke", "--requests", "4", "--max-batch", "2",
                      "--prompt-len", "8", "--new-tokens", "4", "--mixed",
                      "--device", "cpu"])
    assert out["device"] == "cpu" and out["peak_bytes"] is None
    assert [len(o) for o in out["outputs"]] == out["budgets"] == [1, 4, 1, 4]
    assert out["stats"]["admissions"] == 4
    assert out["stats"]["decode_fetch_dtype"] == "int32"


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "decode_attention_paged",
                                  "decode_attention_ring", "rwkv6_scan",
                                  "rglru_scan"])
def test_attention_ops_reject_devices_without_a_kernel(name):
    q = torch.empty(1, 4, 2, 32, device="meta")
    k = torch.empty(1, 4, 1, 32, device="meta")
    ones = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        if name == "flash_attention":
            ops.flash_attention(q, k, k)
        elif name == "decode_attention":
            ops.decode_attention(q[:, 0], k, k, lengths=ones)
        elif name == "decode_attention_paged":
            ops.decode_attention_paged(q[:, 0], k, k, ones[:, None],
                                       lengths=ones)
        elif name == "rwkv6_scan":
            ops.rwkv6_scan(q, q, q, q, q[0, 0], k)
        elif name == "rglru_scan":
            w = q[0, 0, 0]
            ops.rglru_scan(q[0], q[0], w, w, w, q[0], q[0, 0])
        else:
            ops.decode_attention_ring(q[:, 0], k, k, ones[:, None],
                                      ring_starts=ones, lengths=ones,
                                      window=4)


KERNEL_MODULES = sorted((ROOT / "src" / "repro_torch" / "kernels").glob(
    "*.py"))


@pytest.mark.parametrize("path", KERNEL_MODULES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_kernel_wrappers_have_no_fallback(path):
    """No wrapper or dispatch catches an error to take another route: a
    CUDA tensor goes to the kernel, which launches or raises."""
    tree = ast.parse(path.read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], path


def test_every_kernel_source_is_built():
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert sorted(build.KERNELS) == sources


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "decode_attention_paged", "rwkv6_scan",
                                  "rglru_scan"])
def test_failed_attention_build_raises(monkeypatch, tmp_path, name):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no such target"):
        build.load(name)
    assert not list((tmp_path / "build").glob("*"))


def test_failed_build_raises(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no such target"):
        build.load("prox_update")
    assert not list((tmp_path / "build").glob("*"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_rejects_unsupported_dtype(cuda, dtype):
    x = torch.zeros(16, dtype=dtype, device=cuda)
    g = torch.zeros(16, device=cuda)
    with pytest.raises(TypeError):
        ops.prox_update(x, g, g, tau=0.1, rho=20.0, num_walks=2,
                        num_agents=4)


@pytest.mark.cuda
def test_kernel_rejects_cpu_and_noncontiguous_operands(cuda):
    x = torch.zeros(16, 4, device=cuda)
    with pytest.raises(ValueError):
        ops.prox_update(x, torch.zeros(16, 4), x, tau=0.1, rho=20.0,
                        num_walks=2, num_agents=4)
    with pytest.raises(ValueError):
        ops.prox_update(x.T, x.T, x.T, tau=0.1, rho=20.0, num_walks=2,
                        num_agents=4)


def _attention_operands(cuda, dtype=torch.bfloat16):
    q = torch.zeros(1, 16, 4, 64, dtype=dtype, device=cuda)
    k = torch.zeros(1, 16, 2, 64, dtype=dtype, device=cuda)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda)
    return q, k, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_attention_kernels_reject_unsupported_dtype(cuda, dtype):
    q, k, lengths = _attention_operands(cuda, dtype)
    with pytest.raises(TypeError):
        ops.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        ops.decode_attention(q[:, 0], k, k, lengths=lengths)
    qb, kb, _ = _attention_operands(cuda)
    with pytest.raises(TypeError):      # mixed dtypes
        ops.flash_attention(qb, kb.float(), kb.float())


@pytest.mark.cuda
def test_attention_kernels_reject_cpu_operands_and_bad_shapes(cuda):
    q, k, lengths = _attention_operands(cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], k, k, lengths=lengths.cpu())
    with pytest.raises(ValueError):     # kv heads do not divide q heads
        ops.flash_attention(q[:, :, :3], k, k)
    with pytest.raises(ValueError):     # head_dim mismatch
        ops.decode_attention(q[:, 0, :, :32], k, k, lengths=lengths)
    with pytest.raises(ValueError):     # k and v differ
        ops.flash_attention(q, k, k[:, :8])
    with pytest.raises(TypeError):      # lengths not int32 [B]
        ops.decode_attention(q[:, 0], k, k, lengths=lengths.long())


def _paged_operands(cuda, dtype=torch.bfloat16):
    q = torch.zeros(2, 4, 64, dtype=dtype, device=cuda)
    pool = torch.zeros(5, 8, 2, 64, dtype=dtype, device=cuda)
    tables = torch.ones(2, 2, dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    return q, pool, tables, lengths


@pytest.mark.cuda
def test_paged_kernels_reject_bad_inputs(cuda):
    q, pool, tables, lengths = _paged_operands(cuda)
    starts = torch.zeros_like(lengths)
    paged = ops.decode_attention_paged
    with pytest.raises(TypeError):      # unsupported dtype
        paged(q.half(), pool.half(), pool.half(), tables, lengths=lengths)
    with pytest.raises(TypeError):      # q and pool differ
        paged(q, pool.float(), pool.float(), tables, lengths=lengths)
    with pytest.raises(TypeError):      # tables not int32
        paged(q, pool, pool, tables.long(), lengths=lengths)
    with pytest.raises(TypeError):      # lengths not int32 [B]
        paged(q, pool, pool, tables, lengths=lengths[:1])
    with pytest.raises(ValueError):     # tables on the CPU
        paged(q, pool, pool, tables.cpu(), lengths=lengths)
    with pytest.raises(ValueError):     # tables not contiguous
        paged(q, pool, pool, tables.repeat(1, 2)[:, ::2], lengths=lengths)
    with pytest.raises(ValueError):     # tables rows != batch
        paged(q, pool, pool, tables[:1], lengths=lengths)
    with pytest.raises(ValueError):     # head_dim mismatch
        paged(q[..., :32], pool, pool, tables, lengths=lengths)
    with pytest.raises(ValueError):     # kv heads do not divide q heads
        paged(q[:, :3], pool, pool, tables, lengths=lengths)
    with pytest.raises(ValueError):     # the two pools differ
        paged(q, pool, pool[:4], tables, lengths=lengths)
    ring = ops.decode_attention_ring
    with pytest.raises(ValueError):     # no ring
        ring(q, pool, pool, tables, ring_starts=starts, lengths=lengths,
             window=0)
    with pytest.raises(TypeError):      # ring starts not int32 [B]
        ring(q, pool, pool, tables, ring_starts=starts.long(),
             lengths=lengths, window=16)
    out = ring(q, pool, pool, tables, ring_starts=starts, lengths=lengths,
               window=16)
    assert out.shape == q.shape and out.dtype == q.dtype


@pytest.mark.cuda
def test_rwkv6_kernel_rejects_bad_inputs(cuda):
    b, h, s, hd = 2, 3, 5, 64
    r = torch.zeros(b, h, s, hd, device=cuda)
    w = torch.full((b, h, s, hd), 0.5, device=cuda)
    u = torch.zeros(h, hd, device=cuda)
    state = torch.zeros(b, h, hd, hd, device=cuda)
    scan = ops.rwkv6_scan
    with pytest.raises(TypeError):      # unsupported dtype
        scan(r.half(), r.half(), r.half(), w, u.half(), state)
    with pytest.raises(TypeError):      # r, k, v of two dtypes
        scan(r, r.bfloat16(), r, w, u, state)
    with pytest.raises(TypeError):      # decays not f32
        scan(r, r, r, w.bfloat16(), u, state)
    with pytest.raises(TypeError):      # u not in r's dtype
        scan(r, r, r, w, u.bfloat16(), state)
    with pytest.raises(TypeError):      # state not f32
        scan(r, r, r, w, u, state.bfloat16())
    with pytest.raises(ValueError):     # state on the CPU
        scan(r, r, r, w, u, state.cpu())
    with pytest.raises(ValueError):     # state not contiguous
        scan(r, r, r, w, u, state.transpose(2, 3))
    with pytest.raises(ValueError):     # state of another batch
        scan(r, r, r, w, u, state[:1])
    with pytest.raises(ValueError):     # last dim not contiguous
        scan(r.transpose(2, 3), r, r, w, u, state)
    with pytest.raises(ValueError):     # k of another length
        scan(r, r[:, :, :4], r, w, u, state)
    r128 = torch.zeros(b, h, s, 128, device=cuda)
    with pytest.raises(ValueError):     # head_dim 128
        scan(r128, r128, r128, r128, torch.zeros(h, 128, device=cuda),
             torch.zeros(b, h, 128, 128, device=cuda))


@pytest.mark.cuda
def test_rglru_kernel_rejects_bad_inputs(cuda):
    b, s, w = 2, 5, 64
    x = torch.full((b, s, w), 0.5, device=cuda)
    p = torch.zeros(w, device=cuda)
    state = torch.zeros(b, w, device=cuda)

    def scan(ga=x, gi=x, ba=p, bi=p, lamb=p, xa=x, st=state):
        return ops.rglru_scan(ga, gi, ba, bi, lamb, xa, st)

    with pytest.raises(ValueError):     # a gate on the CPU
        scan(gi=x.cpu())
    with pytest.raises(ValueError):     # state on the CPU
        scan(st=state.cpu())
    with pytest.raises(ValueError):     # a parameter on the CPU
        scan(lamb=p.cpu())
    with pytest.raises(TypeError):      # a compute dtype it does not take
        scan(ga=x.half(), gi=x.half(), ba=p.half(), bi=p.half(),
             lamb=p.half(), xa=x.half())
    with pytest.raises(TypeError):      # a gate in another dtype than xa
        scan(ga=x.bfloat16())
    with pytest.raises(TypeError):      # a parameter in another dtype
        scan(ba=p.bfloat16())
    with pytest.raises(TypeError):      # state not f32
        scan(st=state.bfloat16())
    flat = torch.full((b * s * w + 1,), 0.5, device=cuda)
    with pytest.raises(ValueError):     # misaligned address
        scan(ga=flat[1:].view(b, s, w))
    with pytest.raises(ValueError):     # last dim not contiguous
        t = x.transpose(1, 2)
        scan(ga=t, gi=t, xa=t)
    with pytest.raises(ValueError):     # a gate of another length
        scan(gi=x[:, :4])
    with pytest.raises(ValueError):     # a parameter of another width
        scan(bi=p[:32])
    with pytest.raises(ValueError):     # a parameter not contiguous
        scan(lamb=torch.zeros(2 * w, device=cuda)[::2])
    with pytest.raises(ValueError):     # state of another batch
        scan(st=state[:1])
    with pytest.raises(ValueError):     # state not contiguous
        scan(st=torch.zeros(w, b, device=cuda).T)
    with pytest.raises(ValueError):     # not [B, S, W]
        scan(ga=x[0], gi=x[0], xa=x[0], st=state[0])
    out, st = scan()
    assert out.shape == x.shape and out.dtype == x.dtype and st is state
