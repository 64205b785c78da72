"""The port's multi-process async launcher (`repro_torch.launch.
train_async`) on the CPU: real worker processes over the TCPStore and
the file transport, every process agreeing on the shared-estimate
digest, and that digest equal to the threaded runtime's on the same
config (the numerics never see the transport or the process layout)."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import APIBCD  # noqa: E402
from repro_torch.data import make_problem  # noqa: E402
from repro_torch.dist.async_trainer import (  # noqa: E402
    AsyncBCDConfig, run_threaded)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = ["--agents", "6", "--walks", "2", "--rounds", "6",
         "--subsample", "256"]


def _run_train_async(tmp_path, extra, processes=2):
    out = tmp_path / "run.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_async",
         "--processes", str(processes), *SMALL, "--device", "cpu",
         "--timeout", "120", "--out", str(out), *extra],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("ASYNC_BCD_OK") == processes, res.stdout
    digests = [ln.split("digest=")[1] for ln in res.stdout.splitlines()
               if "ASYNC_BCD_OK" in ln]
    assert len(set(digests)) == 1, f"processes disagree: {digests}"
    assert f"[parent] {processes} processes agree" in res.stdout
    with open(out) as f:
        run = json.load(f)
    assert run["digest"] == digests[0] and run["device"] == "cpu"
    assert all(p["device"] == "cpu" and p["peak_bytes"] is None
               for p in run["processes"])
    return run


ASYNC = ["--local-steps", "3", "--max-delay", "2", "--adaptive",
         "--straggle", "1:2.0", "--min-update-ms", "1"]


@pytest.fixture(scope="module")
def threaded_digest():
    """run_threaded on the 2-process config the launcher runs below."""
    problem = make_problem("cpusmall", 6, seed=0, subsample=256)
    cfg = AsyncBCDConfig(num_procs=2, num_agents=6, num_walks=2, rounds=6,
                         local_steps=3, max_delay=2, adaptive=True,
                         speeds=(1.0, 2.0), min_update_s=1e-3)
    res = run_threaded(cfg, [APIBCD(problem, tau=1.0, num_walks=2,
                                    device="cpu") for _ in range(2)])
    assert len({r.digest for r in res}) == 1
    return res[0].digest


@pytest.mark.parametrize("transport", ["tcp", "file"])
def test_two_process_driver(tmp_path, threaded_digest, transport):
    """2 real processes, bounded staleness, adaptive rates, straggler
    injection: both agree, the digest is the threaded runtime's, and
    the straggler took fewer walks per sync."""
    run = _run_train_async(tmp_path, ["--transport", transport, *ASYNC])
    assert run["digest"] == threaded_digest
    assert run["mode"] == "async" and run["transport"] == transport
    assert run["num_processes"] == 2 and run["max_staleness"] <= 2
    assert run["total_comm_events"] > 0
    objs = [r["objective"] for p in run["processes"] for r in p["trace"]]
    assert min(objs) == objs[-1] or min(objs) < objs[0]
    steps = {p["proc"]: p["local_steps"] for p in run["processes"]}
    assert steps[1] < steps[0]


def test_four_process_mid_round_driver(tmp_path):
    """4 processes over the TCPStore, mid-round ingestion, 3x straggler:
    the view lag respects the bound at every ingestion point and deltas
    really were applied between steps."""
    run = _run_train_async(tmp_path, [
        "--mid-round", "--local-steps", "3", "--max-delay", "2",
        "--straggle", "1:3.0", "--min-update-ms", "1"], processes=4)
    assert run["mode"] == "async+mid" and run["transport"] == "tcp"
    assert run["max_staleness"] <= 2 and run["max_view_lag"] <= 2
    assert run["mid_round_ingested"] > 0


def test_four_process_measured_speeds_file_transport(tmp_path):
    """4 processes over the file transport with measured speeds: every
    process agrees on one bucket vector at the rate sync and the
    injected 4x straggler lands in a higher bucket."""
    run = _run_train_async(tmp_path, [
        "--transport", "file", "--measured-speeds", "--rate-rounds", "3",
        "--adaptive", "--local-steps", "2", "--max-delay", "2",
        "--straggle", "2:4.0", "--min-update-ms", "4"], processes=4)
    assert run["mode"] == "async"
    vectors = {tuple(map(tuple, p["speed_buckets"]))
               for p in run["processes"]}
    assert len(vectors) == 1, vectors
    buckets = run["processes"][0]["speed_buckets"][0]
    assert buckets[2] > min(buckets), buckets
    assert all(p["rate_syncs"] == 1 for p in run["processes"])
