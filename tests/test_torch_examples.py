"""The port's two LM examples (`repro_torch.examples.train_lm_apibcd`,
`repro_torch.examples.serve_batched`) on the CPU, and their refusal to run
on the CPU unasked."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

from repro_torch.examples import serve_batched, train_lm_apibcd  # noqa: E402


def test_train_lm_apibcd_tiny_improves_on_cpu(capsys):
    out = train_lm_apibcd.main(["--steps", "12", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "API-BCD: lm-tiny, agents=4, walks=2, steps=12" in printed
    assert "(improved)" in printed and out["improved"]
    assert len(out["losses"]) == 12 and np.all(np.isfinite(out["losses"]))
    assert out["baseline_losses"] is None


def test_train_lm_apibcd_runs_the_dp_baseline(capsys):
    out = train_lm_apibcd.main(["--steps", "2", "--baseline", "--device",
                                "cpu"])
    assert "all-reduce DP baseline" in capsys.readouterr().out
    assert len(out["baseline_losses"]) == 2
    assert np.all(np.isfinite(out["baseline_losses"]))


def test_serve_batched_finishes_every_request_within_its_budget(capsys):
    out = serve_batched.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert out["budgets"] == [12, 3, 12, 3, 12, 3]
    assert [len(out["outputs"][uid]) for uid in range(6)] == out["budgets"]
    assert "6 requests, 45 tokens" in printed
    # short requests leave while long ones decode: fewer steps than waves
    assert out["steps"] < 2 * 12 + 2


def test_examples_raise_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_lm_apibcd.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_batched.main([])
