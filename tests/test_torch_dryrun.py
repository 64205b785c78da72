"""The port's one-card dry run (`repro_torch.launch.dryrun`) and its
tables (`repro_torch.launch.roofline_table`).

On the CPU: every shape of qwen2-0.5b and one shape of every other
architecture count on fake tensors, whisper's long_500k is skipped as
the reference skips it, and the CLI writes JSONs the tables read. The
`cuda` tests count the shapes of `chip_smoke.py` phase 48 on the card and
hold them equal to the dry run's fake count (they import no JAX, and run
with --noconftest).
"""
import json

import pytest

torch = pytest.importorskip("torch")
# smoke-size tensors gain nothing from threads; one thread keeps the
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)

from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.launch import dryrun, roofline_table  # noqa: E402
from repro_torch.utils.roofline import HBM_BYTES, StepCost  # noqa: E402

KEYS = ("arch", "shape", "mode", "window", "params", "active_params",
        "model_flops", "roofline", "useful_flop_ratio", "memory_analysis",
        "fits_one_card")


def _check_record(r, arch, shape):
    for key in KEYS:
        assert key in r, key
    assert (r["arch"], r["shape"]) == (arch, shape)
    rl = r["roofline"]
    assert rl["chips"] == 1 and rl["collective_bytes"] == 0
    assert rl["flops"] > 0 and rl["hbm_bytes"] > 0
    assert rl["dominant"] in ("compute", "memory")
    assert 0 < r["useful_flop_ratio"] < 1.5
    mem = r["memory_analysis"]
    assert mem["temp_size_in_bytes"] == "not measured"
    assert r["fits_one_card"] == (mem["argument_size_in_bytes"] <= HBM_BYTES)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_every_qwen2_shape(shape):
    r = dryrun.lower_combo("qwen2-0.5b", shape, verbose=False)
    _check_record(r, "qwen2-0.5b", shape)
    assert r["params"] == r["active_params"] == 494_032_768
    kernels = r["step_cost"]["kernels"]
    kind = INPUT_SHAPES[shape].kind
    if kind == "train":
        assert r["agents"] == 16       # get_train's A = 16: one update
        # kernel call a leaf (the 14 leaves), over all 16 agents
        assert kernels == {"prox_update": {
            "calls": 14, "flops": kernels["prox_update"]["flops"],
            "bytes": kernels["prox_update"]["bytes"]}}
    elif kind == "prefill":
        assert kernels["flash_attention"]["calls"] == 24
    else:
        assert kernels["decode_attention"]["calls"] == 24
        assert r["window"] == (8192 if shape == "long_500k" else 0)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b",
                                  "internlm2-1.8b", "qwen3-8b",
                                  "nemotron-4-15b", "dbrx-132b",
                                  "deepseek-v2-236b", "whisper-small",
                                  "phi-3-vision-4.2b"])
def test_one_shape_of_every_other_arch(arch):
    r = dryrun.lower_combo(arch, "decode_32k", verbose=False)
    _check_record(r, arch, "decode_32k")
    cfg = get_config(arch)
    if cfg.moe is None:
        assert r["active_params"] == r["params"]
    else:
        assert r["active_params"] < r["params"]


def test_whisper_long_context_is_skipped_as_the_reference_skips_it():
    r = dryrun.lower_combo("whisper-small", "long_500k", verbose=False)
    assert r["skipped"].startswith("SKIP: enc-dec decoder")


def test_dp_baseline_counts_one_global_batch():
    shape = ShapeConfig("small_train", 128, 4, "train")
    dp = dryrun.lower_combo("qwen2-0.5b", shape, baseline_dp=True,
                            verbose=False)
    api = dryrun.lower_combo("qwen2-0.5b", shape, train=TrainConfig(
        num_agents=4, num_walks=2, tau=0.05, rho=20.0), verbose=False)
    assert dp["mode"] == "baseline_dp" and api["mode"] == "apibcd"
    assert dp["agents"] is None and api["agents"] == 4
    assert "prox_update" not in dp["step_cost"]["kernels"]
    assert api["step_cost"]["kernels"]["prox_update"]["calls"] == 14
    # the same tokens through one model: the same model FLOPs
    assert dp["model_flops"] == api["model_flops"]


def test_cli_writes_jsons_that_the_tables_read(tmp_path, capsys):
    out = tmp_path / "dry"
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                 "--out-dir", str(out)])
    dryrun.main(["--arch", "whisper-small", "--shape", "long_500k",
                 "--out-dir", str(out)])
    one = json.loads((out / "qwen2-0.5b__decode_32k.json").read_text())
    assert one["params"] == 494_032_768
    printed = capsys.readouterr().out
    assert "counted on fake tensors" in printed and "H100" in printed
    results = roofline_table.load(str(out))
    assert set(results) == {("qwen2-0.5b", "decode_32k", "apibcd"),
                            ("whisper-small", "long_500k", "apibcd")}
    roofline_table.main(["--dir", str(out)])
    table = capsys.readouterr().out
    assert "| qwen2-0.5b | decode_32k |" in table
    assert "*skipped*" in table and "MISSING" in table
    assert "not measured" in table


# ---------------------------------------------------------------------------
# on the card: the card's count equals the dry run's
# ---------------------------------------------------------------------------

# chip_smoke.py phase 48's shapes: the A = 4, M = 2 superstep at 2 x 256
# tokens an agent, an 8-row decode step at a capacity of 512, a 2048-token
# prefill, and rwkv6-1.6b's 8-row decode step
PHASE48 = [
    ("qwen2-0.5b", ShapeConfig("superstep", 256, 8, "train"),
     TrainConfig(num_agents=4, num_walks=2, tau=0.05, rho=20.0)),
    ("qwen2-0.5b", ShapeConfig("decode_b8_t512", 512, 8, "decode"), None),
    ("qwen2-0.5b", ShapeConfig("prefill_s2048", 2048, 1, "prefill"), None),
    ("rwkv6-1.6b", ShapeConfig("decode_b8", 512, 8, "decode"), None),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape,train", PHASE48,
                         ids=[f"{a}-{s.name}" for a, s, _ in PHASE48])
def test_card_count_equals_the_fake_count(cuda, arch, shape, train):
    torch.backends.cuda.matmul.allow_tf32 = False
    combo = dryrun.make_combo(arch, shape, train=train)
    inputs = dryrun.step_inputs(
        combo, device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(0))
    with StepCost() as card:
        dryrun.run_step(combo, inputs)
    torch.cuda.synchronize()
    del inputs
    torch.cuda.empty_cache()
    fake = dryrun.lower_combo(arch, shape, train=train, verbose=False)
    assert card.flops == fake["step_cost"]["flops"]
    assert card.bytes == fake["step_cost"]["bytes"]
    assert card.by_kernel() == fake["step_cost"]["kernels"]
