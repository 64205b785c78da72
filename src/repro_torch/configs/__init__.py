"""Config registry of the port: one module per ported architecture.

`get_config(name)` -> full ArchConfig; `get_smoke(name)` -> the reduced
variant for CPU tests; `get_train(name)` -> the architecture's API-BCD
TrainConfig defaults. All ten of the reference's architectures are
registered.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, INPUT_SHAPES, MLAConfig, MoEConfig, ShapeConfig, TrainConfig,
)

# user-facing ids -> module names
ARCH_IDS = {
    "qwen2-0.5b": "qwen2_0p5b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internlm2-1.8b": "internlm2_1p8b",
    "qwen3-8b": "qwen3_8b",
    "nemotron-4-15b": "nemotron4_15b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "whisper-small": "whisper_small",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
}


def _module(name: str):
    mod_name = ARCH_IDS.get(name, name)
    if mod_name not in ARCH_IDS.values():
        raise ValueError(f"architecture {name!r} is not ported to "
                         f"repro_torch yet; ported: {sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


def get_train(name: str) -> TrainConfig:
    return getattr(_module(name), "TRAIN", TrainConfig())
