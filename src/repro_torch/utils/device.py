"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def resolve_device(name="cuda"):
    """`torch.device(name)`: the card unless the caller names the CPU. No
    path falls back to the CPU; asking for the card where there is none
    raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "(device=\"cpu\" from Python) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device
