"""Plain PyTorch versions of the port's kernels (the correctness oracles).

The CPU path runs these; on the card `chip_smoke.py` holds each kernel
against them on the same inputs.
"""
from __future__ import annotations

import torch


def prox_update(x, g, zsum, *, tau, rho, num_walks, num_agents):
    """gAPI-BCD closed form (eq. 15) + incremental token delta (eq. 12b).

    x_new = (rho*x - g + tau*zsum) / (rho + tau*M), delta = (x_new - x)/N,
    in f32. Returns (x_new in x.dtype, delta in f32).

    Both divisions take a 0-dim tensor on x's device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which is
    not the IEEE quotient the reference and the kernel compute.
    """
    denom = torch.tensor(rho + tau * num_walks, dtype=torch.float32,
                         device=x.device)
    n = torch.tensor(float(num_agents), dtype=torch.float32, device=x.device)
    xf = x.float()
    x_new = (rho * xf - g.float() + tau * zsum.float()) / denom
    delta = (x_new - xf) / n
    return x_new.to(x.dtype), delta
