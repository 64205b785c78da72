"""Learning-rate schedules (pure functions of the step index).

The port of `repro/optim/schedules.py`. Each returns the rate as an f32
0-dim CPU tensor, computed in f32 as the reference's jitted step computes
it from an int32 step.
"""
from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr):
    return lambda step: _f32(lr)


def cosine_decay(lr, total_steps, final_fraction=0.1):
    def f(step):
        frac = torch.clamp(_f32(step) / _f32(max(total_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return lr * (final_fraction + (1 - final_fraction) * cos)
    return f


def warmup_cosine(lr, warmup_steps, total_steps, final_fraction=0.1):
    decay = cosine_decay(lr, max(total_steps - warmup_steps, 1),
                         final_fraction)

    def f(step):
        if step < warmup_steps:
            return lr * _f32(step) / _f32(max(warmup_steps, 1))
        return decay(step - warmup_steps)
    return f
