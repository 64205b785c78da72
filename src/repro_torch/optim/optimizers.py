"""Minimal functional optimizers (the all-reduce DP baseline uses these;
API-BCD's gAPI update is stateless and lives in repro_torch.dist.trainer).

The port of `repro/optim/optimizers.py`: an `Optimizer` is a pair of pure
functions over the port's flat parameter dicts ({dotted path: tensor}),
not a `torch.optim` object, so that its state is a plain tree that a
checkpoint carries leaf for leaf. The reference's order of operations is
kept, so that f32 results agree to round-off: updates are f32 (the
rate is an f32 scalar, which promotes every leaf's update to f32, as jnp
does), Adam's moments are f32 whatever the parameter's dtype, and
`apply_updates` casts each update to its parameter's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable            # params -> opt_state
    update: Callable          # (grads, opt_state, params, lr) -> (updates, opt_state)


def _rate(lr, like):
    """The rate as an f32 0-dim tensor on `like`'s device."""
    return torch.as_tensor(lr, dtype=torch.float32, device=like.device)


def sgd(momentum: float = 0.0):
    """State: () without momentum, else a velocity per leaf in the
    leaf's dtype (m <- momentum * m + g; update -lr * m). `momentum` is
    taken in the leaf's dtype, as jnp takes a Python scalar: bf16(0.9)
    for a bf16 velocity."""
    def init(params):
        if momentum == 0.0:
            return ()
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(grads, state, params, lr):
        del params
        if momentum == 0.0:
            return {k: -_rate(lr, g) * g.float() for k, g in grads.items()}, ()
        new_state = {k: torch.as_tensor(momentum, dtype=m.dtype,
                                        device=m.device) * m + grads[k]
                     for k, m in state.items()}
        return ({k: -_rate(lr, m) * m.float() for k, m in new_state.items()},
                new_state)

    return Optimizer(init, update)


def adam(b1=0.9, b2=0.999, eps=1e-8):
    """State {"mu", "nu": f32 per leaf, "count": int32 0-dim}; bias
    correction from `count` in f32, eps added after sqrt(nu / c2)."""
    def init(params):
        z = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
        device = next(iter(params.values())).device if params else None
        return {"mu": z, "nu": {k: torch.zeros_like(v) for k, v in z.items()},
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params, lr):
        del params
        count = state["count"] + 1
        mu = {k: b1 * m + (1 - b1) * grads[k].to(m.dtype)
              for k, m in state["mu"].items()}
        nu = {k: b2 * v + (1 - b2) * torch.square(grads[k].to(v.dtype))
              for k, v in state["nu"].items()}
        # on the moments' device: CUDA divides by a CPU scalar through its
        # reciprocal, not the IEEE quotient
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        upd = {k: -_rate(lr, m) * (m / c1) / (torch.sqrt(nu[k] / c2) + eps)
               for k, m in mu.items()}
        return upd, {"mu": mu, "nu": nu, "count": count}

    return Optimizer(init, update)


def adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01):
    """adam with decoupled weight decay u - lr * wd * p, on the old p."""
    base = adam(b1, b2, eps)

    def update(grads, state, params, lr):
        upd, state = base.update(grads, state, params, lr)
        upd = {k: u - (_rate(lr, u) * weight_decay) * params[k].to(u.dtype)
               for k, u in upd.items()}
        return upd, state

    return Optimizer(base.init, update)


def apply_updates(params, updates):
    """p + u, the update cast to the parameter's dtype first."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}
