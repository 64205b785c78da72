"""Convert the reference's parameter and train-state pytrees to the port's.

The reference nests dicts and lists ({"segments": [{"attn": {"wq": ...}}]});
the port keys one flat dict by the dotted path of each leaf
("segments.0.attn.wq"), with the same shapes and leaf layout. The inputs
are numpy arrays (or anything `np.asarray` takes), so this module needs
no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def flatten(tree, prefix=""):
    """{dotted path: np.ndarray} for every leaf of a nested dict/list."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def params_from_jax(tree):
    """The reference's params pytree -> the port's flat dict of CPU tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in flatten(tree).items()}


def state_from_jax(state):
    """The reference's API-BCD train state ({"params", "token", "zhat",
    "gacc"}, agent axis leading) -> the port's state of flat dicts."""
    return {name: params_from_jax(state[name])
            for name in ("params", "token", "zhat", "gacc")}
