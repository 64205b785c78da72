"""Convert the reference's parameter, train-state, cache and paged-pool
pytrees to the port's.

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


def arena_from_jax(caches):
    """The reference's slot arena (a one-segment list [{"k", "v": [L, B, T,
    KV, hd], "ptr": int32 [L, B]}], numpy leaves) -> the port's arena dict
    of CPU tensors with the same shapes and dtypes. Also takes a cache
    from `init_cache` (ptr [L]), and an RWKV6 stack's recurrent state
    ({"shift", "cm_shift": [L, B, D], "wkv": [L, B, H, hd, hd]}), which
    comes back in f32: the reference's shifts turn bf16 after a bf16
    decode step (the scan emits x's last position in the compute dtype),
    with values that f32 holds exactly, and the port keeps f32."""
    if isinstance(caches, (list, tuple)):
        if len(caches) != 1:
            raise ValueError(f"the port runs one homogeneous segment; the "
                             f"cache has {len(caches)}")
        caches = caches[0]
    if set(caches) == {"shift", "wkv", "cm_shift"}:
        return {k: _tensor(v).float() for k, v in caches.items()}
    if set(caches) != {"k", "v", "ptr"}:
        raise ValueError(f"not a GQA cache or an RWKV6 state: leaves "
                         f"{sorted(caches)}")
    out = {k: _tensor(v) for k, v in caches.items()}
    out["ptr"] = out["ptr"].to(torch.int32)
    return out


def pool_from_jax(pools):
    """The reference's paged pool (a one-segment list [{"k", "v": [L, NB +
    1, bs, KV, hd]}], numpy leaves) -> the port's pool dict of CPU tensors
    with the same shapes and dtypes (block 0 is the null block in both)."""
    if isinstance(pools, (list, tuple)):
        if len(pools) != 1:
            raise ValueError(f"the port runs one homogeneous segment; the "
                             f"pool has {len(pools)}")
        pools = pools[0]
    if set(pools) != {"k", "v"}:
        raise ValueError(f"not a GQA pool: leaves {sorted(pools)}")
    return {k: _tensor(v) for k, v in pools.items()}


def _tensor(a):
    """A CPU tensor copy of an array; bf16 (numpy's ml_dtypes) goes
    through f32, which holds every bf16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))
