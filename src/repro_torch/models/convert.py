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
    """The reference's params pytree -> the port's flat dict of CPU tensors,
    in their dtype (bf16 leaves too, as nemotron-4-15b's `param_dtype`
    makes them)."""
    return {k: _tensor(v) for k, v in flatten(tree).items()}


def state_from_jax(state):
    """The reference's API-BCD train state ({"params", "token", "zhat",
    "gacc"}, agent axis leading) -> the port's state of flat dicts."""
    return {name: params_from_jax(state[name])
            for name in ("params", "token", "zhat", "gacc")}


def arena_from_jax(caches):
    """The reference's per-segment caches (a list, numpy leaves) -> the
    port's list of per-segment dicts of CPU tensors, with the same shapes:

      * attention: {"k", "v": [count, B, T, KV, hd], "ptr": int32 [count,
        B] (the slot arena) or [count] (`init_cache`)}, in their dtype;
      * MLA attention: {"ckv": [count, B, T, r], "kpe": [count, B, T,
        rope], "ptr"}, likewise;
      * RWKV6: {"shift", "cm_shift": [count, B, D], "wkv": [count, B, H,
        hd, hd]};
      * RG-LRU: {"conv": [count, B, cw - 1, W], "h": [count, B, W]}.

    Recurrent leaves come back in f32, the dtype the port keeps them in:
    the reference's RWKV6 shifts and RG-LRU conv inputs turn bf16 after a
    bf16 step (each is x's last positions, in the compute dtype), with
    values that f32 holds exactly.

    The encoder-decoder's cache is one dict, not a list, {"k", "v": [L,
    B, T, KV, hd], "ptr": [L], "ek", "ev": [L, B, T_enc, H, hd]}; it comes
    back as the port's dict with the same leaves."""
    if isinstance(caches, dict):
        if set(caches) != {"k", "v", "ptr", "ek", "ev"}:
            raise ValueError(f"not an encoder-decoder cache: leaves "
                             f"{sorted(caches)}")
        out = {k: _tensor(v) for k, v in caches.items()}
        out["ptr"] = out["ptr"].to(torch.int32)
        return out
    out = []
    for seg in caches:
        names = set(seg)
        if names in ({"shift", "wkv", "cm_shift"}, {"conv", "h"}):
            out.append({k: _tensor(v).float() for k, v in seg.items()})
        elif names in ({"k", "v", "ptr"}, {"ckv", "kpe", "ptr"}):
            tensors = {k: _tensor(v) for k, v in seg.items()}
            tensors["ptr"] = tensors["ptr"].to(torch.int32)
            out.append(tensors)
        else:
            raise ValueError(f"not a GQA or MLA cache, an RWKV6 state or an "
                             f"RG-LRU state: leaves {sorted(names)}")
    return out


def pool_from_jax(pools):
    """The reference's paged pool (a list of per-segment {"k", "v": [count,
    NB + 1, bs, KV, hd]}, or MLA's {"ckv": [count, NB + 1, bs, r], "kpe":
    [count, NB + 1, bs, rope]}, numpy leaves) -> the port's list of dicts
    of CPU tensors with the same shapes and dtypes (block 0 is the null
    block in both)."""
    out = []
    for seg in pools:
        if set(seg) not in ({"k", "v"}, {"ckv", "kpe"}):
            raise ValueError(f"not a GQA or MLA pool: leaves {sorted(seg)}")
        out.append({k: _tensor(v) for k, v in seg.items()})
    return out


def _tensor(a):
    """A CPU tensor copy of an array; bf16 (numpy's ml_dtypes) goes
    through f32, which holds every bf16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))
