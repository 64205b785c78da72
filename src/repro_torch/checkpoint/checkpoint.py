"""State checkpointing in the reference's on-disk format.

The port of `repro/checkpoint/checkpoint.py`. A checkpoint is a
directory holding `arrays.npz`, one array per leaf keyed by the leaf's
"/"-joined path, and `meta.json` with `step`, `keys`, `metadata` and a
`treedef` string. The port's state is a tree of dicts (and lists or
tuples) over its flat parameter dicts, whose keys are dotted paths; a
leaf's key is its path with every "." turned to "/", so that
`state["params"]["segments.0.attn.wq"]` is stored as
"params/segments/0/attn/wq", the key the reference writes for the same
leaf. Either package loads the other's checkpoint by key into a template;
neither reads `treedef` back.

bf16 leaves: numpy has no bf16, and the reference saves its `ml_dtypes`
bf16 arrays as raw 2-byte records (`|V2`). The port writes a bf16 leaf
as its bits in the same `|V2` records, and reads `|V2` records into a
bf16 template leaf as bf16 bits. It never writes a bf16 leaf as `<u2`,
which the reference would convert as integer values.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

_BF16_RECORD = np.dtype("V2")


def _items(tree):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    return None


def _flatten_with_paths(tree, prefix=""):
    """{"/"-joined path: tensor} for every tensor leaf of a tree of dicts,
    lists and tuples; a dotted key counts as its parts."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        key = str(k).replace(".", "/")
        out.update(_flatten_with_paths(v, f"{prefix}/{key}" if prefix
                                       else key))
    return out


def _treedef(tree):
    """The tree's structure as a string (the port's own; nothing reads it
    back)."""
    items = _items(tree)
    if items is None:
        return "*"
    inner = ", ".join(f"{k!r}: {_treedef(v)}" for k, v in items)
    if isinstance(tree, dict):
        return "{" + inner + "}"
    return ("[" + inner + "]" if isinstance(tree, list)
            else "(" + inner + ")")


def _to_numpy(t):
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _from_numpy(arr, like):
    """arr as a tensor of `like`'s dtype on `like`'s device."""
    if like.dtype == torch.bfloat16 and arr.dtype == _BF16_RECORD:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = t.view(torch.bfloat16)
    elif arr.dtype.kind == "V":
        raise TypeError(f"raw {arr.dtype} records load only into a bf16 "
                        f"leaf, not {like.dtype}")
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(like.dtype)
    return t.to(like.device).reshape(like.shape)


def save_checkpoint(path: str, state, step: int = 0, metadata=None):
    """Write state to `<path>` (a directory)."""
    os.makedirs(path, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten_with_paths(state).items()}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    meta = {"step": int(step), "treedef": _treedef(state),
            "keys": list(arrays.keys()), "metadata": metadata or {}}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def _unflatten_like(like, data, prefix=""):
    items = _items(like)
    if items is None:
        return _from_numpy(data[prefix], torch.as_tensor(like))
    out = {}
    for k, v in items:
        key = str(k).replace(".", "/")
        out[k] = _unflatten_like(v, data, f"{prefix}/{key}" if prefix
                                 else key)
    if isinstance(like, dict):
        return out
    return type(like)(out[i] for i in range(len(like)))


def load_checkpoint(path: str, like):
    """Restore into the structure of `like` (a template tree): each leaf
    takes the template leaf's dtype and device.

    Returns (state, step)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        state = _unflatten_like(like, data)
    return state, meta["step"]
