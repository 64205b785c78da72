"""Causal / sliding-window GQA prefill attention: the Hopper kernel's wrapper.

The kernel (`csrc/flash_attention.cu`, CUDA C++ for sm_90a, bound with
ctypes) replaces the TPU kernel `repro/kernels/flash_attention.py:
flash_attention_bhsd`: online-softmax attention with masked logits at
-1e30, f32 running max, sum and accumulator, and out = acc / max(l,
1e-30). It reads q [B, S, H, hd] and k, v [B, T, KV, hd] through their
strides, so the model's layouts go in as they are (the JAX wrapper
transposes to [B*H, S, hd] first). The wrapper checks its inputs,
allocates the output with `torch.empty`, launches on the current stream
and raises if the launch reports an error. `flash_attention_cuda.
launches` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 9
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
HEAD_DIMS = (32, 64, 96, 128, 256)


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    """The typed ctypes function for dtype, set up once per dtype."""
    fn = getattr(build.load("flash_attention"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_operand(kernel, name, t, ndim, device, dtype):
    """Raise unless `t` is an `ndim`-dim CUDA tensor on `device` of
    `dtype` (float32 or bfloat16) whose last dim is contiguous and whose
    address and strides are 16-byte aligned (the kernels load 16 bytes
    per thread)."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{kernel} kernel: {name} is on {t.device}, "
                         f"expected the CUDA device {device}")
    if t.dtype not in _ENTRY:
        raise TypeError(f"{kernel} kernel: {name} is {t.dtype}; it takes "
                        "float32 or bfloat16")
    if t.dtype != dtype:
        raise TypeError(f"{kernel} kernel: {name} is {t.dtype}, expected "
                        f"{dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{kernel} kernel: {name} has shape "
                         f"{tuple(t.shape)}, expected {ndim} dims")
    size = t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s * size % 16 for s, n in zip(t.stride()[:-1],
                                                  t.shape[:-1]) if n > 1)):
        raise ValueError(f"{kernel} kernel: {name} needs a contiguous last "
                         "dim and 16-byte aligned address and strides, got "
                         f"strides {t.stride()}")


def check_int_vector(kernel, name, t, shape, device):
    """Raise unless `t` is a contiguous int32 tensor of `shape` on
    `device` (lengths, ring starts, block tables)."""
    if t.device != device:
        raise ValueError(f"{kernel} kernel: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{kernel} kernel: {name} must be int32 "
                        f"{list(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel} kernel: {name} is not contiguous")


def check_inputs(q, k, v):
    """Raise unless q [B,S,H,hd], k and v [B,T,KV,hd] fit the kernel."""
    for name, t, nd in (("q", q, 4), ("k", k, 4), ("v", v, 4)):
        check_operand("flash_attention", name, t, nd, q.device, q.dtype)
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         "match as [B,S,H,hd], [B,T,KV,hd]")
    if k.shape[1] == 0:
        raise ValueError("flash_attention kernel: k and v hold no position")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash_attention kernel: {h} query heads are not "
                         f"a multiple of {k.shape[2]} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {hd} is not one "
                         f"of {HEAD_DIMS}")


def flash_attention_cuda(q, k, v, *, causal=True, window=0, scale=None):
    """Launch the kernel on CUDA tensors. Returns a new [B,S,H,hd] tensor
    in q's dtype."""
    check_inputs(q, k, v)
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else float(1.0 / math.sqrt(hd))
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, s, t, h, kv, hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], int(causal), int(window), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
