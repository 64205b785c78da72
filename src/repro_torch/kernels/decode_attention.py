"""One-token grouped-query decode attention: the Hopper kernel's wrapper.

The kernel (`csrc/decode_attention.cu`, CUDA C++ for sm_90a, bound with
ctypes) replaces the TPU kernel `repro/kernels/decode_attention.py:
decode_attention_grouped`: all G query heads of a kv head attend together
over the valid rows of a linear cache, masked per batch row by
`lengths`, with the TPU kernel's numerics (-1e30, invalid V rows zeroed,
f32 running max, sum and accumulator, out = acc / max(l, 1e-30)). It reads
q [B, H, hd] and the arena's k, v [B, T, KV, hd] through their strides
(the JAX wrapper transposes the cache to [B*KV, T, hd] first, which on the
card would copy a layer's whole arena each step), and reads `lengths` on
the device. The wrapper checks its inputs, allocates the output with
`torch.empty`, launches on the current stream and raises if the launch
reports an error. `decode_attention_cuda.launches` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (HEAD_DIMS, check_int_vector,
                                                 check_operand)

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 8
             + [ctypes.c_float, ctypes.c_void_p])
MAX_GROUP_WIDTH = 2560      # (H / KV) * hd: at most 10 outputs per thread


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    """The typed ctypes function for dtype, set up once per dtype."""
    fn = getattr(build.load("decode_attention"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_inputs(q, k, v, lengths):
    """Raise unless q [B,H,hd], k and v [B,T,KV,hd] and int32 lengths [B]
    fit the kernel."""
    check_operand("decode_attention", "q", q, 3, q.device, q.dtype)
    for name, t in (("k", k), ("v", v)):
        check_operand("decode_attention", name, t, 4, q.device, q.dtype)
    b, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"decode_attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         "match as [B,H,hd], [B,T,KV,hd]")
    kv = k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"decode_attention kernel: {h} query heads are not "
                         f"a multiple of {kv} kv heads")
    if hd not in HEAD_DIMS or (h // kv) * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention kernel: head_dim {hd} with "
                         f"{h // kv} heads per kv head is not supported "
                         f"(head_dim in {HEAD_DIMS}, G * head_dim <= "
                         f"{MAX_GROUP_WIDTH})")
    check_int_vector("decode_attention", "lengths", lengths, (b,), q.device)


def decode_attention_cuda(q, k, v, *, lengths, scale=None):
    """Launch the kernel on CUDA tensors. Returns a new [B,H,hd] tensor in
    q's dtype."""
    check_inputs(q, k, v, lengths)
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else float(1.0 / math.sqrt(hd))
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), b, t, h, kv, hd, *q.stride()[:2],
                 *k.stride()[:3], *v.stride()[:3], scale, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
