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
the device.

The kernel splits the cache across blocks (flash-decoding): each block
takes `split_rows(T, KV, hd)` cache rows of one (batch row, kv head), and
the last block of a row to finish combines the splits' partials in the
same launch. `split_rows` depends on T, KV and hd only, never on B or on
the lengths, so a row's result is bitwise the same alone or in any batch
and the launch needs no host sync. The wrapper checks its inputs,
allocates the output and the partials' scratch with `torch.empty`, takes
one zeroed int32 ticket counter per (batch row, kv head) from the
per-device pool of `tickets.py`, launches on the current stream and
raises if the launch reports an error. `decode_attention_cuda.launches`
counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (HEAD_DIMS, check_int_vector,
                                                 check_operand)
from repro_torch.kernels.tickets import ticket_counters

_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 8
             + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3)
MAX_GROUP_WIDTH = 2560      # (H / KV) * hd: at most 10 outputs per thread
MIN_SPLIT_ROWS = 128        # the fewest cache rows a block takes
MIN_SPLIT_VALUES = 8192     # ... and at least this many K values (hd 32)
MAX_ROW_BLOCKS = 32         # most blocks of one batch row (KV * splits)


def split_rows(t, kv, hd):
    """Cache rows per block of the decode kernel: a multiple of 64, at least
    128 rows and 8192 K values of a head, and as many as keep a batch row
    to at most 32 blocks over its KV heads (so at most 32 splits). It
    depends on T, KV and hd only: never on the batch or the lengths."""
    rows = max(MIN_SPLIT_ROWS, MIN_SPLIT_VALUES // hd,
               -(-t // max(1, MAX_ROW_BLOCKS // kv)))
    return -(-rows // 64) * 64


def num_splits(t, kv, hd):
    """Blocks the kernel gives one (batch row, kv head): ceil(T / rows)."""
    return max(1, -(-t // split_rows(t, kv, hd)))


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
    rows, splits = split_rows(t, kv, hd), num_splits(t, kv, hd)
    partial = tickets = None
    if splits > 1:      # each split's (acc [G, hd], m [G], l [G]) in f32
        partial = torch.empty(b * kv * splits * (h // kv) * (hd + 2),
                              dtype=torch.float32, device=q.device)
        tickets = ticket_counters(q.device, b * kv)
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), b, t, h, kv, hd, *q.stride()[:2],
                 *k.stride()[:3], *v.stride()[:3], scale, rows,
                 None if partial is None else partial.data_ptr(),
                 None if tickets is None else tickets.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
