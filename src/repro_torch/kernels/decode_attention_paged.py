"""One-token grouped-query decode attention against a paged KV pool and
over a sliding-window ring of pool blocks: the Hopper kernel's wrappers.

The kernel (`csrc/decode_attention_paged.cu`, CUDA C++ for sm_90a, bound
with ctypes) replaces two TPU kernels of `repro/kernels/
decode_attention.py`: `decode_attention_paged_grouped` (row b's logical
position p is row p % bs of pool block tables[b, p // bs]; positions
below lengths[b] are valid) and `decode_attention_ring_grouped` (ring
block bi of row b is table entry (starts[b] + bi) % W; ring slots below
min(lengths[b], window) are valid, of the W * bs the table covers). Both
keep the linear decode kernel's
numerics (-1e30, invalid V rows zeroed, f32 running max, sum and
accumulator, out = acc / max(l, 1e-30)) and read q [B, H, hd] and the
pool's layer slice [NB, bs, KV, hd] through their strides; the tables,
ring starts and lengths are read on the device. The JAX wrappers repeat
the tables per kv head for a [B*KV] grid; here a block reads the row's
table directly.

Like the linear decode kernel, it splits a row's cache across blocks:
each block takes `paged_split_rows(hd)` logical rows (ring slots) of one
(batch row, kv head), looks up their block ids once, and the last block
of a row to finish combines the splits' partials in the same launch. The
chunk depends on hd only, never on the table's width (which the serving
engine changes as rows join, leave and grow), the batch or the lengths,
so a row's result is bitwise the same under any table width and in any
batch. Each wrapper checks its inputs, allocates the output and the
partials' scratch with `torch.empty`, shares the linear kernel's zeroed
per-device ticket counters, launches on the current stream and raises
if the launch reports an error; `.launches` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (MAX_GROUP_WIDTH,
                                                  MIN_SPLIT_ROWS,
                                                  MIN_SPLIT_VALUES)
from repro_torch.kernels.flash_attention import (HEAD_DIMS, check_int_vector,
                                                 check_operand)
from repro_torch.kernels.tickets import ticket_counters

_ENTRY = {torch.float32: "decode_attention_paged_f32",
          torch.bfloat16: "decode_attention_paged_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_int64] * 8
             + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3)


def paged_split_rows(hd):
    """Logical rows (ring slots) per block of the paged and ring kernels:
    the linear kernel's floor, at least 128 rows and 8192 K values of a
    head, a multiple of 64. It depends on hd only: never on the table's
    width, the batch or the lengths."""
    rows = max(MIN_SPLIT_ROWS, MIN_SPLIT_VALUES // hd)
    return -(-rows // 64) * 64


def paged_num_splits(cap, hd):
    """Blocks the kernel gives one (batch row, kv head) whose rows can
    reach `cap` (W * bs, or min(window, W * bs) for a ring)."""
    return max(1, -(-cap // paged_split_rows(hd)))


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    """The typed ctypes function for dtype, set up once per dtype."""
    fn = getattr(build.load("decode_attention_paged"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_inputs(kernel, q, k_pool, v_pool, block_tables, lengths,
                 ring_starts=None):
    """Raise unless q [B,H,hd], the pools [NB,bs,KV,hd], int32 tables
    [B,W] and int32 lengths (and ring starts) [B] fit the kernel."""
    check_operand(kernel, "q", q, 3, q.device, q.dtype)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        check_operand(kernel, name, t, 4, q.device, q.dtype)
    b, h, hd = q.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != hd:
        raise ValueError(f"{kernel} kernel: q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)} and v_pool "
                         f"{tuple(v_pool.shape)} do not match as [B,H,hd], "
                         "[NB,bs,KV,hd]")
    nb, bs, kv = k_pool.shape[:3]
    if nb == 0 or bs == 0:
        raise ValueError(f"{kernel} kernel: the pool holds no row")
    if kv == 0 or h % kv:
        raise ValueError(f"{kernel} kernel: {h} query heads are not a "
                         f"multiple of {kv} kv heads")
    if hd not in HEAD_DIMS or (h // kv) * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"{kernel} kernel: head_dim {hd} with {h // kv} "
                         f"heads per kv head is not supported (head_dim in "
                         f"{HEAD_DIMS}, G * head_dim <= {MAX_GROUP_WIDTH})")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"{kernel} kernel: block_tables has shape "
                         f"{tuple(block_tables.shape)}, expected [{b}, W]")
    check_int_vector(kernel, "block_tables", block_tables,
                      tuple(block_tables.shape), q.device)
    if block_tables.shape[1] == 0:
        raise ValueError(f"{kernel} kernel: block_tables has no entry")
    check_int_vector(kernel, "lengths", lengths, (b,), q.device)
    if ring_starts is not None:
        check_int_vector(kernel, "ring_starts", ring_starts, (b,), q.device)


def _launch(wrapper, q, k_pool, v_pool, block_tables, ring_starts, lengths,
            window, scale):
    """Launch the kernel (window 0: paged; > 0: ring) and count the launch
    on `wrapper`."""
    b, h, hd = q.shape
    nb, bs, kv = k_pool.shape[:3]
    w = block_tables.shape[1]
    out = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else float(1.0 / math.sqrt(hd))
    cap = w * bs if window == 0 else min(window, w * bs)
    rows, splits = paged_split_rows(hd), paged_num_splits(cap, hd)
    partial = tickets = None
    if splits > 1:      # each split's (acc [G, hd], m [G], l [G]) in f32
        partial = torch.empty(b * kv * splits * (h // kv) * (hd + 2),
                              dtype=torch.float32, device=q.device)
        tickets = ticket_counters(q.device, b * kv)
    fn = _entry(q.dtype)
    starts = 0 if ring_starts is None else ring_starts.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), starts, lengths.data_ptr(),
                 out.data_ptr(), b, h, kv, hd, nb, bs, w, window,
                 *q.stride()[:2], *k_pool.stride()[:3],
                 *v_pool.stride()[:3], scale, rows,
                 None if partial is None else partial.data_ptr(),
                 None if tickets is None else tickets.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_paged kernel launch failed: "
                           f"CUDA error {err}")
    wrapper.launches += 1
    return out


def decode_attention_paged_cuda(q, k_pool, v_pool, block_tables, *, lengths,
                                scale=None):
    """Paged decode on CUDA tensors. Returns a new [B,H,hd] tensor in q's
    dtype; a row attends to its positions below min(lengths[b], W * bs)."""
    check_inputs("decode_attention_paged", q, k_pool, v_pool, block_tables,
                 lengths)
    return _launch(decode_attention_paged_cuda, q, k_pool, v_pool,
                   block_tables, None, lengths, 0, scale)


def decode_attention_ring_cuda(q, k_pool, v_pool, block_tables, *,
                               ring_starts, lengths, window, scale=None):
    """Ring-paged decode on CUDA tensors (window >= 1): a row attends to
    its ring slots below min(lengths[b], window, W * bs). Returns a new
    [B,H,hd] tensor in q's dtype."""
    check_inputs("decode_attention_ring", q, k_pool, v_pool, block_tables,
                 lengths, ring_starts)
    window = int(window)
    if window < 1:
        raise ValueError(f"decode_attention_ring kernel: window {window} "
                         "is not a ring")
    return _launch(decode_attention_ring_cuda, q, k_pool, v_pool,
                   block_tables, ring_starts, lengths, window, scale)


decode_attention_paged_cuda.launches = 0
decode_attention_ring_cuda.launches = 0
