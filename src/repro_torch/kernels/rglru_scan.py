"""RG-LRU gated linear recurrence with state in and out: the Hopper kernel's
wrapper.

The kernel (`csrc/rglru_scan.cu`, CUDA C++ for sm_90a, bound with ctypes)
replaces the TPU kernel `repro/kernels/rglru_scan.py:rglru_scan_bsw`:

    h_t = a_t * h_{t-1} + u_t    (f32, the product and the sum each rounded)

per batch row and channel, with an output per step. The TPU kernel starts
from zero and returns no state; this one starts from `state` (f32 [B, W])
and writes the final h back into it, so decode steps continue the prompt's
recurrence. It reads a and u (f32 [B, S, W]) through their batch and time
strides and writes out in f32, or in bf16 (`out_dtype`), rounded to
nearest-even from the f32 value: bitwise `out_f32.to(torch.bfloat16)`.
The wrapper checks its inputs, allocates the output with `torch.empty`,
launches on the current stream and raises if the launch reports an error.
`rglru_scan_cuda.launches` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import check_operand

_ENTRY = {torch.float32: "rglru_scan_f32", torch.bfloat16: "rglru_scan_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    """The typed ctypes function for an output dtype, set up once."""
    fn = getattr(build.load("rglru_scan"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_inputs(a, u, state, out_dtype=torch.float32):
    """Raise unless a and u (f32 [B,S,W]) and state (contiguous f32 [B,W])
    lie on one CUDA device with a contiguous last dim and 16-byte aligned
    addresses and strides, and out_dtype is float32 or bfloat16."""
    f32 = torch.float32
    check_operand("rglru_scan", "a", a, 3, a.device, f32)
    check_operand("rglru_scan", "u", u, 3, a.device, f32)
    check_operand("rglru_scan", "state", state, 2, a.device, f32)
    b, _, w = a.shape
    if u.shape != a.shape or tuple(state.shape) != (b, w):
        raise ValueError(f"rglru_scan kernel: a {tuple(a.shape)}, u "
                         f"{tuple(u.shape)} and state {tuple(state.shape)} "
                         "do not match as [B,S,W], [B,S,W], [B,W]")
    if not state.is_contiguous():
        raise ValueError(f"rglru_scan kernel: state needs to be contiguous, "
                         f"got strides {state.stride()}")
    if out_dtype not in _ENTRY:
        raise TypeError(f"rglru_scan kernel: out_dtype {out_dtype}; it "
                        "writes float32 or bfloat16")


def rglru_scan_cuda(a, u, state, out_dtype=torch.float32):
    """Launch the kernel on CUDA tensors. Returns (out [B,S,W] in out_dtype,
    `state`, overwritten with the final h)."""
    check_inputs(a, u, state, out_dtype)
    b, s, w = a.shape
    out = torch.empty((b, s, w), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out, state
    strides = (ctypes.c_int64 * 6)(*[st for t in (a, u, out)
                                     for st in t.stride()[:2]])
    fn = _entry(out_dtype)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), u.data_ptr(), out.data_ptr(), state.data_ptr(),
                 b, s, w, strides, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    rglru_scan_cuda.launches += 1
    return out, state


rglru_scan_cuda.launches = 0
