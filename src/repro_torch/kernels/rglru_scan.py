"""RG-LRU gated linear recurrence with its gate math fused in and state in
and out: the Hopper kernel's wrapper.

The kernel (`csrc/rglru_scan.cu`, CUDA C++ for sm_90a, bound with ctypes)
replaces the TPU kernel `repro/kernels/rglru_scan.py:rglru_scan_bsw`,

    h_t = a_t * h_{t-1} + u_t    (f32, the product and the sum each rounded)

per batch row and channel, with an output per step, and computes a and u
itself from the RG-LRU block's gate products (`models/rglru.py`): from
ga = xa @ W_a, gi = xa @ W_i and xa ([B, S, W], f32 or bf16, one dtype)
and the block's b_a, b_i and lamb ([W], the same dtype), in PyTorch's
order and roundings (`ref.rglru_gated`, bitwise). The TPU kernel starts
from zero and returns no state; this one starts from `state` (f32 [B, W])
and writes the final h back into it, so decode steps continue the
prompt's recurrence. It writes out in the inputs' dtype, rounded to
nearest-even from the f32 h. The wrapper checks its inputs, allocates the
output with `torch.empty`, launches on the current stream and raises if
the launch reports an error. `rglru_scan_cuda.launches` counts its
launches.

`rglru_scan_bwd_cuda` launches the backward (the same source's
`rglru_bwd`, one launch a call, counted in `rglru_scan_bwd_cuda.launches`):
the gradients of the gate products, the three parameters, xa and h_0 from
the output's gradient (and optionally the final h's), as
`ref.rglru_gated_bwd` states them, with its f32 scratch of h from
`torch.empty`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import check_operand

_ENTRY = {torch.float32: "rglru_scan_f32", torch.bfloat16: "rglru_scan_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    """The typed ctypes function for a compute dtype, set up once."""
    fn = getattr(build.load("rglru_scan"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_inputs(gate_a, gate_i, b_a, b_i, lamb, xa, state):
    """Raise unless gate_a, gate_i and xa ([B,S,W], f32 or bf16, one dtype,
    a contiguous last dim and 16-byte aligned addresses and strides), b_a,
    b_i and lamb (contiguous [W], the same dtype) and state (contiguous f32
    [B,W], 16-byte aligned) lie on one CUDA device."""
    dev, dtype = xa.device, xa.dtype
    for name, t in (("gate_a", gate_a), ("gate_i", gate_i), ("xa", xa)):
        check_operand("rglru_scan", name, t, 3, dev, dtype)
    check_operand("rglru_scan", "state", state, 2, dev, torch.float32)
    b, _, w = xa.shape
    if gate_a.shape != xa.shape or gate_i.shape != xa.shape:
        raise ValueError(f"rglru_scan kernel: gate_a {tuple(gate_a.shape)}, "
                         f"gate_i {tuple(gate_i.shape)} and xa "
                         f"{tuple(xa.shape)} differ")
    for name, t in (("b_a", b_a), ("b_i", b_i), ("lamb", lamb)):
        # read one element a channel: no alignment asked
        if t.device != dev:
            raise ValueError(f"rglru_scan kernel: {name} is on {t.device}, "
                             f"expected the CUDA device {dev}")
        if t.dtype != dtype:
            raise TypeError(f"rglru_scan kernel: {name} is {t.dtype}, "
                            f"expected {dtype}")
        if tuple(t.shape) != (w,) or not t.is_contiguous():
            raise ValueError(f"rglru_scan kernel: {name} needs to be a "
                             f"contiguous ({w},), got {tuple(t.shape)} with "
                             f"strides {t.stride()}")
    if tuple(state.shape) != (b, w):
        raise ValueError(f"rglru_scan kernel: state {tuple(state.shape)} "
                         f"does not match xa {tuple(xa.shape)} as [B,W]")
    if not state.is_contiguous():
        raise ValueError(f"rglru_scan kernel: state needs to be contiguous, "
                         f"got strides {state.stride()}")


def rglru_scan_cuda(gate_a, gate_i, b_a, b_i, lamb, xa, state):
    """Launch the kernel on CUDA tensors. Returns (out [B,S,W] in xa's
    dtype, `state`, overwritten with the final h)."""
    check_inputs(gate_a, gate_i, b_a, b_i, lamb, xa, state)
    b, s, w = xa.shape
    out = torch.empty((b, s, w), dtype=xa.dtype, device=xa.device)
    if out.numel() == 0:
        return out, state
    strides = (ctypes.c_int64 * 8)(*[st for t in (gate_a, gate_i, xa, out)
                                     for st in t.stride()[:2]])
    fn = _entry(xa.dtype)
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream(xa.device).cuda_stream
        err = fn(gate_a.data_ptr(), gate_i.data_ptr(), b_a.data_ptr(),
                 b_i.data_ptr(), lamb.data_ptr(), xa.data_ptr(),
                 out.data_ptr(), state.data_ptr(), b, s, w, strides, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    rglru_scan_cuda.launches += 1
    return out, state


rglru_scan_cuda.launches = 0


_BWD_ENTRY = {torch.float32: "rglru_scan_bwd_f32",
              torch.bfloat16: "rglru_scan_bwd_bf16"}
_BWD_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 3 + [
    ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _bwd_entry(dtype):
    fn = getattr(build.load("rglru_scan"), _BWD_ENTRY[dtype])
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def rglru_scan_bwd_cuda(gate_a, gate_i, b_a, b_i, lamb, xa, state, dout,
                        dh_final=None):
    """Launch the backward on CUDA tensors: the forward's inputs as
    `rglru_scan_cuda` takes them (`state`, its incoming f32 h, read only);
    dout: the output's gradient [B,S,W] in xa's dtype (any batch and time
    strides, a contiguous last dim); dh_final: the final h's f32 gradient
    (contiguous [B,W]), None for zero. Returns (dgate_a, dgate_i [B,S,W],
    db_a, db_i, dlamb [W], the kernel's per-row sums added over B in order,
    dxa [B,S,W], dh0 [B,W]), all f32."""
    check_inputs(gate_a, gate_i, b_a, b_i, lamb, xa, state)
    check_operand("rglru_scan", "dout", dout, 3, xa.device, xa.dtype)
    if dout.shape != xa.shape:
        raise ValueError(f"rglru_scan backward: dout {tuple(dout.shape)} "
                         f"does not match xa {tuple(xa.shape)}")
    if dh_final is not None:
        check_operand("rglru_scan", "dh_final", dh_final, 2, xa.device,
                      torch.float32)
        if dh_final.shape != state.shape or not dh_final.is_contiguous():
            raise ValueError("rglru_scan backward: dh_final needs to be a "
                             f"contiguous {tuple(state.shape)}")
    b, s, w = xa.shape
    f32 = dict(dtype=torch.float32, device=xa.device)
    dga, dgi, dxa = (torch.empty((b, s, w), **f32) for _ in range(3))
    dba, dbi, dlamb, dh0 = (torch.empty((b, w), **f32) for _ in range(4))
    hs = torch.empty((b, s, w), **f32)
    ptrs = (ctypes.c_void_p * 17)(*[
        None if t is None else t.data_ptr()
        for t in (gate_a, gate_i, b_a, b_i, lamb, xa, state, dout, dh_final,
                  dga, dgi, dxa, dba, dbi, dlamb, dh0, hs)])
    strides = (ctypes.c_int64 * 8)(*[st for t in (gate_a, gate_i, xa, dout)
                                     for st in t.stride()[:2]])
    fn = _bwd_entry(xa.dtype)
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream(xa.device).cuda_stream
        err = fn(ptrs, b, s, w, strides, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    rglru_scan_bwd_cuda.launches += 1
    return (dga, dgi, dba.sum(0), dbi.sum(0), dlamb.sum(0), dxa, dh0)


rglru_scan_bwd_cuda.launches = 0
