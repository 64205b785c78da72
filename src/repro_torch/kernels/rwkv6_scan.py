"""RWKV6 WKV recurrence with state in and out: the Hopper kernel's wrapper.

The kernel (`csrc/rwkv6_scan.cu`, CUDA C++ for sm_90a, bound with ctypes)
replaces the TPU kernel `repro/kernels/rwkv6_scan.py:rwkv6_scan_bh`:

    out_t = r_t S + (r_t . (u * k_t)) v_t,   S <- diag(w_t) S + k_t^T v_t

per batch row and head, with an f32 [hd, hd] state. The TPU kernel
starts from zero and returns no state; this one starts from `state` and
writes the final state back into it, so decode steps continue the
prompt's recurrence. It reads r, k, v [B, H, S, hd] (f32 or bf16) and w
(f32) through their strides, so the model's [B, S, H, hd] projections go
in as transposed views, and writes out (f32) into a [B, S, H, hd] buffer
that it returns as a [B, H, S, hd] view.

The body is picked from S alone (`body(s)`), never from the batch: below
`CHUNKED_MIN_STEPS` (decode) the step body walks time one step after
another; from there on the chunked body computes chunks of `CHUNK` steps
on the tensor cores in two launches (`ref.rwkv6_chunked` states its
arithmetic), with f32 scratch from `torch.empty` and the per-device
ticket counters it shares with the decode kernels (`tickets.py`). The
wrapper checks its inputs, allocates the output, launches on the current
stream and raises if a launch reports an error. `rwkv6_scan_cuda.launches` counts its calls (one a call, whichever
body: the chunked body's two device launches count once).

`rwkv6_scan_bwd_cuda` launches the recurrence's backward
(`csrc/rwkv6_scan_bwd.cu`, one launch a call, counted in
`rwkv6_scan_bwd_cuda.launches`): the gradients of r, k, v, w, u and the
incoming state from the gradient of the output (and optionally of the
final state), as `ref.rwkv6_bwd` states them, with its f32 scratch from
`torch.empty`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tickets import ticket_counters

_ENTRY = {torch.float32: "rwkv6_scan_f32", torch.bfloat16: "rwkv6_scan_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
             + [ctypes.c_void_p] * 3)
HEAD_DIMS = (32, 64)
# The chunked body costs ~24 us a call on an H100 however few its steps
# (two launches of dependent phases); the step body ~0.26 us a step, so
# the step body is the faster up to ~90 steps (chip_variants.py, PERF.md
# section 6). C = 32 is no faster at 200 steps and slower at 4096.
CHUNK = 64                  # steps a chunk of the chunked body: kChunk
CHUNKED_MIN_STEPS = 96      # the fewest steps that take the chunked body


def body(s):
    """The chunk length the kernel takes for S steps, 0 for the step
    body: a function of S alone."""
    return CHUNK if s >= CHUNKED_MIN_STEPS else 0


def scratch_floats(b, h, s, hd, chunk):
    """f32 scratch of the chunked body: per (b, h) and chunk, r_dec [chunk,
    hd], dS (then S_in) [hd, hd] and the total decay [hd]."""
    return b * h * -(-s // chunk) * (chunk * hd + hd * hd + hd)


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    """The typed ctypes function for dtype, set up once per dtype."""
    fn = getattr(build.load("rwkv6_scan"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, device, dtype, shape, contiguous=False):
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"rwkv6_scan kernel: {name} is on {t.device}, "
                         f"expected the CUDA device {device}")
    if t.dtype != dtype:
        raise TypeError(f"rwkv6_scan kernel: {name} is {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"rwkv6_scan kernel: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not (t.is_contiguous() if contiguous else t.stride(-1) == 1):
        need = "to be contiguous" if contiguous else "a contiguous last dim"
        raise ValueError(f"rwkv6_scan kernel: {name} needs {need}, got "
                         f"strides {t.stride()}")


def check_inputs(r, k, v, w, u, state):
    """Raise unless r, k, v [B,H,S,hd] (f32 or bf16, one dtype), w (f32,
    same shape), u [H,hd] (r's dtype) and state (contiguous f32
    [B,H,hd,hd]) fit the kernel."""
    if r.dtype not in _ENTRY:
        raise TypeError(f"rwkv6_scan kernel: r is {r.dtype}; it takes "
                        "float32 or bfloat16")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan kernel: r has shape {tuple(r.shape)}, "
                         "expected [B, H, S, hd]")
    b, h, _, hd = r.shape
    for name, t in (("r", r), ("k", k), ("v", v)):
        _check(name, t, r.device, r.dtype, r.shape)
    _check("w", w, r.device, torch.float32, r.shape)
    _check("u", u, r.device, r.dtype, (h, hd), contiguous=True)
    _check("state", state, r.device, torch.float32, (b, h, hd, hd),
           contiguous=True)
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan kernel: head_dim {hd} is not one of "
                         f"{HEAD_DIMS}")


def _bshd_buffer(b, h, s, hd, device):
    """An f32 [B, H, S, hd] view of a [B, S, H, hd] buffer: the model's
    layout, so the transpose back to it is free."""
    return torch.empty((b, s, h, hd), dtype=torch.float32,
                       device=device).transpose(1, 2)


def rwkv6_scan_cuda(r, k, v, w, u, state):
    """Launch the kernel on CUDA tensors. Returns (out [B,H,S,hd] f32, a
    view of a [B,S,H,hd] buffer; `state`, overwritten with the final
    state)."""
    check_inputs(r, k, v, w, u, state)
    b, h, s, hd = r.shape
    out = _bshd_buffer(b, h, s, hd, r.device)
    if out.numel() == 0:
        return out, state
    strides = (ctypes.c_int64 * 15)(*[st for t in (r, k, v, w, out)
                                      for st in t.stride()[:3]])
    chunk = body(s)
    scratch = tickets = None
    if chunk:
        scratch = torch.empty(scratch_floats(b, h, s, hd, chunk),
                              dtype=torch.float32, device=r.device)
        tickets = ticket_counters(r.device, b * h)
    fn = _entry(r.dtype)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), out.data_ptr(), state.data_ptr(), b, h, s, hd,
                 strides, int(chunk > 0),
                 None if scratch is None else scratch.data_ptr(),
                 None if tickets is None else tickets.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    rwkv6_scan_cuda.launches += 1
    return out, state


rwkv6_scan_cuda.launches = 0


_BWD_ENTRY = {torch.float32: "rwkv6_scan_bwd_f32",
              torch.bfloat16: "rwkv6_scan_bwd_bf16"}
_BWD_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 4
                 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_void_p] * 2)


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    """The backward's library, its entry points typed once."""
    lib = build.load("rwkv6_scan_bwd")
    for name in _BWD_ENTRY.values():
        getattr(lib, name).argtypes = _BWD_ARGTYPES
        getattr(lib, name).restype = ctypes.c_int
    lib.rwkv6_scan_bwd_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.rwkv6_scan_bwd_scratch_floats.restype = ctypes.c_int64
    return lib


def rwkv6_scan_bwd_cuda(r, k, v, w, u, state, dout, dstate=None):
    """Launch the backward on CUDA tensors: r, k, v, w, u and `state` (the
    forward's incoming f32 state, read only) as `rwkv6_scan_cuda` takes
    them; dout: the output's f32 gradient [B,H,S,hd] (a contiguous last
    dim); dstate: the final state's f32 gradient (contiguous [B,H,hd,hd]),
    None for zero. Returns (dr, dk, dv, dw [B,H,S,hd] f32, views of [B,S,H,hd]
    buffers; du [H,hd] f32, the kernel's per-row sums added over B in
    order; dstate_in [B,H,hd,hd] f32)."""
    check_inputs(r, k, v, w, u, state)
    b, h, s, hd = r.shape
    _check("dout", dout, r.device, torch.float32, r.shape)
    if dstate is not None:
        _check("dstate", dstate, r.device, torch.float32, state.shape,
               contiguous=True)
    dr, dk, dv, dw = (_bshd_buffer(b, h, s, hd, r.device) for _ in range(4))
    du = torch.empty((b, h, hd), dtype=torch.float32, device=r.device)
    dstate_in = torch.empty_like(state)
    lib = _bwd_lib()
    scratch = torch.empty(lib.rwkv6_scan_bwd_scratch_floats(b, h, s, hd),
                          dtype=torch.float32, device=r.device)
    strides = (ctypes.c_int64 * 27)(*[st for t in (r, k, v, w, dout, dr, dk,
                                                   dv, dw)
                                      for st in t.stride()[:3]])
    fn = getattr(lib, _BWD_ENTRY[r.dtype])
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), state.data_ptr(), dout.data_ptr(),
                 None if dstate is None else dstate.data_ptr(),
                 dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                 du.data_ptr(), dstate_in.data_ptr(), b, h, s, hd, strides,
                 scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan backward kernel launch failed: CUDA "
                           f"error {err}")
    rwkv6_scan_bwd_cuda.launches += 1
    return dr, dk, dv, dw, du.sum(0), dstate_in


rwkv6_scan_bwd_cuda.launches = 0
