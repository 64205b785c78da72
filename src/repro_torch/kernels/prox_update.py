"""Fused gAPI-BCD closed-form update: the Hopper kernel's wrapper.

    x_new = (rho * x - g + tau * zsum) / (rho + tau * M)        (eq. 15)
    delta = (x_new - x) / N                                     (eq. 12b)

The kernel (`csrc/prox_update.cu`, CUDA C++ for sm_90a, bound with
ctypes) replaces the TPU kernel `repro/kernels/prox_update.py:
prox_update_2d`. It walks the flat elements itself, so leaves need no
padding to 1024 lanes. The wrapper checks its inputs, allocates both
outputs with `torch.empty`, launches on the current stream and raises if
the launch reports an error. `prox_update_cuda.launches` counts its
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_ENTRY = {torch.float32: "prox_update_f32", torch.bfloat16: "prox_update_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_double,
              ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    """The typed ctypes function for dtype, set up once per dtype."""
    fn = getattr(build.load("prox_update"), _ENTRY[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check_inputs(x, g, zsum):
    """Raise unless x (f32 or bf16), g and zsum (f32) are contiguous CUDA
    tensors of one shape on one device."""
    for name, t in (("x", x), ("g", g), ("zsum", zsum)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"prox_update kernel: {name} is on {t.device}, "
                             f"expected x's CUDA device {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"prox_update kernel: {name} is not contiguous")
        if t.shape != x.shape:
            raise ValueError(f"prox_update kernel: {name} has shape "
                             f"{tuple(t.shape)}, x has {tuple(x.shape)}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"prox_update kernel: x is {x.dtype}; it takes "
                        "float32 or bfloat16")
    if g.dtype != torch.float32 or zsum.dtype != torch.float32:
        raise TypeError(f"prox_update kernel: g and zsum must be float32, "
                        f"got {g.dtype} and {zsum.dtype}")


def prox_update_cuda(x, g, zsum, *, tau, rho, num_walks, num_agents):
    """Launch the kernel on CUDA tensors. Returns (x_new in x.dtype,
    delta in f32), both newly allocated."""
    check_inputs(x, g, zsum)
    x_new = torch.empty_like(x)
    delta = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return x_new, delta
    fn = _entry(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), zsum.data_ptr(),
                 x_new.data_ptr(), delta.data_ptr(), x.numel(),
                 tau, rho, num_walks, num_agents, stream)
    if err != 0:
        raise RuntimeError(f"prox_update kernel launch failed: CUDA error "
                           f"{err}")
    prox_update_cuda.launches += 1
    return x_new, delta


prox_update_cuda.launches = 0
