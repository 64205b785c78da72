"""Build the port's CUDA kernels from the sources in the repo, on first use.

Each `csrc/<name>.cu` compiles with `nvcc` into `build/repro_torch/
lib<name>.so` at the repo root, a plain C library that the wrappers load
with `ctypes`. A library newer than its source and the shared headers
(`csrc/*.cuh`) is reused; every stale one
is rebuilt, one `nvcc` per source, all started together. A missing
compiler or a failed compile raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# every kernel source, csrc/<name>.cu
KERNELS = ("prox_update", "flash_attention", "decode_attention",
           "decode_attention_paged", "rwkv6_scan", "rwkv6_scan_bwd",
           "rglru_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, then /usr/local/cuda,
    then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return found


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """True if the library is missing or older than its source or any
    shared header in csrc/."""
    so = library_path(name)
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return not so.is_file() or so.stat().st_mtime < newest


def build(*names: str) -> dict:
    """Compile every stale kernel among `names` in parallel.

    Returns {name: compiler log} for the kernels it built (ptxas prints
    registers and spills per kernel); raises RuntimeError on a failure.
    """
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".so.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if it is stale."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))
