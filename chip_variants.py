#!/usr/bin/env python3
"""Time variants of the attention kernels on one NVIDIA GPU, for the
design choices `PERF.md` records.

    python3 chip_variants.py

Each variant is the kernel source in this checkout with one text
substitution (a constant, a call, a removed line), built with the
repo's nvcc flags into its own library under `build/variants/` and
called through the kernel's wrapper on the main paths' bf16 shapes,
beside the plain version and the one PyTorch call (SDPA) on the same
inputs; device time comes from chip_smoke's `device_ms` (torch.profiler,
early in a fresh process, where it keeps its events), two rounds in
turns. A variant that changes the arithmetic (one bf16 term
of P, a fast exp) is timing only: its output is printed as its largest
difference from the repo's kernel, never used. Prints the card's name and
power limit, then one JSON line per variant and round.
"""
import ctypes
import json
import pathlib
import subprocess

import torch

import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

OUT = pathlib.Path(build.BUILD_DIR).parent / "variants"


def substituted(text, old, new):
    if old not in text:
        raise AssertionError(f"variant text not found: {old!r}")
    return text.replace(old, new)


def flash_variants():
    src = (build.CSRC / "flash_attention.cu").read_text()
    extra_terms = """                        attn::mma_bf16(o[2 * n + j], mid, bv[2 * j],
                                       bv[2 * j + 1]);
                        attn::mma_bf16(o[2 * n + j], lo, bv[2 * j],
                                       bv[2 * j + 1]);"""
    return {
        "kernel": (src, None),
        "one bf16 term of P": (substituted(src, extra_terms, ""), None),
        "__expf for expf": (src.replace("expf(", "__expf("), None),
        "8 warps, 128 query rows": (substituted(substituted(
            src, "constexpr int kMmaThreads = 128;",
            "constexpr int kMmaThreads = 256;"),
            "constexpr int kMmaRows = 64; ", "constexpr int kMmaRows = 128;"),
            None),
        "kv tiles of 32": (substituted(src, "return HD > 128 ? 32 : 64;",
                                       "return 32;"), None),
        "kv tiles of 128 at hd <= 64": (substituted(
            src, "return HD > 128 ? 32 : 64;",
            "return HD > 128 ? 32 : (HD > 64 ? 64 : 128);"), None),
        "3 stages": (substituted(src, "constexpr int kStages = 2;",
                                 "constexpr int kStages = 3;"), None),
    }


def decode_variants():
    src = (build.CSRC / "decode_attention.cu").read_text()
    head = (build.CSRC / "attention_common.cuh").read_text()
    return {
        "kernel": (src, None),
        "f32 FMA body for bf16": (src, substituted(
            head, "kMma = std::is_same<T, __nv_bfloat16>::value;",
            "kMma = false;")),
        "3 stages": (src, substituted(head, "constexpr int kSplitStages = 2;",
                                      "constexpr int kSplitStages = 3;")),
    }


def build_all(kernel, variants):
    """{variant: ctypes library}, every variant compiled in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (src, head)) in enumerate(variants.items()):
        stem = f"{kernel}_{i}"
        if head is not None:
            (OUT / f"{stem}.cuh").write_text(head)
            src = src.replace('#include "attention_common.cuh"',
                              f'#include "{stem}.cuh"')
        (OUT / f"{stem}.cu").write_text(src)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(OUT / f"{stem}.so"), str(OUT / f"{stem}.cu")]
        procs[name] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"{stem}.so"))
    return libs


def time_variants(module, entry, libs, cases, launch, plain, library):
    """Two rounds of every variant on every case, through the wrapper with
    its entry swapped for the variant's, each round closed by the case's
    plain version and its one PyTorch call."""
    wants = [launch(*c[1:]) for c in cases]
    original = module._entry
    for rnd in range(2):
        row = {"kernel": entry, "variant": "plain and library", "round": rnd}
        for c in cases:
            row[c[0]] = {
                "plain_us": 1e3 * cs.device_ms(lambda: plain(*c[1:]), 3),
                "library_us": 1e3 * cs.device_ms(lambda: library(*c[1:]),
                                                 20)}
        print(json.dumps(row), flush=True)
        for name, lib in libs.items():
            fn = getattr(lib, entry)
            fn.argtypes = module._ARGTYPES
            fn.restype = ctypes.c_int
            module._entry = lambda dtype, fn=fn: fn
            try:
                row = {"kernel": entry, "variant": name, "round": rnd}
                for c, want in zip(cases, wants):
                    got = launch(*c[1:])
                    row[c[0]] = {
                        "us": 1e3 * cs.device_ms(lambda: launch(*c[1:]), 20,
                                                 one_kernel=True),
                        "max_diff_vs_kernel": float(
                            (got.float() - want.float()).abs().max())}
            finally:
                module._entry = original
            print(json.dumps(row), flush=True)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    flash_libs = build_all("flash", flash_variants())
    decode_libs = build_all("decode", decode_variants())
    gen = torch.Generator(device=cs.DEV).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cs.DEV).to(bf)

    flash_cases = []
    for label, s, h, kv, hd, window in (
            ("qwen2 Sp=256", 256, 14, 2, 64, 0),
            ("qwen2 S=2048", 2048, 14, 2, 64, 0),
            ("recurrentgemma S=200", 200, 10, 1, 256, 2048),
            ("recurrentgemma S=3000, window 2048", 3000, 10, 1, 256, 2048)):
        flash_cases.append((label, randn(1, s, h, hd), randn(1, s, kv, hd),
                            randn(1, s, kv, hd), window))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def flash_library(q, k, v, w):
        """SDPA on [B, heads, S, hd] copies, causal, masked where the
        window binds (as chip_smoke's yardstick)."""
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        s = q.shape[1]
        if not w or w >= s:
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        i = torch.arange(s, device=cs.DEV)
        mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - w)
        return sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    time_variants(fa, "flash_attention_bf16", flash_libs, flash_cases,
                  lambda q, k, v, w: fa.flash_attention_cuda(
                      q, k, v, causal=True, window=w),
                  lambda q, k, v, w: cs.ref.attention(q, k, v, causal=True,
                                                      window=w),
                  flash_library)

    decode_cases = []
    for label, b, t, h, kv, hd, full in (
            ("qwen2 B=8 T=512", 8, 512, 14, 2, 64, False),
            ("qwen2 B=64 T=4096", 64, 4096, 14, 2, 64, False),
            ("recurrentgemma ring 512", 8, 512, 10, 1, 256, False),
            ("recurrentgemma full ring 2048", 8, 2048, 10, 1, 256, True)):
        lengths = torch.linspace(1, t, b, device=cs.DEV).round().to(
            torch.int32)
        lengths[0] = t
        if full:
            lengths.fill_(t)
        decode_cases.append((label, randn(b, h, hd), randn(b, t, kv, hd),
                             randn(b, t, kv, hd), lengths))
    def decode_library(q, k, v, lengths):
        """SDPA over [B, KV, T, hd] copies with the lengths as a mask."""
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        valid = torch.arange(k.shape[1], device=cs.DEV)[None] < lengths[:,
                                                                         None]
        return sdpa(q[:, :, None], kt, vt, attn_mask=valid[:, None, None, :],
                    enable_gqa=True)

    time_variants(da, "decode_attention_bf16", decode_libs, decode_cases,
                  lambda q, k, v, lengths: da.decode_attention_cuda(
                      q, k, v, lengths=lengths),
                  lambda q, k, v, lengths: cs.ref.decode_attention(
                      q, k, v, lengths=lengths),
                  decode_library)


if __name__ == "__main__":
    main()
