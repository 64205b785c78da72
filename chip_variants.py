#!/usr/bin/env python3
"""Time variants of the attention kernels on one NVIDIA GPU, for the
design choices `PERF.md` records.

    python3 chip_variants.py

Each variant is the kernel source in this checkout with one text
substitution (a constant, a call, a removed line), built with the
repo's nvcc flags into its own library under `build/variants/`, or the
kernel with another chunk size from its wrapper (the paged kernel's
rows per split), called through the kernel's wrapper on the main paths'
bf16 shapes, beside the plain version and the one PyTorch call (SDPA;
gather + SDPA for the paged kernel) on the same inputs; device time comes from chip_smoke's `device_ms` (torch.profiler,
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
from repro_torch.kernels import decode_attention_paged as dap
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


# split_decode's split-level staging of a paged row's block ids, and the
# two places a tile's copies are issued (the prologue and the loop)
SPLIT_STAGE = """    rows.stage(row0, row1, tid);   // the split's block ids, once
    if constexpr (Rows::kStaged) __syncthreads();
"""
PROLOGUE_COPY = """            const int r0 = row0 + st * kRows;
"""
LOOP_COPY = """            const int at = (nxt % kSplitStages) * kRows * kPitch;
"""
STAGE_TILE = """            rows.stage({r0}, min({r0} + kRows, row1), tid);
            if constexpr (Rows::kStaged) __syncthreads();
"""
PAGED_ROWS = {"R 256": 256, "R 512": 512}   # else paged_split_rows(hd)


def paged_variants():
    """The paged kernel, and its block ids staged per tile (each tile's
    ids looked up behind their own barrier just before its copies are
    issued) instead of once per split; the rows-per-split arms reuse the
    kernel's own library."""
    src = (build.CSRC / "decode_attention_paged.cu").read_text()
    head = (build.CSRC / "attention_common.cuh").read_text()
    per_tile = substituted(head, SPLIT_STAGE, "")
    per_tile = substituted(per_tile, PROLOGUE_COPY, PROLOGUE_COPY
                           + STAGE_TILE.format(r0="r0"))
    per_tile = substituted(per_tile, LOOP_COPY, LOOP_COPY + STAGE_TILE.format(
        r0="row0 + nxt * kRows"))
    return {"kernel": (src, None), "R 256": (src, None),
            "R 512": (src, None), "per-tile staging": (src, per_tile)}


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


def time_variants(module, entry, libs, cases, launch, plain, library,
                  before=None):
    """Two rounds of every variant on every case, through the wrapper with
    its entry swapped for the variant's (and `before(name)` called first,
    `before(None)` after), each round closed by the case's plain version
    and its one PyTorch call."""
    before = before or (lambda name: None)
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
            before(name)
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
                before(None)
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

    paged_libs = build_all("paged", paged_variants())
    paged_cases = []
    for label, b, max_len, window in (
            ("qwen2 paged B=8 <=512 bs=16", 8, 512, 0),
            ("qwen2 paged B=64 <=4096 bs=16", 64, 4096, 0),
            ("qwen2 ring window 256 B=8 bs=16", 8, 256, 256)):
        q, kp, vp, tables = cs._pool_operands(b, max_len, 16, bf, gen)
        span = 3 * window if window else max_len
        lengths = torch.linspace(1, span, b, device=cs.DEV).round().to(
            torch.int32)
        lengths[0] = span
        ring = None
        if window:
            ring = torch.randint(0, tables.shape[1], (b,), generator=gen,
                                 device=cs.DEV, dtype=torch.int32)
        else:
            nblk = (lengths + 15) // 16
            tables[torch.arange(tables.shape[1], device=cs.DEV)[None]
                   >= nblk[:, None]] = 0
        paged_cases.append((label, q, kp, vp, tables, lengths, ring, window))

    def paged_launch(q, kp, vp, tables, lengths, starts, window):
        if window:
            return dap.decode_attention_ring_cuda(
                q, kp, vp, tables, ring_starts=starts, lengths=lengths,
                window=window)
        return dap.decode_attention_paged_cuda(q, kp, vp, tables,
                                               lengths=lengths)

    def paged_plain(q, kp, vp, tables, lengths, starts, window):
        if window:
            return cs.ref.decode_attention_ring(
                q, kp, vp, tables, ring_starts=starts, lengths=lengths,
                window=window)
        return cs.ref.decode_attention_paged(q, kp, vp, tables,
                                             lengths=lengths)

    def paged_library(q, kp, vp, tables, lengths, starts, window):
        """Gather the blocks in ring order, then SDPA with a length mask
        (chip_smoke's yardstick)."""
        if window:
            tables = cs.ref.ring_order(tables, starts)
            lengths = torch.clamp(lengths, max=window)
        valid = (torch.arange(tables.shape[1] * kp.shape[1],
                              device=cs.DEV)[None] < lengths[:, None])
        return cs._gather_sdpa(q, kp, vp, tables, valid)()

    rows = dap.paged_split_rows

    def set_rows(name):
        """The wrapper's rows per split for the variant `name`."""
        dap.paged_split_rows = (
            (lambda hd, r=PAGED_ROWS[name]: r) if name in PAGED_ROWS
            else rows)

    time_variants(dap, "decode_attention_paged_bf16", paged_libs,
                  paged_cases, paged_launch, paged_plain, paged_library,
                  before=set_rows)


if __name__ == "__main__":
    main()
