#!/usr/bin/env python3
"""Time variants of the port's kernels on one NVIDIA GPU, for the design
choices `PERF.md` records.

    python3 chip_variants.py

Each variant is the kernel source in this checkout with one text
substitution (a constant, a call, a removed line), built with the
repo's nvcc flags into its own library under `build/variants/`, or the
kernel with another setting from its wrapper (the paged kernel's rows
per split; the fewest steps that take the WKV kernel's chunked body),
or the chunked WKV kernel with one phase removed (its
output wrong: timing only), called through the kernel's wrapper on the
main paths' bf16 shapes, beside the plain version and the one PyTorch
call (SDPA; gather + SDPA for the paged kernel; none for the
recurrences) on the same inputs; device time comes from chip_smoke's
`device_ms` (torch.profiler, early in a fresh process, where it keeps
its events), two rounds in turns. A variant that changes the arithmetic
(one bf16 term of P, a fast exp, another chunk length) is timing only:
its output is printed as its largest difference from the repo's kernel,
never used. Prints the card's name and power limit, then one JSON line
per variant and round.
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
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import rwkv6_scan as wkv

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


# the WKV arms: (library variant, CHUNK, CHUNKED_MIN_STEPS) for the wrapper
WKV_ARMS = {"step body": ("kernel", wkv.CHUNK, 1 << 30),
            "chunked, C = 64": ("kernel", wkv.CHUNK, 1),
            "chunked, C = 32": ("C = 32", 32, 1)}
WKV_STEPS = (8, 12, 16, 24, 32, 48, 200, 4096)
WKV_CHUNK_LINE = "constexpr int kChunk = 64;"


def wkv_sweep(gen):
    """The WKV kernel (rwkv6-1.6b's 32 heads of 64, batch 1, bf16, the
    model's layout) at S around the chunked body's threshold and at the
    main path's S = 200 and a long prompt: the step body against the
    chunked body at C = 64 (the kernel) and C = 32 (the source with
    kChunk = 32, its scratch sized by the wrapper's CHUNK), through the
    wrapper with its settings and entry swapped for each arm's."""
    src = (build.CSRC / "rwkv6_scan.cu").read_text()
    libs = build_all("wkv_chunk", {
        "kernel": (src, None),
        "C = 32": (substituted(src, WKV_CHUNK_LINE,
                               WKV_CHUNK_LINE.replace("64", "32")), None)})
    bf = torch.bfloat16
    cases = []
    for s in WKV_STEPS:
        r, k, v = (torch.randn((1, s, 32, 64), generator=gen, device=cs.DEV)
                   .to(bf).transpose(1, 2) for _ in range(3))
        w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn(
            (1, s, 32, 64), generator=gen, device=cs.DEV))).transpose(1, 2)
        u = (0.1 * torch.randn((32, 64), generator=gen, device=cs.DEV)).to(bf)
        state = torch.randn((1, 32, 64, 64), generator=gen, device=cs.DEV)
        cases.append((s, (r, k, v, w, u), state))
    kept = wkv.CHUNK, wkv.CHUNKED_MIN_STEPS, wkv._entry
    wants = [wkv.rwkv6_scan_cuda(*a, st.clone())[0] for _, a, st in cases]
    try:
        for rnd in range(2):
            for arm, (lib, chunk, least) in WKV_ARMS.items():
                fn = libs[lib].rwkv6_scan_bf16
                fn.argtypes = wkv._ARGTYPES
                fn.restype = ctypes.c_int
                wkv._entry = lambda dtype, fn=fn: fn
                wkv.CHUNK, wkv.CHUNKED_MIN_STEPS = chunk, least
                row = {"kernel": "rwkv6_scan_bf16", "variant": arm,
                       "round": rnd}
                for (s, args, st), want in zip(cases, wants):
                    scratch = st.clone()
                    got = wkv.rwkv6_scan_cuda(*args, scratch)[0]
                    row[f"S={s}"] = {
                        "us": 1e3 * cs.device_ms(
                            lambda: wkv.rwkv6_scan_cuda(*args, scratch),
                            20, launches=2 if wkv.body(s) else 1),
                        "max_diff_vs_kernel": float(
                            (got - want).abs().max())}
                print(json.dumps(row), flush=True)
    finally:
        wkv.CHUNK, wkv.CHUNKED_MIN_STEPS, wkv._entry = kept


# phase-removed variants of the chunked WKV kernel (timing only: what each
# phase of a block's chain costs), and its diagonal with the per-lane
# branches the selects replaced
WKV_PHASES = {
    "no diagonal blocks": ("    // (a) the diagonal blocks, exact:",
                           "    if (false) // (a)"),
    "no logs": ("    // (b) per (sub-chunk, channel): log-decays,",
                "    if (false) // (b)"),
    "no off-diagonal blocks": (
        "    for (int p = warp; p < kPairs; p += kChunkThreads / 32) {",
        "    if (false) for (int p = warp; p < kPairs; "
        "p += kChunkThreads / 32) {"),
    "no A v": ("    // (d) the intra-chunk output A v into out: row block J, "
               "all or half of\n    // the hd columns a warp\n    {",
               "    if (false) {"),
    "no dS": ("    // (e) the chunk's contribution dS = k_dec^T v, k_dec = k~ "
              "prod_{m>I} E_m:\n    // a 16-channel row block of dS a warp "
              "(two warps share one at hd 32)\n    {",
              "    if (false) {"),
    "no fold": ("    if (!last) return;\n", "    return;\n"),
    "no staging wait": ("        attn::cp_async_wait<0>();\n        "
                        "__syncthreads();\n        if constexpr (Sm::kRaw) {",
                        "        __syncthreads();\n        "
                        "if constexpr (Sm::kRaw) {"),
    "diagonal with branches": (
        """                    const float coef =
                        after ? kp[j] : (here ? kp[j] * uv[j] : 0.f);
                    acc[t] = fmaf(rv[j], coef, acc[t]);
                    kp[j] = after ? kp[j] * wv[j] : kp[j];""",
        """                    if (here) {
                        acc[t] = fmaf(rv[j], kp[j] * uv[j], acc[t]);
                    } else if (after) {
                        acc[t] = fmaf(rv[j], kp[j], acc[t]);
                        kp[j] *= wv[j];
                    }"""),
}


def wkv_phase_sweep(gen):
    """The chunked WKV kernel with one phase removed at a time (its output
    wrong: timing only), bf16, rwkv6-1.6b's heads, batch 1, S = 200 and
    4096: a call's device time (both launches) beside the kernel's."""
    src = (build.CSRC / "rwkv6_scan.cu").read_text()
    variants = {"kernel": (src, None)}
    variants.update({name: (substituted(src, old, new), None)
                     for name, (old, new) in WKV_PHASES.items()})
    libs = build_all("wkv", variants)
    bf = torch.bfloat16
    cases = []
    for s in (200, 4096):
        r, k, v = (torch.randn((1, s, 32, 64), generator=gen, device=cs.DEV)
                   .to(bf).transpose(1, 2) for _ in range(3))
        w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn(
            (1, s, 32, 64), generator=gen, device=cs.DEV))).transpose(1, 2)
        u = (0.1 * torch.randn((32, 64), generator=gen, device=cs.DEV)).to(bf)
        state = torch.randn((1, 32, 64, 64), generator=gen, device=cs.DEV)
        cases.append((s, (r, k, v, w, u), state))
    original = wkv._entry
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                fn = lib.rwkv6_scan_bf16
                fn.argtypes = wkv._ARGTYPES
                fn.restype = ctypes.c_int
                wkv._entry = lambda dtype, fn=fn: fn
                row = {"kernel": "rwkv6_scan_bf16 phases", "variant": name,
                       "round": rnd}
                for s, args, st in cases:
                    scratch = st.clone()
                    row[f"S={s}"] = {"us": 1e3 * cs.device_ms(
                        lambda: wkv.rwkv6_scan_cuda(*args, scratch), 20)}
                wkv._entry = original
                print(json.dumps(row), flush=True)
    finally:
        wkv._entry = original


def rglru_variants():
    """The fused RG-LRU kernel with 32 and 64 channels a block."""
    src = (build.CSRC / "rglru_scan.cu").read_text()
    line = "constexpr int kChannels = 16;"
    return {"16 channels (kernel)": (src, None),
            "32 channels": (substituted(src, line, line.replace("16", "32")),
                            None),
            "64 channels": (substituted(src, line, line.replace("16", "64")),
                            None)}


def rglru_sweep(gen):
    """The fused RG-LRU at recurrentgemma-2b's width, bf16: the prefill
    (B = 1, S = 200), a decode step (B = 8) and a long prompt (S =
    4096), each variant's output against the kernel's (bitwise: the
    arithmetic does not change)."""
    libs = build_all("rglru", rglru_variants())
    bf, w = torch.bfloat16, 2560
    cases = []
    for label, b, s in (("prefill B=1 S=200", 1, 200),
                        ("decode B=8 S=1", 8, 1),
                        ("long B=1 S=4096", 1, 4096)):
        ga, gi, xa = (torch.randn((b, s, w), generator=gen, device=cs.DEV)
                      .to(bf) for _ in range(3))
        b_a, b_i = ((0.1 * torch.randn(w, generator=gen, device=cs.DEV))
                    .to(bf) for _ in range(2))
        lamb = (-1.0 + 4.0 * torch.rand(w, generator=gen, device=cs.DEV)
                ).to(bf)
        state = torch.randn((b, w), generator=gen, device=cs.DEV)
        cases.append((label, (ga, gi, b_a, b_i, lamb, xa), state))
    wants = [rg.rglru_scan_cuda(*a, st.clone())[0] for _, a, st in cases]
    original = rg._entry
    try:
        for rnd in range(2):
            row = {"kernel": "rglru_scan_bf16", "variant": "plain",
                   "round": rnd}
            for label, args, st in cases:
                row[label] = {"plain_us": 1e3 * cs.device_ms(
                    lambda: cs.ref.rglru_gated(*args, st), 3)}
            print(json.dumps(row), flush=True)
            for name, lib in libs.items():
                fn = lib.rglru_scan_bf16
                fn.argtypes = rg._ARGTYPES
                fn.restype = ctypes.c_int
                rg._entry = lambda dtype, fn=fn: fn
                row = {"kernel": "rglru_scan_bf16", "variant": name,
                       "round": rnd}
                for (label, args, st), want in zip(cases, wants):
                    scratch = st.clone()
                    got = rg.rglru_scan_cuda(*args, scratch)[0]
                    row[label] = {
                        "us": 1e3 * cs.device_ms(
                            lambda: rg.rglru_scan_cuda(*args, scratch), 20,
                            one_kernel=True),
                        "bitwise_vs_kernel": bool(torch.equal(got, want))}
                rg._entry = original
                print(json.dumps(row), flush=True)
    finally:
        rg._entry = original


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

    wkv_sweep(gen)
    wkv_phase_sweep(gen)
    rglru_sweep(gen)


if __name__ == "__main__":
    main()
