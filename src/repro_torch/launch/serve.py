"""Greedy continuous-batching serving on one GPU (the port's serving driver).

Runs the continuous-batching engine (`repro_torch.serve.Engine`) at its
default, overlapped admission where the family has a mixed step (the
dense GQA stack; rwkv6 and recurrentgemma serve serialized), on CUDA
unless --device cpu is given; with no GPU it raises rather than run on
the CPU unasked. Weights are random, from seed 0;
prompts are random token ids from seed 0. Example (full qwen2-0.5b width
on an H100):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 16 --max-batch 8 --prompt-len 200 --new-tokens 64 --mixed

and at smoke size on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --smoke --requests 4 --max-batch 2 --prompt-len 8 --new-tokens 4 \
        --device cpu

--arch rwkv6-1.6b serves the RWKV6 recurrent stack, --arch
recurrentgemma-2b the RG-LRU and local-attention hybrid (its 2048-token
window a ring in each slot), and --arch dbrx-132b and deepseek-v2-236b
(MLA attention over a latent cache) the mixture of experts (serialized:
its expert capacity depends on the prompt's length), from the arena,
each prompt prefilled at its exact length. --layers N keeps the first N
layers at full width, for a model whose depth does not fit the card
(dbrx-132b at 4 of its 40 layers is 28.5 GB in bf16, deepseek-v2-236b at
4 of its 60 layers 33.9 GB).

--mixed interleaves short (new_tokens // 4) and long budgets. --paged
serves from a shared pool of KV blocks (--block-size tokens each,
--num-blocks of them; default: the arena's footprint) with chunked
prefill, admitting under --preemption recompute (optimistic, preempting
the newest request when the pool runs dry) or reserve (worst-case
reservation); a model that cannot page (rwkv6, recurrentgemma, dbrx,
deepseek, a windowed MLA model) serves from the arena and says why. The
reference's --wave is not ported, and, as the reference's CLI, this one
always runs the engine's default scheduler (`Engine(overlap=False)` is
the serialized one). Prints tokens/s, p50/p99 request latency, the
resolved overlap mode with its mixed steps and overlapped admissions,
and, for the pool, preemptions and free blocks.

whisper-small (the encoder-decoder, whose prompts carry audio frames)
and phi-3-vision-4.2b (whose prompts carry a patch prefix) are not served
through the engine, which takes token-only prompts: as in the reference,
they go through a raw loop (`serve_raw`), one batched prefill of all
--requests prompts with random frames or patches, then --new-tokens
greedy decode steps. --layers cuts the decoder's depth there too (and
the encoder's to at most as many layers). For example, at full width on
an H100:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-small --requests 8 --prompt-len 32 --new-tokens 64
"""
from __future__ import annotations

import argparse
import time

from repro_torch.launch.train import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-feasible)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the config's first N layers (0: all)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--mixed", action="store_true",
                    help="interleave short (new_tokens//4) and long budgets")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV: shared block pool, block tables, "
                         "chunked prefill")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV block size in tokens")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="paged pool size in blocks (default: "
                         "max_batch * capacity / block_size)")
    ap.add_argument("--preemption", choices=("recompute", "reserve"),
                    default="recompute", help="paged admission policy")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def workload(args, vocab_size):
    """(prompts, budgets) of the run, from seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    short = max(1, args.new_tokens // 4)
    budgets = [short if (args.mixed and i % 2 == 0) else args.new_tokens
               for i in range(args.requests)]
    prompts = [rng.integers(0, vocab_size, (args.prompt_len,))
               for _ in range(args.requests)]
    return prompts, budgets


def build(args, cfg=None):
    """(device, cfg, model, params) for args: random weights from seed 0,
    made on the device. cfg: a config to build in place of --arch's (one
    the registry does not hold), cut by --layers all the same."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import build_model

    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers,
                                  layer_types=cfg.layer_types[:args.layers],
                                  encoder_layers=min(cfg.encoder_layers,
                                                     args.layers))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    return device, cfg, model, params


def paging_refusal(cfg):
    """Why a model of `cfg` cannot page, as the engine's probe finds."""
    if "moe" in cfg.layer_types:
        return "moe routing capacity depends on the chunk length"
    if cfg.mla is not None:
        return "windowed MLA has no windowed arena family"
    return "recurrent state"


def serve(args, overlap=True, cfg=None):
    """Serve the workload through `Engine(..., overlap=overlap)` (the CLI
    keeps the engine's default, overlapped where the family allows it);
    cfg: as `build`'s.
    Returns {"outputs" (token lists by uid),
    "budgets", "prefill_shapes" (the admitted prompt or chunk lengths),
    "step_ms" (host time of every engine step, ending in its
    token fetch), "decode_ms" (the decode part of each step that ran
    one: launch + [B]-token fetch), "admit_ms" (the admission part of
    each step that admitted: prefill launches + first-token fetch),
    "latency_s" (by uid), "tokens_per_s", "p50_s", "p99_s", "stats"
    (Engine.stats), "max_len", "paged", "num_preemptions", "free_blocks"
    and "num_blocks" (None for the arena), "peak_bytes" (the peak after
    the init), "init_peak_bytes" (the init's peak: the parameters drawn)
    and "init_bytes" (held once the engine was built), each None on the
    CPU, "device"}."""
    import numpy as np
    import torch

    from repro_torch.serve import Engine, bucket_length

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        # f32 products (MLA's absorbed decode) in full f32, never TF32, as
        # the reference computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    device, cfg, model, params = build(args, cfg)
    init_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    prompts, budgets = workload(args, cfg.vocab_size)
    max_len = bucket_length(args.prompt_len + max(budgets))
    eng = Engine(model, params, max_batch=args.max_batch, max_len=max_len,
                 paged=args.paged, block_size=args.block_size,
                 num_blocks=args.num_blocks, preemption=args.preemption,
                 overlap=overlap)
    del params      # the engine holds its compute-dtype copy
    init_bytes = torch.cuda.memory_allocated(device) if cuda else None

    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    latency, step_ms, decode_ms, admit_ms = {}, [], [], []
    while eng.pending or eng.num_active:
        ts = time.perf_counter()
        before = eng.stats
        done = eng.step()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        for r in done:
            latency[r.uid] = time.perf_counter() - t0
        after = eng.stats
        if after["decode_steps"] > before["decode_steps"]:
            decode_ms.append((after["decode_s"] - before["decode_s"]) * 1e3)
        if after["admissions"] > before["admissions"]:
            admit_ms.append(sum(after[k] - before[k] for k in
                                ("admit_host_s", "prefill_wait_s")) * 1e3)
    total = time.perf_counter() - t0
    done = {r.uid: r for r in eng.run()}

    toks = sum(len(done[u].output) for u in uids)
    lats = [latency[u] for u in uids]
    p50, p99 = (float(np.percentile(lats, q)) for q in (50, 99))
    backend = (f"paged, {eng.num_blocks} blocks of {eng.block_size}, "
               f"{eng.preemption}" if eng.paged else "arena")
    st = eng.stats
    scheduler = (f"overlapped, {st['overlap_mode']}" if eng.overlap
                 else "serialized")
    print(f"[{cfg.name}] continuous ({backend}, {scheduler}) on {device}: "
          f"{args.requests} reqs (budgets {sorted(set(budgets))}), "
          f"max_batch {args.max_batch}, capacity {eng.capacity}")
    print(f"  {toks} tokens in {total:.3f}s ({toks / total:.1f} tok/s); "
          f"latency p50 {p50:.3f}s p99 {p99:.3f}s")
    if args.paged and not eng.paged:
        reason = paging_refusal(cfg)
        print(f"  --paged: {cfg.name} cannot page ({reason}), so it was "
              "served from the arena")
    print(f"  overlap_mode {st['overlap_mode']!r}; mixed_steps "
          f"{st['mixed_steps']}; overlapped_admissions "
          f"{st['overlapped_admissions']}")
    print(f"  paged {eng.paged}; num_preemptions {eng.num_preemptions}; "
          f"free_blocks {eng.free_blocks}")
    for u in uids[:min(4, len(uids))]:
        print("  ", done[u].output.tolist())
    return {"outputs": [done[u].output.tolist() for u in uids],
            "budgets": budgets, "prefill_shapes": sorted(eng.prefill_shapes),
            "step_ms": step_ms, "decode_ms": decode_ms,
            "admit_ms": admit_ms, "latency_s": lats,
            "tokens_per_s": toks / total, "p50_s": p50, "p99_s": p99,
            "stats": st,
            "max_len": max_len, "paged": eng.paged,
            "num_preemptions": eng.num_preemptions,
            "free_blocks": eng.free_blocks,
            "num_blocks": eng.num_blocks if eng.paged else None,
            "device": str(device),
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if cuda else None),
            "init_peak_bytes": init_peak, "init_bytes": init_bytes}


# the families the engine cannot serve: the encoder-decoder has no slot
# arena, and a VLM's prompts carry a patch prefix
RAW_FAMILIES = ("audio", "encdec", "vlm")


def raw_prompt(cfg, requests, prompt_len, device):
    """The raw loop's batch, as the reference's `_serve_raw` draws it from
    `np.random.default_rng(0)`: {"tokens": int32 [B, P]} and, after them,
    "frames" [B, T_enc, D] (encoder-decoder) or "patches" [B, P_img, D]
    (VLM) in f32, on `device`; and the prefix length (the patches', or
    0)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    b = requests
    prompt = {"tokens": rng.integers(0, cfg.vocab_size,
                                     (b, prompt_len)).astype(np.int32)}
    prefix = 0
    if cfg.family in ("audio", "encdec"):
        prompt["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        prompt["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
        prefix = cfg.num_patches
    return ({k: torch.from_numpy(v).to(device) for k, v in prompt.items()},
            prefix)


def serve_raw(args, cfg=None, params=None):
    """The reference's raw loop (`repro/launch/serve.py: _serve_raw`), for
    the families the engine cannot serve: --requests prompts of
    --prompt-len random tokens (seed 0), with random frames [B, T_enc, D]
    (encoder-decoder) or patches [B, P, D] (VLM) drawn after them from the
    same generator, prefilled in one batch with a cache of prompt + prefix
    + --new-tokens rows, then --new-tokens greedy decode steps at
    positions p + prefix + i. The parameters are cast to the compute dtype
    once, before the loop, as the engine does (`raw_prompt` draws the
    batch). Prints what the reference prints. Returns {"tokens" ([B,
    new_tokens + 1]: the prefill's greedy token, then each decode
    step's), "prefill_s", "decode_s", "tokens_per_s" (decoded tokens a
    second), "prefix", "peak_bytes" (the run's peak after the init),
    "init_peak_bytes" (the init's and the cast's), each None on the CPU,
    "device"}. params: the parameters to serve (moved to the device), in
    place of the init's."""
    import torch

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    if params is None:
        device, cfg, model, params = build(args, cfg)
    else:
        from repro_torch.models import build_model

        model, device = build_model(cfg), resolve_device(args.device)
        params = {k: v.to(device) for k, v in params.items()}
    compute = getattr(torch, cfg.compute_dtype)
    params = {k: v.to(compute) if v.is_floating_point() else v
              for k, v in params.items()}
    init_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    print(f"[{cfg.name}] {cfg.family}: raw prefill/decode loop (engine "
          "serves token-only prompts)")

    b, p = args.requests, args.prompt_len
    prompt, prefix = raw_prompt(cfg, b, p, device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    total = p + prefix + args.new_tokens
    sync()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, prompt, cache_len=total)
    token = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    sync()
    prefill_s = time.perf_counter() - t0
    print(f"prefill: {b}x{p} tokens in {prefill_s:.3f}s")
    tokens = [token]
    t0 = time.perf_counter()
    for i in range(args.new_tokens):
        logits, caches = model.decode_step(params, token, caches,
                                           p + prefix + i)
        token = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        tokens.append(token)
    sync()
    decode_s = time.perf_counter() - t0
    rate = args.new_tokens * b / decode_s
    print(f"decode: {args.new_tokens} x batch {b} in {decode_s:.3f}s "
          f"({rate:.1f} tok/s)")
    return {"tokens": torch.cat(tokens, dim=1).cpu().tolist(),
            "prefill_s": prefill_s, "decode_s": decode_s,
            "tokens_per_s": rate, "prefix": prefix, "device": str(device),
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if cuda else None),
            "init_peak_bytes": init_peak}


def main(argv=None):
    args = parse_args(argv)
    from repro_torch.configs import get_config

    if get_config(args.arch).family in RAW_FAMILIES:
        return serve_raw(args)
    return serve(args)


if __name__ == "__main__":
    main()
