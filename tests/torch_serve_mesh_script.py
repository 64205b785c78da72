"""One rank of the port's serving checks across processes (run by
tests/test_torch_serve_mesh.py as 2 gloo processes on the CPU on the
("data", "model") = (1, 2) mesh, by tests/test_torch_serve_mesh_data.py
as 4 on (2, 2) and 2 on (2, 1), and with `--arch` by
tests/test_torch_serve_mesh_moe.py as 2 on (1, 2) and 4 on (2, 2)).

    python tests/torch_serve_mesh_script.py --rank R --world 4 \
        --model-parallel 2 --coordinator localhost:PORT \
        --params params.npz --out DIR [--arch dbrx,deepseek,mla]

Every rank builds the serving mesh of `--world` processes at
`--model-parallel` (default: all of them on "model"), loads the same
parameters (the reference's init, flattened by the test), serves each
scenario through `Engine(mesh=...)` in f32 and writes what it served to
DIR/rank<R>.json: each scenario's outputs by uid, its preemptions (and
those of its data line's rows), free blocks, resolved overlap mode, the
bytes it sent by kind and the bytes `dist.serving.serve_step_sends`
reckons from the engine's stats for the steps it ran
(`launch.serve_mesh.expected_sends`), and whether
`Collectives.all_reduce` equals the line-order sum of the gathered
tensors bitwise. Rank 0 also saves `first_decode_logits` on the mesh to
DIR/logits.pt.

With `--arch` (a comma-separated list of FAMILIES: the MoE smoke configs
and a dense MLA stack, each from `--params` DIR/<family>.npz) every rank
serves each family's SCENARIOS instead and writes DIR/rank<R>.json as
{family: {scenario: ..., "drops": ...}}: "drops" is a prefill of
DROP_PROMPTS in which the MoE layers drop slots at capacity, each MoE
call's dropped slots counted (`models.moe._experts`' pos >= cap) and
its first decode step's logits (rank 0: DIR/drops.<family>.pt, and the
scenarios' logits DIR/logits.<family>.pt). The recurrent families
(RECURRENT: rwkv6's and recurrentgemma's smoke configs, one kv head over
the axis for the latter) serve the same way, without "drops".

With `--wave` (a comma-separated list of WAVE: whisper-small's smoke
config, a variant of it whose vocabulary the axis does not divide, and
phi-3-vision's) every rank serves each family's raw-loop batch
(`launch.serve.raw_prompt`) through `dist.serving.make_prefill_step`
and `make_decode_step` and writes DIR/rank<R>.json as {family:
{"tokens", "sent", "sent_reckoned"}}; rank 0 saves the first decode
step's logits of an f32 cache to DIR/wave.<family>.pt.
"""
import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import ArchConfig, MLAConfig  # noqa: E402
from repro_torch.dist import serving  # noqa: E402
from repro_torch.dist.collectives import Collectives  # noqa: E402
from repro_torch.dist.tensor_parallel import (model_axis,  # noqa: E402
                                              serving_params)
from repro_torch.launch.mesh import (init_distributed,  # noqa: E402
                                     make_serving_mesh)
from repro_torch.launch.serve import raw_prompt  # noqa: E402
from repro_torch.launch.serve_mesh import expected_sends  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.serve import Engine, bucket_length  # noqa: E402
from repro_torch.serve.engine import probe_family_caps  # noqa: E402

# the reference's mesh-engine test config, in f32
CFG = ArchConfig(name="t", family="dense", source="test", num_layers=2,
                 d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                 d_ff=256, vocab_size=512, tie_embeddings=True,
                 compute_dtype="float32")
WINDOW = 16


def workloads():
    """{name: (prompts, budgets)}: "mixed" lengths and budgets in 2 rows;
    "ring": the reference's ring test (2 prompts, 24 tokens past a
    16-token window); "scarce": "mixed"'s prompts at budget 12 in a
    pool too small for two of them."""
    rng = np.random.default_rng(0)
    mixed = [rng.integers(0, CFG.vocab_size, (n,)) for n in (5, 7, 9, 12, 6)]
    rng = np.random.default_rng(3)
    ring = [rng.integers(0, CFG.vocab_size, (n,)) for n in (9, 12)]
    return {"mixed": (mixed, [4, 8, 6, 10, 5]), "ring": (ring, [24, 24]),
            "scarce": (mixed, [12] * len(mixed))}


# scenario: (workload, window, engine keywords)
SCENARIOS = {
    "arena": ("mixed", 0, dict(max_len=32)),
    "arena_serialized": ("mixed", 0, dict(max_len=32, overlap=False)),
    "paged": ("mixed", 0, dict(max_len=32, paged=True, block_size=8,
                               prefill_chunk=4)),
    "paged_serialized": ("mixed", 0, dict(max_len=32, paged=True,
                                          block_size=8, prefill_chunk=4,
                                          overlap=False)),
    "ring_arena": ("ring", WINDOW, dict(max_len=64)),
    "ring_paged": ("ring", WINDOW, dict(max_len=64, paged=True,
                                        block_size=4, num_blocks=7,
                                        prefill_chunk=8)),
    "ring_paged_serialized": ("ring", WINDOW, dict(
        max_len=64, paged=True, block_size=4, num_blocks=7, prefill_chunk=8,
        overlap=False)),
    "scarce_paged": ("scarce", 0, dict(max_len=32, paged=True, block_size=4,
                                       num_blocks=8, prefill_chunk=4)),
    "scarce_paged_serialized": ("scarce", 0, dict(
        max_len=32, paged=True, block_size=4, num_blocks=8, prefill_chunk=4,
        overlap=False)),
    "scarce_paged_reserve": ("scarce", 0, dict(
        max_len=32, paged=True, block_size=4, num_blocks=8, prefill_chunk=4,
        preemption="reserve")),
}


# the families the checks serve with --arch, in f32: the MoE smoke
# configs (dbrx-132b's GQA over 4 experts top-2; deepseek-v2-236b's MLA
# over 4 experts top-2 and a shared one) and tests/test_server.py's
# dense MLA stack
FAMILIES = {
    "dbrx": dataclasses.replace(get_smoke("dbrx-132b"),
                                compute_dtype="float32"),
    "deepseek": dataclasses.replace(get_smoke("deepseek-v2-236b"),
                                    compute_dtype="float32"),
    "mla": ArchConfig(name="mla-overlap-t", family="dense", source="test",
                      num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                      d_ff=128, vocab_size=256, tie_embeddings=True,
                      compute_dtype="float32",
                      mla=MLAConfig(kv_lora_rank=16, q_lora_rank=32,
                                    qk_nope_head_dim=16, qk_rope_head_dim=8,
                                    v_head_dim=16)),
}
# the recurrent families the checks serve with --arch, in f32: rwkv6's
# smoke config (2 heads of 64, 1 a rank) and recurrentgemma's (RG-LRU
# channels over the axis, its MQA layer's one kv head on every rank)
RECURRENT = {
    "rwkv6": dataclasses.replace(get_smoke("rwkv6-1.6b"),
                                 compute_dtype="float32"),
    "recurrentgemma": dataclasses.replace(get_smoke("recurrentgemma-2b"),
                                          compute_dtype="float32"),
}
# the wave path's families, in f32: whisper-small's smoke config, the same
# with a vocabulary of 515 (odd: the axis keeps the table and the head
# whole) and phi-3-vision's with its 8 patches
_WHISPER = dataclasses.replace(get_smoke("whisper-small"),
                               compute_dtype="float32")
WAVE = {
    "whisper": _WHISPER,
    "whisper515": dataclasses.replace(_WHISPER, name="whisper-odd-vocab",
                                      vocab_size=515),
    "phi3": dataclasses.replace(get_smoke("phi-3-vision-4.2b"),
                                compute_dtype="float32"),
}
# each wave family's raw-loop run: requests, prompt length, new tokens
# (3 requests do not divide over a data axis of 2: every line serves
# the whole batch, as the reference replicates it)
WAVE_RUNS = {"whisper": (4, 8, 6), "whisper515": (3, 8, 6),
             "phi3": (4, 8, 6)}
# the dense MLA stack's scenarios: (workload, engine keywords); the MoE
# families serve its arena one (an MoE model serves from the serialized
# arena whatever it asks for)
_DENSE_MLA = {
    "arena": ("family", dict(max_len=32)),
    "arena_serialized": ("family", dict(max_len=32, overlap=False)),
    "paged": ("family", dict(max_len=32, paged=True, block_size=8,
                             prefill_chunk=4)),
    "paged_serialized": ("family", dict(max_len=32, paged=True,
                                        block_size=8, prefill_chunk=4,
                                        overlap=False)),
    "scarce_paged": ("family_scarce", dict(max_len=32, paged=True,
                                           block_size=4, num_blocks=8,
                                           prefill_chunk=4)),
}
SCENARIOS_OF = {"dbrx": {"arena": _DENSE_MLA["arena"]},
                "deepseek": {"arena": _DENSE_MLA["arena"]},
                "mla": _DENSE_MLA,
                # exact prompt lengths on the arena (the recurrent
                # families' FamilyCaps), recurrentgemma's past its window
                "rwkv6": {"arena": ("recurrent", dict(max_len=64))},
                "recurrentgemma": {"arena": ("recurrent",
                                             dict(max_len=64))}}
ARCHS = {**FAMILIES, **RECURRENT}
# the drops prefill: two prompts of 40 tokens, whose MoE layers drop
# slots at capacity (20 a bucket for S = 40 at top-2 of 4, factor 1.25)
DROP_PROMPTS = 40


def family_workloads(vocab):
    """{name: (prompts, budgets)} of the families: "family" (4 requests
    of two prompt lengths, in 2 rows: the reference's MoE engine compiles
    a prefill a length), "family_scarce" (its prompts at budget 12, a
    pool too small for two of them) and "drops" (2 prompts of
    DROP_PROMPTS)."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, vocab, (n,)) for n in (6, 9, 9, 6)]
    drops = [rng.integers(0, vocab, (DROP_PROMPTS,)) for _ in range(2)]
    rng = np.random.default_rng(6)
    recurrent = [rng.integers(0, vocab, (n,)) for n in (40, 9, 37, 6)]
    return {"family": (prompts, [5, 8, 4, 6]),
            "family_scarce": (prompts, [12] * len(prompts)),
            "drops": (drops, [1, 1]),
            # prompts past recurrentgemma's 32-token window, at their
            # exact lengths
            "recurrent": (recurrent, [6, 8, 5, 7])}


class DropCount:
    """Within the block, each `models.moe._experts` call appends the
    number of its slots dropped at capacity (pos >= cap, over every
    expert, as routing counts them on every rank) to `calls`."""

    def __enter__(self):
        self.calls = []
        self.real = MOE._experts

        def counting(params, cfg, xr, gate_i, pos, send, groups, cap,
                     axis=None):
            self.calls.append(int((pos >= cap).sum()))
            return self.real(params, cfg, xr, gate_i, pos, send, groups,
                             cap, axis)

        MOE._experts = counting
        return self

    def __exit__(self, *exc):
        MOE._experts = self.real


def first_decode_logits(model, params, prompts, capacity, mesh=None,
                        comm=None):
    """The logits [B, 1, V] (the whole vocabulary) of the first decode
    step of `prompts` (B token-id arrays) admitted into slots 0..B-1 of
    an arena of `capacity` in the compute dtype, each padded to its
    bucket as the engine pads it (at its exact length where the family
    does not pad, as MoE), and decoded from its greedy first token:
    through `model` itself, or on `mesh` through this rank's slice
    (`dist.serving.local_model`) of its data line's rows
    (`dist.serving.RowSplit`; the slices and rows gathered). The
    parameters are the engine's (`tensor_parallel.serving_params`)."""
    pad = probe_family_caps(model, capacity=capacity).pad_prompts
    device = next(iter(params.values())).device
    steps, axis = model, None
    if mesh is not None:
        steps = serving.local_model(model, mesh, comm)
        axis = model_axis(mesh, comm)
    rows = serving.RowSplit(len(prompts), mesh, comm, device)
    params = serving_params(model.cfg, params, mesh)
    arena = steps.init_arena(rows.rows, capacity,
                             dtype=getattr(torch, model.cfg.compute_dtype),
                             device=device)
    mine = prompts[rows.lo:rows.hi]
    firsts = []
    for row, p in enumerate(mine):
        width = min(bucket_length(len(p), 8), capacity) if pad else len(p)
        toks = np.zeros((1, width), np.int32)
        toks[0, :len(p)] = p
        tok, arena = steps.prefill_into_slot_token(
            params, torch.from_numpy(toks).to(device), len(p), row, arena)
        firsts.append(tok)
    positions = torch.tensor([len(p) for p in mine], dtype=torch.int32,
                             device=device)
    logits, _ = steps.decode_rows(params, torch.stack(firsts)[:, None],
                                  arena, positions)
    if axis is not None:
        logits = axis.gather_vocab(logits)
    return rows.gather(logits)


def serve(model, params, prompts, budgets, mesh=None, **kw):
    """Serve every request through one engine; (engine, {uid: tokens})."""
    eng = Engine(model, params, max_batch=2, mesh=mesh,
                 cache_dtype=torch.float32, **kw)
    for p, b in zip(prompts, budgets):
        eng.submit(p, max_new_tokens=b)
    done = eng.run()
    assert eng.num_preemptions == sum(r.preemptions for r in done)
    return eng, {r.uid: r.output.tolist() for r in done}


def record(eng, outputs, cfg, mesh):
    """What a rank writes of a scenario's engine: its outputs, its
    preemptions and blocks, its resolved overlap, the bytes it sent and
    (where no mixed step ran: a mixed step's prefill unit is one
    prompt's, and the prompts differ) the bytes `serve_step_sends`
    reckons."""
    st = eng.stats
    out = {"outputs": outputs, "preemptions": st["preemptions"],
           "line_preemptions": st["line_preemptions"],
           "paged": eng.paged, "overlap": eng.overlap,
           "overlap_mode": eng.overlap_mode,
           "free_blocks": eng.free_blocks,
           "num_blocks": eng.num_blocks if eng.paged else None,
           "sent": dict(eng.comm.sent),
           "line_admissions": st["line_admissions"],
           "first_tokens": st["first_tokens"],
           "mixed_steps": st["mixed_steps"]}
    if not st["mixed_steps"]:
        out["sent_reckoned"] = expected_sends(eng, st, cfg, mesh, mesh.rank,
                                              None)
    return out


def serve_families(names, params_dir, mesh, out_dir, rank):
    """Every family of `names` served on `mesh` (see the module's
    docstring): {family: {scenario: record, "drops": ...}}."""
    comm = Collectives(mesh, torch.device("cpu"))
    out = {}
    for name in names:
        cfg = ARCHS[name]
        with np.load(os.path.join(params_dir, f"{name}.npz")) as f:
            params = {k: torch.from_numpy(f[k]) for k in f.files}
        loads = family_workloads(cfg.vocab_size)
        model = build_model(cfg)
        got = {}
        for scenario, (load, kw) in SCENARIOS_OF[name].items():
            prompts, budgets = loads[load]
            eng, outputs = serve(model, params, prompts, budgets, mesh=mesh,
                                 **kw)
            got[scenario] = record(eng, outputs, cfg, mesh)
        logits = first_decode_logits(model, params, *logit_prompts(name),
                                     mesh=mesh, comm=comm)
        if rank == 0:
            torch.save(logits, os.path.join(out_dir, f"logits.{name}.pt"))
        if name in FAMILIES:
            with DropCount() as drops:
                drop_logits = first_decode_logits(model, params,
                                                  loads["drops"][0], 64,
                                                  mesh=mesh, comm=comm)
            got["drops"] = drops.calls
            if rank == 0:
                torch.save(drop_logits, os.path.join(out_dir,
                                                     f"drops.{name}.pt"))
        out[name] = got
    return out


def logit_prompts(name):
    """(prompts, capacity) of a family's first-decode logits: the first two
    of its scenarios' workload."""
    load, kw = next(iter(SCENARIOS_OF[name].values()))
    prompts = family_workloads(ARCHS[name].vocab_size)[load][0][:2]
    return prompts, bucket_length(kw["max_len"])


def wave_serve(model, params, batch, prefix, new_tokens, mesh=None,
               comm=None, cache_dtype=torch.bfloat16):
    """`launch.serve.serve_raw`'s loop on `batch` through the wave steps
    (`dist.serving.make_prefill_step` / `make_decode_step`) on `mesh`, or
    through `model` itself: a prefill with a cache of prompt + `prefix` +
    `new_tokens` rows, then `new_tokens` greedy steps. Returns (the
    tokens [B, new_tokens + 1], a function of no arguments that gives the
    last step's logits of every row and the whole vocabulary: on a mesh
    it gathers them, a check's view that the steps do not send)."""
    b, p = batch["tokens"].shape
    total = p + prefix + new_tokens
    if mesh is None:
        logits, caches = model.prefill(params, batch, cache_len=total,
                                       cache_dtype=cache_dtype)
        ids = torch.argmax(logits[:, -1], -1).to(torch.int32)
        tokens = [ids]
        for i in range(new_tokens):
            logits, caches = model.decode_step(params, ids[:, None], caches,
                                               p + prefix + i)
            ids = torch.argmax(logits[:, -1], -1).to(torch.int32)
            tokens.append(ids)
        return torch.stack(tokens, 1), lambda: logits
    prefill, rows = serving.make_prefill_step(model, mesh, comm, b)
    decode, _ = serving.make_decode_step(model, mesh, comm, b)
    ids, logits, caches = prefill(params, batch, cache_len=total,
                                  cache_dtype=cache_dtype)
    tokens = [ids]
    for i in range(new_tokens):
        ids, logits, caches = decode(params, ids[:, None], caches,
                                     p + prefix + i)
        tokens.append(ids)

    def whole():
        got = logits
        if got.shape[-1] != model.cfg.vocab_size:
            got = model_axis(mesh, comm).gather_vocab(got)
        return rows.gather(got)

    return torch.stack(tokens, 1), whole


def wave_batch(name):
    """A wave family's raw-loop batch on the CPU (`launch.serve.
    raw_prompt`) and its prefix length."""
    cfg = WAVE[name]
    b, p, _ = WAVE_RUNS[name]
    return raw_prompt(cfg, b, p, torch.device("cpu"))


def wave_families(names, params_dir, mesh, out_dir, rank):
    """Every wave family of `names` served on `mesh` (the module's
    docstring): {family: {"tokens", "sent", "sent_reckoned"}}."""
    comm = Collectives(mesh, torch.device("cpu"))
    out = {}
    for name in names:
        cfg = WAVE[name]
        with np.load(os.path.join(params_dir, f"{name}.npz")) as f:
            params = {k: torch.from_numpy(f[k]) for k in f.files}
        model = build_model(cfg)
        params = serving_params(cfg, params, mesh)
        batch, prefix = wave_batch(name)
        b, p, new = WAVE_RUNS[name]
        comm.reset()
        tokens, _ = wave_serve(model, params, batch, prefix, new, mesh, comm)
        sent = dict(comm.sent)
        steps = serving.serve_step_sends(cfg, mesh, b, p)[mesh.rank]
        want = {}
        for step, n in (("wave_prefill", 1), ("wave_decode", new)):
            for kind, nbytes in steps[step].items():
                want[kind] = want.get(kind, 0) + n * nbytes
        # the first decode step's logits of an f32 cache
        _, logits = wave_serve(model, params, batch, prefix, 1, mesh, comm,
                               cache_dtype=torch.float32)
        logits = logits()
        out[name] = {"tokens": tokens.tolist(), "sent": sent,
                     "sent_reckoned": want}
        if rank == 0:
            torch.save(logits, os.path.join(out_dir, f"wave.{name}.pt"))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="the mesh's model axis (default: --world)")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--params", required=True,
                    help="the .npz (with --arch: the directory of each "
                         "family's <family>.npz)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--arch", default=None,
                    help="serve these FAMILIES or RECURRENT families "
                         "(comma-separated) instead")
    ap.add_argument("--wave", default=None,
                    help="serve these WAVE families (comma-separated) "
                         "through the wave steps instead")
    args = ap.parse_args()
    device = torch.device("cpu")
    init_distributed(args.rank, args.world, args.coordinator, "gloo", device,
                     timeout_s=300)
    mesh = make_serving_mesh(args.model_parallel or args.world)
    if args.arch or args.wave:
        out = (serve_families(args.arch.split(","), args.params, mesh,
                              args.out, args.rank) if args.arch else
               wave_families(args.wave.split(","), args.params, mesh,
                             args.out, args.rank))
        with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
            json.dump(out, f)
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
        return
    with np.load(args.params) as f:
        params = {k: torch.from_numpy(f[k]) for k in f.files}
    loads = workloads()
    out = {}
    for name, (load, window, kw) in SCENARIOS.items():
        prompts, budgets = loads[load]
        eng, outputs = serve(build_model(CFG, window=window), params,
                             prompts, budgets, mesh=mesh, **kw)
        out[name] = record(eng, outputs, CFG, mesh)
    prompts = loads["mixed"][0][:2]
    comm = Collectives(mesh, device)
    logits = first_decode_logits(build_model(CFG), params, prompts, 32,
                                 mesh=mesh, comm=comm)
    # all_reduce (the axis's sums: one exchange on a line of 2) against
    # the gathered tensors summed in the line's order
    x = torch.randn((7, 13), generator=torch.Generator().manual_seed(
        args.rank))
    pieces = comm.all_gather(x, "model")
    total = pieces[0]
    for piece in pieces[1:]:
        total = total + piece
    out["all_reduce_is_the_line_order_sum"] = torch.equal(
        comm.all_reduce(x, "model"), total)
    with open(os.path.join(args.out, f"rank{args.rank}.json"), "w") as f:
        json.dump(out, f)
    if args.rank == 0:
        torch.save(logits, os.path.join(args.out, "logits.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
