"""Slot-based continuous-batching greedy serving engine (arena or paged KV).

A port of `repro/serve/engine.py`, with both of its schedulers (the
overlapped one by default, as in the reference):

  * a fixed batch of `max_batch` decode rows and ONE decode step over all
    of them; dead rows decode garbage that the host ignores, and are
    recycled;
  * an admission scheduler that prefills queued requests into free rows
    between decode steps (FIFO): a round launches every admissible
    prefill, then resolves their first tokens in one batched fetch;
  * two KV storage modes behind the same submit/step/run API:

    **arena** (default): each row owns a full capacity-T cache row
    (`Model.init_arena`, T = the power-of-two bucket of `max_len`), so a
    request is bounded by `plen + max_new_tokens <= capacity`; prompts
    are right-padded to a power-of-two bucket of at least 8 where that
    is inert (`FamilyCaps.pad_prompts`: a full-causal attention stack)
    and prefill at their exact length otherwise (a stack with recurrent
    layers, whose state would fold the pads in, with MoE layers, whose
    expert capacity follows the prompt's length, or with a sliding window
    below the capacity, whose ring the pads would wrap). A recurrent
    layer's row holds its state, not a KV cache; a windowed attention
    layer's row is a ring of the window's capacity.

    **paged** (`paged=True`): all rows share one pool of fixed-size KV
    blocks (`Model.init_pool`) through host-side block tables
    (`serve.paging`). Blocks are allocated as decode crosses block
    boundaries and freed when a request finishes, so memory follows live
    tokens and a request is bounded by the pool, not a slot. Prompts
    stream in through fixed-size chunks (`prefill_chunk`). A
    sliding-window model pages as a block RING (position p at ring slot
    p % window): a slot holds at most ceil(window / block_size) blocks,
    and a full ring allocates no further block however long it runs. A
    family that cannot page (`FamilyCaps.supports_paging`: recurrent
    state has no pages, chunks would change MoE expert capacity, and
    windowed MLA has no windowed arena family to match) serves from the
    arena, as the reference does;
    `engine.paged` says which backend is in use.

    Paged admission has two policies (`preemption=`). "recompute"
    (default) admits a request when the blocks free right now cover its
    prompt plus a one-block watermark; when a decode step needs a block
    and the pool is empty, it preempts the newest admission (LIFO), frees
    its blocks and re-queues it in uid position. On re-admission its
    prompt streams in through the same chunks at the same offsets, and
    its generated tokens replay through the decode step, one per step,
    so every position is rebuilt by the step that wrote it and the final
    output equals an unpreempted run's. "reserve" admits only against
    the worst case (`available >= worst_case_blocks`) and never preempts;

  * token-returning steps: the greedy argmax runs on the device and the
    host fetches int32 ids, [B] per decode step, never logits; the decode
    step's next tokens and advanced lengths stay on the device and feed
    the next step, so steady-state decoding uploads nothing (the host
    mirrors, block tables included, re-upload only when admission, a
    finish, a preemption, a block top-up or a replay changes them).

  * overlapped admission (`overlap=True`, the default where the family
    has a mixed step): admission does not block the decode step. The
    queue head's prefill rides the decode launch of the live rows as a
    **stream**, in one fused mixed step (`Model.mixed_step_tokens` on the
    arena: the whole padded prompt; `mixed_step_paged_tokens` on the
    pool: one chunk a step), and on the pool every further admissible
    request is **staged**: its chunk launches go in flight in the same
    pass. A streaming or staged slot stays dead to decode (the arena's
    mixed step overwrites the dead row whole after its decode insert; a
    pool slot keeps a zeroed table row and length 0, so its decode
    writes go to the null block, and its blocks live in a private table)
    until `_resolve_staged` installs it at the start of a later step,
    after that step's `[B]` fetch has synchronised past the launches
    that produced its first token. Staged admissions resolve together
    with the stream they queued behind, oldest first, so FIFO completion
    order survives. `overlap_mode="async"` runs the serialized step
    functions back to back with no fetch between them instead of the
    fused step (the pool stages every admission; the arena decodes, then
    prefills the stream's slot). The arena cannot stage: its decode
    inserts at a cache-carried per-slot ptr, which would clobber a staged
    prefill's row. A windowed arena (prompts at their exact length) and
    the recurrent families stay serialized.

Greedy decode is row-independent, so a request's output does not depend
on what else is in the batch, on preemption, on the storage mode or on
the scheduler: the overlapped engine's tokens equal the serialized
engine's (each half of the mixed step sees the operands of its
standalone step; `models/transformer.py` says which shared product had
to run per half on the card). The engine casts the parameters to the
compute dtype once at construction (the reference casts inside every
jitted call; in eager PyTorch that would be a full-model cast per step).
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter, deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import serving
from repro_torch.dist.tensor_parallel import SUM_DTYPE, serving_params
from repro_torch.serve.bucketing import (bucket_length, chunks_needed,
                                         table_width)
from repro_torch.serve.paging import BlockAllocator, blocks_needed
from repro_torch.utils.hotpath import hot_loop

_PREFILL_FLOOR = 8      # smallest prompt bucket
_ADMIT_WATERMARK = 1    # spare blocks optimistic admission leaves free


@dataclasses.dataclass(frozen=True)
class FamilyCaps:
    """What the serving engine may do with a model (the reference's
    flags):

      pad_prompts: padding prompts to pow2 buckets is inert (an attention
        stack whose rings hold the whole capacity). Recurrent layers fold
        the pads into their state, MoE routing capacity depends on the
        static sequence length, and a sliding-window ring would let pads
        evict real context: those prefill at exact lengths.
      supports_paging: the block-pool backend works (an attention stack
        whose `init_pool` builds a pool; recurrent state has no pages to
        page, chunked prefill would change MoE expert capacity, and a
        windowed MLA model's `init_pool` raises).
      supports_chunked_prefill: prompts can stream in through fixed
        chunks (the pool's admission; the same predicate).
      supports_mixed_step: the fused decode + prefill step is sound: a
        dead slot that the fused prefill overwrites whole (pad_prompts,
        on the arena) or whose writes go to the null block (paging), and
        the model's two mixed entry points. The engine also requires its
        resolved backend to be one of those: a windowed arena stays
        serialized, a windowed pool overlaps.
    """
    pad_prompts: bool
    supports_paging: bool
    supports_chunked_prefill: bool
    supports_mixed_step: bool


def probe_family_caps(model, *, capacity: int) -> FamilyCaps:
    """The serving capabilities of `model` at slot capacity `capacity`
    (a sliding window below it disables padding). Paging needs an
    `init_pool` that builds a pool: it is tried on the meta device, where
    it allocates nothing, and a windowed MLA model's raises, as the
    reference's probe finds."""
    all_attn = all(t == "attn" for t in model.cfg.layer_types)
    window = int(model.window or 0)
    pad = all_attn and (not window or window >= capacity)
    paging = all_attn and model.init_pool is not None
    if paging:
        try:
            model.init_pool(1, 2, device="meta")
        except NotImplementedError:
            paging = False
    mixed = bool((pad or paging) and model.mixed_step_tokens is not None
                 and model.mixed_step_paged_tokens is not None)
    return FamilyCaps(pad_prompts=pad, supports_paging=paging,
                      supports_chunked_prefill=paging,
                      supports_mixed_step=mixed)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    output: Optional[np.ndarray] = None
    # preempt-and-recompute bookkeeping: tokens generated before the
    # request was last evicted; they replay through the decode step on
    # re-admission and lead the final output
    gen_prefix: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0


class Engine:
    """Continuous-batching greedy-decode engine over one model + params.

    API: submit(prompt, max_new_tokens, eos_id) -> uid; step() ->
    requests finished by this step; run() -> drain the queue. The engine
    runs where the parameters lie (CUDA or CPU).

    paged=True asks for the block-pool backend (a family that cannot
    page serves from the arena; `engine.paged` tells); block_size,
    num_blocks (default: the arena's footprint, max_batch * capacity
    tokens) and prefill_chunk size it, and preemption picks its admission
    policy ("recompute" or "reserve"; see the module docstring).

    overlap=True (default) overlaps admission with decode where the
    family and backend allow it (`engine.overlap` tells); overlap_mode
    picks how: "fused" runs the mixed step, "async" the serialized step
    functions back to back without a fetch between them, and "auto" is
    "async" on a mesh whose data axes are above 1 and "fused" elsewhere,
    as the reference picks it. "fused" on a data axis above 1 raises:
    the mixed step's one token-concatenated batch has no rows to split,
    and the reference, which replicates it there, reads it as slower
    than serialized and not bitwise.

    mesh (a `launch.mesh.Mesh` over processes, ("data", "model");
    `launch.mesh.make_serving_mesh`): every rank runs this engine in
    lockstep on the same submissions. The engine keeps this rank's shard
    of `params` (the whole model's, `dist.tensor_parallel.shard_params`,
    or the rank's piece itself, `tensor_parallel.init_shard`, told apart
    by the leaves' shapes),
    the steps of `dist.serving.local_model`, which sum over the model
    axis, and the decode rows of its data line (`engine.rows`, a
    `dist.serving.RowSplit`; max_batch must be a multiple of the data
    size): an arena of its rows, or the whole pool, each of this rank's
    kv heads. Each line decodes its rows and prefills the admissions of
    its slots; the gathers over the data axes give every rank the same
    `[B]` ids and first tokens (`engine.comm`, a
    `dist.collectives.Collectives`, counts the bytes and milliseconds of
    both axes). The scheduler reads nothing else from the device, and no
    clock steers it. A mesh of one rank serves as without a mesh.
    """

    def __init__(self, model, params, *, max_batch: int = 8,
                 max_len: int = 256, cache_dtype=torch.bfloat16, mesh=None,
                 paged: bool = False, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefill_chunk: int = 32,
                 preemption: str = "recompute", overlap: bool = True,
                 overlap_mode: str = "auto"):
        if preemption not in ("recompute", "reserve"):
            raise ValueError(f"preemption must be 'recompute' or 'reserve', "
                             f"got {preemption!r}")
        if overlap_mode not in ("auto", "fused", "async"):
            raise ValueError(f"overlap_mode must be 'auto', 'fused' or "
                             f"'async', got {overlap_mode!r}")
        if model.prefill_into_slot_token is None:
            raise NotImplementedError(
                f"family {model.cfg.family!r} has no slot-arena entry points")
        self.model = model
        self.device = next(iter(params.values())).device
        self.mesh = mesh
        self.max_batch = int(max_batch)
        comm = None
        steps = model       # the model whose entry points serve
        if mesh is not None:
            from repro_torch.dist.collectives import Collectives

            comm = Collectives(mesh, self.device)
            steps = serving.local_model(model, mesh, comm)
        # the decode rows this rank holds (all of them off a data axis)
        self.rows = serving.RowSplit(self.max_batch, mesh, comm,
                                      self.device)
        self.comm = (comm if steps is not model or self.rows.size > 1
                     else None)
        self.params = serving_params(model.cfg, params, mesh)
        self.capacity = bucket_length(max_len)
        self.caps = probe_family_caps(model, capacity=self.capacity)
        self.paged = bool(paged and self.caps.supports_paging)
        self.preemption = preemption
        self.num_preemptions = 0    # total evictions
        # the model's sliding window (0 = full causal): a ring on the pool
        self.window = int(model.window or 0)
        # overlap needs the mixed step and a backend whose dead slots
        # survive a fused prefill: the pool (null-block routing) or an
        # arena that pads prompts; a windowed arena stays serialized
        self.overlap = bool(overlap and self.caps.supports_mixed_step
                            and (self.paged or self.caps.pad_prompts))
        if overlap_mode == "auto":
            overlap_mode = "async" if self.rows.size > 1 else "fused"
        elif overlap_mode == "fused" and self.rows.size > 1:
            raise ValueError(
                f"overlap_mode 'fused' on a data axis of {self.rows.size}: "
                "the mixed step's one batch has no rows to split over it; "
                "use 'async' (what 'auto' picks there)")
        # the resolved strategy ("" without overlap)
        self.overlap_mode = overlap_mode if self.overlap else ""
        self._mixed = None
        self.prefill_shapes: set = set()    # admitted Sp / chunk sizes
        if self.paged:
            self.block_size = int(block_size)
            self.num_blocks = int(
                num_blocks if num_blocks is not None
                else max(1, self.max_batch * self.capacity // self.block_size))
            self.prefill_chunk = int(prefill_chunk)
            if self.window:
                # a chunk wider than the ring would write two of its
                # positions into one ring slot in one scatter (undefined
                # winner): only chunk <= window keeps the later one
                self.prefill_chunk = min(self.prefill_chunk, self.window)
            self._allocator = BlockAllocator(self.num_blocks)
            # one table row per decode slot, as wide as the pool; the
            # decode step sees a power-of-two slice wide enough for the
            # live maximum (_table_width)
            self._tables = np.zeros((self.max_batch, self.num_blocks),
                                    np.int32)
            self._slot_reserved = [0] * self.max_batch
            self._prefill = steps.prefill_chunk_into_blocks_token
            self._decode = steps.decode_rows_paged_tokens
            if self.overlap_mode == "fused":
                self._mixed = steps.mixed_step_paged_tokens
            self._caches = steps.init_pool(self.num_blocks, self.block_size,
                                           dtype=cache_dtype,
                                           device=self.device)
        else:
            self._prefill = steps.prefill_into_slot_token
            self._decode = steps.decode_rows_tokens
            if self.overlap_mode == "fused":
                self._mixed = steps.mixed_step_tokens
            self._caches = steps.init_arena(self.rows.rows, self.capacity,
                                            dtype=cache_dtype,
                                            device=self.device)
        if self.comm is not None:
            # gloo's host buffers at the largest sum a step makes: the
            # mixed batch of every row and the longest prefill unit, in
            # the row-parallel products' SUM_DTYPE (the data axes' gathers
            # of int32 ids are far smaller)
            unit = self.prefill_chunk if self.paged else self.capacity
            self.comm.reserve((self.max_batch + unit) * model.cfg.d_model
                              * SUM_DTYPE.itemsize)

        self._queue: Deque[Request] = deque()
        self._done: List[Request] = []
        self._next_uid = 0
        self._slot_req: List[Optional[Request]] = [None] * self.max_batch
        self._gen: List[List[int]] = [[] for _ in range(self.max_batch)]
        # tokens a recomputed slot still replays through the decode step
        # before it is live again (paged "recompute" only)
        self._replay: List[Deque[int]] = [deque()
                                          for _ in range(self.max_batch)]
        self._lengths = np.zeros(self.max_batch, np.int32)  # tokens in cache
        self._cur = np.zeros(self.max_batch, np.int32)      # current token
        # device mirrors of the decode step's small operands: the step
        # returns next tokens and advanced lengths, which feed straight
        # back in; they re-upload only when a host event makes the host
        # values differ
        self._cur_dev = None
        self._lengths_dev = None
        self._tables_dev = None
        self._tables_dev_w = -1      # width of the uploaded table slice
        self._cur_dirty = True
        self._lengths_dirty = True
        self._tables_dirty = True
        # overlapped admission: `_stream` is the one admission whose
        # prefill rides the decode launches (the whole padded prompt in
        # one mixed step on the arena, a chunk a step on the pool);
        # `_staged` holds admissions whose prefill launches are all in
        # flight and whose first token is not resolved yet. Their slots
        # stay dead to decode until `_resolve_staged`; on the pool their
        # blocks live in the entry's private table until then.
        self._stream: Optional[dict] = None
        self._staged: List[dict] = []
        self._stats = {
            "admissions": 0,         # requests prefilled into a slot
            "admit_host_s": 0.0,     # host time launching admissions
            "prefill_wait_s": 0.0,   # blocked resolving prefill tokens
            "decode_steps": 0,
            "decode_s": 0.0,         # decode launch + [B]-token fetch
            "decode_dispatch_s": 0.0,   # ... its mirror-sync + launch half
            "decode_fetch_s": 0.0,      # ... its blocked-on-tokens half
            "mixed_steps": 0,        # decode launches that carried a prefill
            "overlapped_admissions": 0,  # first tokens resolved deferred
                                         # (never blocked a decode dispatch)
            "topup_host_s": 0.0,     # paged block top-up / eviction work
            "replayed_tokens": 0,    # recompute replays (paged)
            "h2d_uploads": 0,        # mirror re-syncs (stale -> upload)
            "decode_fetch_elems": 0,    # size of the per-step fetch ...
            "decode_fetch_dtype": "",   # ... proof it is [B] int32 ids
            "line_admissions": 0,    # admissions prefilled on this data line
            "line_preemptions": 0,   # preemptions of this data line's rows
            # this data line's prefill launches outside a mixed step, by
            # their token rows (the arena's padded prompt, the pool's chunk)
            "line_prefill_units": Counter(),
            "first_tokens": 0,       # admissions' first tokens resolved
        }

    @property
    def stats(self) -> dict:
        """Per-step telemetry, with the reference's keys: admission host
        time vs prefill wait vs decode step time, block top-up time,
        mixed steps and overlapped admissions, replayed tokens, mirror
        uploads, the per-step fetch's size and dtype, preemptions, and
        the resolved overlap mode ("fused", "async", or "" for the
        serialized scheduler); beside them the admissions whose prefill
        ran on this rank's data line (all of them off a data axis), the
        preemptions of its rows, its prefill launches outside a mixed
        step by their token rows, and the first tokens resolved (each one
        a gather over the data axes)."""
        units = Counter(self._stats["line_prefill_units"])
        return dict(self._stats, line_prefill_units=units,
                    preemptions=self.num_preemptions,
                    overlap_mode=self.overlap_mode)

    def _put(self, x):
        """Upload host state to a device mirror (a copy: the host array
        keeps changing)."""
        self._stats["h2d_uploads"] += 1
        return torch.tensor(x, device=self.device)

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------

    def _worst_case_blocks(self, plen: int, max_new: int) -> int:
        """Blocks a request can ever occupy: the cache peaks at plen +
        max_new - 1 tokens (the final token is never inserted), capped at
        the ring for a sliding window. Invariant under preemption."""
        tokens = plen + max_new - 1
        if self.window:
            tokens = min(tokens, self.window)
        return blocks_needed(tokens, self.block_size)

    def _prompt_blocks(self, plen: int) -> int:
        """Blocks a prompt's prefill occupies (ring-capped: a longer than
        window prompt wraps in place)."""
        if self.window:
            plen = min(plen, self.window)
        return blocks_needed(plen, self.block_size)

    def _table_width(self, num_tokens: int) -> int:
        """Pow2-bucketed table columns covering `num_tokens` positions
        (saturating at the ring for a sliding window)."""
        return table_width(num_tokens, self.block_size, self.num_blocks,
                           window=self.window)

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None) -> int:
        """Queue a token-id prompt; returns the request uid. The arena
        bounds a request by its slot (plen + max_new_tokens <= capacity);
        the paged pool by the pool (its worst case <= num_blocks)."""
        prompt = np.asarray(prompt, np.int32)
        assert prompt.ndim == 1 and prompt.size > 0, prompt.shape
        assert max_new_tokens >= 1, max_new_tokens
        if self.paged:
            need = self._worst_case_blocks(len(prompt), max_new_tokens)
            if need > self.num_blocks:
                raise ValueError(
                    f"prompt ({len(prompt)}) + max_new_tokens "
                    f"({max_new_tokens}) needs {need} KV blocks; the pool "
                    f"has {self.num_blocks} (raise num_blocks)")
        elif len(prompt) + max_new_tokens > self.capacity:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" exceeds slot capacity {self.capacity}; use "
                "Engine(paged=True) for longer-than-slot generations")
        uid = self._next_uid
        self._next_uid += 1
        self._queue.append(Request(uid, prompt, int(max_new_tokens),
                                   None if eos_id is None else int(eos_id)))
        return uid

    @property
    def pending(self) -> int:
        """Queued requests not yet admitted to a slot."""
        return len(self._queue)

    @property
    def num_active(self) -> int:
        """Requests holding a slot (decoding, streaming or staged)."""
        return sum(r is not None for r in self._slot_req)

    @property
    def free_blocks(self) -> Optional[int]:
        """Unallocated, unreserved pool blocks; None for the arena."""
        return self._allocator.available if self.paged else None

    # ------------------------------------------------------------------
    # prefill launches (shared by both schedulers)
    # ------------------------------------------------------------------

    def _arena_prompt(self, req: Request) -> torch.Tensor:
        """`req`'s prompt on the device as the arena prefills it: padded
        to its power-of-two bucket where padding is inert, else at its
        exact length."""
        plen = len(req.prompt)
        if self.caps.pad_prompts:
            sp = min(bucket_length(plen, _PREFILL_FLOOR), self.capacity)
        else:
            sp = plen
        self.prefill_shapes.add(sp)
        toks = np.zeros((1, sp), np.int32)
        toks[0, :plen] = req.prompt
        return torch.from_numpy(toks).to(self.device)

    def _alloc_prompt(self, req: Request, slot: int) -> np.ndarray:
        """Allocate the blocks of `req`'s prompt (and, under "reserve",
        reserve the rest of its worst case); returns a table row holding
        them."""
        plen = len(req.prompt)
        n_prompt = self._prompt_blocks(plen)
        table = np.zeros(self.num_blocks, np.int32)
        table[:n_prompt] = self._allocator.alloc(n_prompt)
        if self.preemption == "reserve":
            need = self._worst_case_blocks(plen, req.max_new_tokens)
            self._allocator.reserve(need - n_prompt)
            self._slot_reserved[slot] = need - n_prompt
        return table

    def _prompt_table(self, table: np.ndarray, plen: int) -> torch.Tensor:
        """A prompt's table on the device at the prompt's bucketed width
        (chunk pads past it go to the null block): every chunk of the
        prompt, streamed, staged or serialized, sees this operand."""
        return torch.from_numpy(
            table[:self._table_width(plen)].copy()).to(self.device)

    def _chunk(self, prompt: np.ndarray, i: int):
        """Chunk i of `prompt`, right-padded to the chunk size, on the
        device, and its true length."""
        c = self.prefill_chunk
        chunk = prompt[i * c:(i + 1) * c]
        toks = np.zeros((1, c), np.int32)
        toks[0, :len(chunk)] = chunk
        return torch.from_numpy(toks).to(self.device), len(chunk)

    def _prefill_slot(self, tokens: torch.Tensor, plen: int, slot: int):
        """Launch the arena prefill of `tokens` into `slot` on the data line
        that holds it; returns its device token (None on other lines)."""
        if not self.rows.owns(slot):
            return None
        self._stats["line_prefill_units"][tokens.shape[1]] += 1
        tok, self._caches = self._prefill(self.params, tokens, plen,
                                          self.rows.local(slot),
                                          self._caches)
        return tok

    def _prefill_chunks(self, prompt: np.ndarray, table: torch.Tensor,
                        first: int, stop: int, slot: int):
        """Launch chunks [first, stop) of `prompt` into the blocks of
        `table` on the data line that holds `slot`; returns the last
        chunk's device token (None on other lines)."""
        if not self.rows.owns(slot):
            return None
        tok = None
        for i in range(first, stop):
            toks, n = self._chunk(prompt, i)
            self._stats["line_prefill_units"][toks.shape[1]] += 1
            tok, self._caches = self._prefill(
                self.params, toks, n, i * self.prefill_chunk, table,
                self._caches)
        return tok

    # ------------------------------------------------------------------
    # the serialized scheduler
    # ------------------------------------------------------------------

    def _admit(self, req: Request, slot: int):
        """Launch the prefill of `req` into arena `slot` (no host sync)
        and mark the slot live. Returns (req, slot, device token) for
        `_resolve_admission`: the first token is not fetched here, so the
        round's other prefills launch without waiting on this one."""
        tok_dev = self._prefill_slot(self._arena_prompt(req),
                                     len(req.prompt), slot)
        self._slot_req[slot] = req
        self._gen[slot] = []
        self._lengths[slot] = len(req.prompt)
        self._lengths_dirty = True
        return req, slot, tok_dev

    def _admit_paged(self, req: Request, slot: int):
        """Chunked prefill of `req` into pool blocks of `slot`'s table
        (launches only, as `_admit`). Allocates the prompt's blocks now
        and, under "reserve", reserves the rest of the worst case. A
        recompute re-admission runs the prefill of its first admission
        (same chunks, offsets and table width), queues its generated
        tokens for replay and returns None: its next token is known."""
        plen = len(req.prompt)
        self._tables[slot] = self._alloc_prompt(req, slot)
        self._tables_dirty = True
        self.prefill_shapes.add(self.prefill_chunk)
        tok_dev = self._prefill_chunks(
            req.prompt, self._prompt_table(self._tables[slot], plen), 0,
            chunks_needed(plen, self.prefill_chunk), slot)
        self._slot_req[slot] = req
        self._gen[slot] = []
        self._lengths[slot] = plen
        self._lengths_dirty = True
        if req.gen_prefix:
            self._resume(req, slot)
            return None
        return req, slot, tok_dev

    def _resume(self, req: Request, slot: int) -> None:
        """A recompute re-admission: the prompt's KV is rebuilt (its token
        would only re-derive gen_prefix[0]); the generated tokens replay
        through the decode step, each rewriting its KV entry."""
        self._cur[slot] = req.gen_prefix[0]
        self._cur_dirty = True
        self._replay[slot] = deque(req.gen_prefix[1:])

    def _count_admission(self, slot: int) -> None:
        self._stats["admissions"] += 1
        self._stats["line_admissions"] += self.rows.owns(slot)

    def _resolve_admission(self, req: Request, slot: int,
                           tok: int) -> Optional[Request]:
        """Record a resolved first token; returns the request if it
        finished already (budget 1 or EOS on the first token)."""
        self._gen[slot] = [tok]
        self._cur[slot] = tok
        self._cur_dirty = True
        if (req.max_new_tokens - len(req.gen_prefix) == 1
                or (req.eos_id is not None and tok == req.eos_id)):
            return self._finish(slot)
        return None

    def _finish(self, slot: int) -> Request:
        req = self._slot_req[slot]
        req.output = np.asarray(req.gen_prefix + self._gen[slot], np.int32)
        self._slot_req[slot] = None
        self._gen[slot] = []
        if self.paged:
            # free the slot's blocks and any unused reservation; the zeroed
            # table and length make the dead row touch the null block only
            self._allocator.free_partial(self._tables[slot])
            self._allocator.unreserve(self._slot_reserved[slot])
            self._slot_reserved[slot] = 0
            self._tables[slot] = 0
            self._lengths[slot] = 0
            self._tables_dirty = True
            self._lengths_dirty = True
        self._done.append(req)
        return req

    def _preempt(self, slot: int) -> None:
        """Evict the request in `slot`: fold its generated tokens into its
        recompute prefix, free its blocks and re-queue it in uid
        position. Running uids are lower than every never-admitted queued
        uid (admission is FIFO), so the queue stays uid-sorted and no
        request overtakes an older one. A streaming or staged slot holds
        its blocks in a private table: evicting it cancels the admission,
        and the launches already in flight write freed blocks, which
        every later prefill overwrites before any position is valid."""
        req = self._slot_req[slot]
        req.gen_prefix.extend(self._gen[slot])
        req.preemptions += 1
        self.num_preemptions += 1
        self._stats["line_preemptions"] += self.rows.owns(slot)
        self._slot_req[slot] = None
        self._gen[slot] = []
        self._replay[slot] = deque()  # rebuilt from gen_prefix on re-admission
        staged = [e for e in self._staged if e["slot"] == slot]
        if self._stream is not None and self._stream["slot"] == slot:
            self._allocator.free_partial(self._stream["table"])
            self._stream = None
        elif staged:
            self._staged.remove(staged[0])
            self._allocator.free_partial(staged[0]["table"])
        else:
            self._allocator.free_partial(self._tables[slot])
        self._tables[slot] = 0
        self._lengths[slot] = 0
        self._cur[slot] = 0
        self._tables_dirty = True
        self._lengths_dirty = True
        self._cur_dirty = True
        i = 0
        while i < len(self._queue) and self._queue[i].uid < req.uid:
            i += 1
        self._queue.insert(i, req)

    def _can_admit(self, req: Request) -> bool:
        if not self.paged:
            return True
        worst = self._worst_case_blocks(len(req.prompt), req.max_new_tokens)
        if self.preemption == "reserve":
            return self._allocator.available >= worst
        # optimistic: the prompt's blocks plus a watermark, free right now;
        # the watermark is waived where it would exceed the worst case,
        # else a pool-filling prompt with a tiny budget never gets in
        need_now = self._prompt_blocks(len(req.prompt))
        if need_now + _ADMIT_WATERMARK <= worst:
            return self._allocator.can_allocate(need_now,
                                                watermark=_ADMIT_WATERMARK)
        return self._allocator.can_allocate(worst)

    @hot_loop
    def _admit_round(self, finished: List[Request]) -> bool:
        """One admission round: launch a prefill into every free slot
        while the queue head is admissible (back to back, no host sync
        between launches), then resolve the launched first tokens in one
        batched fetch. Returns True when anything was admitted: an
        instant finish frees its slot (and blocks), so the caller loops
        for another round."""
        t0 = time.perf_counter()
        pending: List[Tuple[Request, int, torch.Tensor]] = []
        admitted = False
        for slot in range(self.max_batch):
            if not self._queue:
                break
            if self._slot_req[slot] is not None:
                continue
            if not self._can_admit(self._queue[0]):
                break       # FIFO: nothing may jump the head
            admit = self._admit_paged if self.paged else self._admit
            pend = admit(self._queue.popleft(), slot)
            admitted = True
            self._count_admission(slot)
            if pend is not None:
                pending.append(pend)
        self._stats["admit_host_s"] += time.perf_counter() - t0
        if pending:
            t1 = time.perf_counter()
            # repro-lint: disable=host-sync-in-hot-loop -- batched
            # first-token resolution: ONE wait per admission round after
            # every prefill is in flight
            toks = np.asarray(self.rows.first_tokens(
                [(slot, t) for _, slot, t in pending]).cpu())
            self._stats["first_tokens"] += len(pending)
            self._stats["prefill_wait_s"] += time.perf_counter() - t1
            for (req, slot, _), tok in zip(pending, toks.tolist()):
                f = self._resolve_admission(req, slot, tok)
                if f is not None:
                    finished.append(f)
        return admitted

    @hot_loop
    def step(self) -> List[Request]:
        """Admit queued requests into free slots, then run ONE decode step
        over the batch; returns the requests finished by this step. With
        `engine.overlap`, admissions ride the decode launch (mixed steps)
        or launch beside it, and their first tokens resolve a step later,
        after the decode fetch has synchronised past them: the same
        tokens, with no admission blocking a decode dispatch."""
        if self.overlap:
            return self._step_overlapped()
        return self._step_serialized()

    def _sync_mirrors(self, active: List[int]) -> None:
        """Re-upload the stale device mirrors of the decode operands, this
        data line's rows of each; the paged tables go up as the pow2
        slice covering the live maximum (+1: the step inserts each live
        row's incoming token first)."""
        if self.paged:
            w = self._table_width(max(int(self._lengths[s]) + 1
                                      for s in active))
            if self._tables_dirty or self._tables_dev_w != w:
                self._tables_dev = self._put(
                    self.rows.mine(self._tables[:, :w]))
                self._tables_dev_w = w
                self._tables_dirty = False
        if self._lengths_dirty or self._lengths_dev is None:
            self._lengths_dev = self._put(self.rows.mine(self._lengths))
            self._lengths_dirty = False
        if self._cur_dirty or self._cur_dev is None:
            self._cur_dev = self._put(self.rows.mine(self._cur))
            self._cur_dirty = False

    def _launch_decode(self) -> torch.Tensor:
        """Launch the decode step over this data line's rows; returns their
        next tokens (the advanced lengths stay in the device mirror)."""
        if self.paged:
            toks_dev, self._caches, self._lengths_dev = self._decode(
                self.params, self._cur_dev, self._caches, self._tables_dev,
                self._lengths_dev)
        else:
            toks_dev, self._caches, self._lengths_dev = self._decode(
                self.params, self._cur_dev, self._caches, self._lengths_dev)
        return toks_dev

    @hot_loop
    def _emit(self, toks_dev: torch.Tensor, active: List[int], t0: float,
              finished: List[Request]) -> None:
        """Fetch the decode step's `[B]` tokens (this line's, gathered over
        the data axes; its launch began at t0) and advance the rows of
        `active`, in that order: replay, emit, or finish on budget or
        EOS."""
        # the step's outputs are the next step's inputs: tokens and
        # advanced lengths stay on the device
        self._cur_dev = toks_dev
        t1 = time.perf_counter()
        self._stats["decode_dispatch_s"] += t1 - t0
        # repro-lint: disable=host-sync-in-hot-loop -- this [B] int32 token
        # fetch IS the per-step device->host contract (never logits)
        nxt = np.asarray(self.rows.gather(toks_dev).cpu())
        t2 = time.perf_counter()
        self._stats["decode_steps"] += 1
        self._stats["decode_fetch_s"] += t2 - t1
        self._stats["decode_s"] += t2 - t0
        self._stats["decode_fetch_elems"] = int(nxt.size)
        self._stats["decode_fetch_dtype"] = str(nxt.dtype)
        for s in active:
            self._lengths[s] += 1
            if self._replay[s]:
                # recompute replay: the step re-inserted one evicted
                # token's KV; its successor is already known, so feed it
                # and skip emission, EOS and budget (checked before)
                self._cur[s] = self._replay[s].popleft()
                self._cur_dirty = True
                self._stats["replayed_tokens"] += 1
                continue
            tok = int(nxt[s])
            self._gen[s].append(tok)
            self._cur[s] = tok
            req = self._slot_req[s]
            if (len(req.gen_prefix) + len(self._gen[s]) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)):
                finished.append(self._finish(s))

    @hot_loop
    def _step_serialized(self) -> List[Request]:
        """The blocking scheduler: resolve every admission's first token
        before dispatching the decode step (overlap=False, and families
        or backends without a mixed step)."""
        finished: List[Request] = []
        while self._admit_round(finished):
            pass    # instant finishes free slots: try again

        active = [s for s in range(self.max_batch)
                  if self._slot_req[s] is not None]
        if self.paged and active:
            self._topup_blocks(active)
            active = [s for s in active if self._slot_req[s] is not None]
        if not active:
            return finished

        t0 = time.perf_counter()
        self._sync_mirrors(active)
        self._emit(self._launch_decode(), active, t0, finished)
        return finished

    def _topup_blocks(self, active: List[int]) -> None:
        """Give each decoding row the block its write position needs
        (billed to topup_host_s). "reserve" draws on the admission
        earmark and cannot fail; "recompute" allocates oldest first and,
        when the pool is dry, preempts the newest admission (LIFO) until
        a block frees up: an eviction returns >= 1 block, and the oldest
        running request is never the victim while a younger one holds
        blocks, so every request completes. Streaming and staged slots,
        the newest admissions, are the first victims."""
        t0 = time.perf_counter()
        for s in sorted(active, key=lambda t: self._slot_req[t].uid):
            if self._slot_req[s] is None:
                continue        # preempted by an earlier top-up
            pos = int(self._lengths[s])
            if self.window:
                # the write lands at ring slot pos % window: once the
                # ring's blocks exist, no further block is allocated
                pos %= self.window
            bi = pos // self.block_size
            if self._tables[s, bi] != 0:
                continue
            if self.preemption == "reserve":
                (blk,) = self._allocator.alloc(1, reserved=True)
                self._slot_reserved[s] -= 1
            else:
                while not self._allocator.can_allocate(1):
                    victim = max(
                        (t for t in range(self.max_batch)
                         if self._slot_req[t] is not None),
                        key=lambda t: self._slot_req[t].uid)
                    self._preempt(victim)
                    if victim == s:
                        break
                if self._slot_req[s] is None:
                    continue    # s itself was the newest admission
                (blk,) = self._allocator.alloc(1)
            self._tables[s, bi] = blk
            self._tables_dirty = True
        self._stats["topup_host_s"] += time.perf_counter() - t0

    # ------------------------------------------------------------------
    # overlapped admission (the stream, the staged admissions and the
    # fused mixed step)
    # ------------------------------------------------------------------

    def _start_stream(self, req: Request, slot: int) -> None:
        """Begin streaming `req`'s prefill through the decode launches.
        The slot is claimed (it counts as active and can be preempted)
        but stays dead to decode until `_resolve_staged` installs it; on
        the pool the prompt's blocks live in a private table until then.
        The arena streams the padded prompt (overlap needs pad_prompts
        there)."""
        plen = len(req.prompt)
        self._slot_req[slot] = req
        self._gen[slot] = []
        self._stream = {"req": req, "slot": slot, "plen": plen, "i": 0,
                        "total": 1, "tok": None}
        if self.paged:
            table = self._alloc_prompt(req, slot)
            self.prefill_shapes.add(self.prefill_chunk)
            self._stream.update(
                table=table, ctable=self._prompt_table(table, plen),
                total=chunks_needed(plen, self.prefill_chunk))
        else:
            self._stream["tokens"] = self._arena_prompt(req)

    def _stage_admit(self, req: Request, slot: int) -> None:
        """Admit `req` on the pool with every chunk launch in flight now
        and nothing resolved; the slot stays dead to decode until
        `_resolve_staged`, which installs it with the stream it queued
        behind (FIFO start order). The launches, shapes and operands of
        `_admit_paged`, with deferred resolution."""
        plen = len(req.prompt)
        self._slot_req[slot] = req
        self._gen[slot] = []
        table = self._alloc_prompt(req, slot)
        self.prefill_shapes.add(self.prefill_chunk)
        tok = self._prefill_chunks(req.prompt, self._prompt_table(table, plen),
                                   0, chunks_needed(plen, self.prefill_chunk),
                                   slot)
        self._staged.append({"req": req, "slot": slot, "plen": plen,
                             "tok": tok, "table": table})

    def _admission_phase(self) -> None:
        """Pop the queue head into the stream (its prefill rides the
        decode launches) and, on the pool, stage every further admissible
        request into a free slot. Requests pop strictly head first (a
        blocked head blocks everything behind it), and staged slots come
        alive together with the stream they queued behind: FIFO twice
        over. The arena admits through the stream only (its decode would
        clobber a staged row at the slot's cache-carried ptr). In "async"
        mode the pool has no stream: every admission stages, its chunks
        in flight this step."""
        t0 = time.perf_counter()
        free = deque(s for s in range(self.max_batch)
                     if self._slot_req[s] is None)
        stream_ok = not (self.paged and self._mixed is None)
        if (stream_ok and self._stream is None and self._queue and free
                and self._can_admit(self._queue[0])):
            slot = free.popleft()
            self._start_stream(self._queue.popleft(), slot)
            self._count_admission(slot)
        while (self.paged and self._queue and free
               and self._can_admit(self._queue[0])):
            slot = free.popleft()
            self._stage_admit(self._queue.popleft(), slot)
            self._count_admission(slot)
        self._stats["admit_host_s"] += time.perf_counter() - t0

    def _drain_stream(self) -> None:
        """Launch an in-flight stream's remaining prefill through the
        plain prefill step and stage it: there is no decode row to ride
        (the serialized admission, which is what the situation is)."""
        st, self._stream = self._stream, None
        t0 = time.perf_counter()
        entry = {"req": st["req"], "slot": st["slot"], "plen": st["plen"]}
        if self.paged:
            entry["table"] = st["table"]
            entry["tok"] = self._prefill_chunks(
                st["req"].prompt, st["ctable"], st["i"], st["total"],
                st["slot"])
        else:
            entry["tok"] = self._prefill_slot(st["tokens"], st["plen"],
                                              st["slot"])
        self._stats["admit_host_s"] += time.perf_counter() - t0
        self._staged.append(entry)

    @hot_loop
    def _resolve_staged(self, finished: List[Request],
                        deferred: bool = True) -> None:
        """Install every staged admission, oldest first: block table and
        length (the slot becomes visible to decode), then its first token,
        or the replay queue of a recompute re-admission. Held back while
        a stream is in flight: the stream is the oldest unresolved
        admission, and resolving younger ones first would let them decode
        ahead of it. Deferred (at a step's start), the fetch costs
        nothing: the previous step's `[B]` fetch synchronised past the
        launches that produced these tokens."""
        if self._stream is not None or not self._staged:
            return
        t1 = time.perf_counter()
        entries = sorted(self._staged, key=lambda e: e["req"].uid)
        self._staged = []
        fresh = [e for e in entries if not e["req"].gen_prefix]
        toks = {}
        if fresh:
            # repro-lint: disable=host-sync-in-hot-loop -- deferred
            # first-token resolution: the prior step's [B] decode fetch
            # already synced past the launches that produced these tokens
            got = np.asarray(self.rows.first_tokens(
                [(e["slot"], e["tok"]) for e in fresh]).cpu())
            self._stats["first_tokens"] += len(fresh)
            toks = {e["slot"]: tok for e, tok in zip(fresh, got.tolist())}
        for e in entries:
            req, slot = e["req"], e["slot"]
            if self.paged:
                self._tables[slot] = e["table"]
                self._tables_dirty = True
            self._lengths[slot] = e["plen"]
            self._lengths_dirty = True
            if deferred:
                self._stats["overlapped_admissions"] += 1
            if req.gen_prefix:
                self._resume(req, slot)
                continue
            f = self._resolve_admission(req, slot, toks[slot])
            if f is not None:
                finished.append(f)
        self._stats["prefill_wait_s"] += time.perf_counter() - t1

    @hot_loop
    def _step_overlapped(self) -> List[Request]:
        """One pass of the overlapped scheduler: install the staged
        admissions, launch this step's admissions, then dispatch ONE
        decode launch, mixed with the stream's prefill unit when a
        stream is in flight, with no first-token wait between admission
        and dispatch. Each half sees the operands of its serialized step
        (the decode tables at the live rows' width, the chunk's table at
        its prompt's)."""
        finished: List[Request] = []
        self._resolve_staged(finished)
        self._admission_phase()

        st = self._stream
        dead = {e["slot"] for e in self._staged}
        if st is not None:
            dead.add(st["slot"])
        active = [s for s in range(self.max_batch)
                  if self._slot_req[s] is not None and s not in dead]
        if not active:
            # no decode launch to ride: flush and resolve now (a cold
            # start, or everything just finished)
            if st is not None:
                self._drain_stream()
            self._resolve_staged(finished, deferred=False)
            active = [s for s in range(self.max_batch)
                      if self._slot_req[s] is not None]
        if self.paged and active:
            self._topup_blocks(active)
            active = [s for s in active if self._slot_req[s] is not None]
        if not active:
            return finished

        t0 = time.perf_counter()
        self._sync_mirrors(active)
        st = self._stream
        if st is None:
            toks_dev = self._launch_decode()
        elif self.paged:
            # the pool streams only in "fused" mode
            ctoks, n = self._chunk(st["req"].prompt, st["i"])
            toks_dev, self._caches, self._lengths_dev, st["tok"] = \
                self._mixed(self.params, self._cur_dev, self._caches,
                            self._tables_dev, self._lengths_dev, ctoks, n,
                            st["i"] * self.prefill_chunk, st["ctable"])
            self._stats["mixed_steps"] += 1
            st["i"] += 1
        else:
            if self._mixed is not None:
                toks_dev, self._caches, self._lengths_dev, st["tok"] = \
                    self._mixed(self.params, self._cur_dev, self._caches,
                                self._lengths_dev, st["tokens"], st["plen"],
                                st["slot"])
                self._stats["mixed_steps"] += 1
            else:
                # async: decode FIRST (the dead slot's insert lands before
                # the prefill overwrites its row and ptr, the mixed step's
                # order), then the serialized prefill, no fetch between
                toks_dev = self._launch_decode()
                st["tok"] = self._prefill_slot(st["tokens"], st["plen"],
                                               st["slot"])
            st["i"] = 1
        if st is not None and st["i"] == st["total"]:
            self._stream = None
            self._staged.append({k: st[k] for k in
                                 ("req", "slot", "plen", "tok", "table")
                                 if k in st})
        # uid order, not slot order: overlapped slot assignment does not
        # follow uid order, and same-step finishes complete oldest first
        self._emit(toks_dev, sorted(active,
                                    key=lambda t: self._slot_req[t].uid),
                   t0, finished)
        return finished

    def run(self) -> List[Request]:
        """Drain queue + batch; returns every request completed so far
        (accumulating across earlier step() calls). Streaming and staged
        admissions hold their slots, so the loop cannot end with an
        admission half landed."""
        while self._queue or self.num_active:
            self.step()
        return list(self._done)
