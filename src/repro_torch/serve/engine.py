"""Slot-based continuous-batching greedy serving engine, arena backend.

A port of `repro/serve/engine.py` in arena mode with its serialized
scheduler (the reference's `overlap=False`):

  * a fixed batch of `max_batch` decode rows over one slot arena of KV
    caches (`Model.init_arena`): each row owns a full capacity-T cache row
    (T = the power-of-two bucket of `max_len`), so a request is bounded
    by `plen + max_new_tokens <= capacity`; dead rows decode garbage that
    the host ignores, and are recycled;
  * an admission scheduler that prefills queued requests into free rows
    between decode steps (FIFO; prompts right-padded to a power-of-two
    bucket of at least 8): a round launches every admissible prefill,
    then resolves their first tokens in one batched fetch;
  * token-returning steps: the greedy argmax runs on the device and the
    host fetches int32 ids, [B] per decode step, never logits; the decode
    step's next tokens and advanced positions stay on the device and feed
    the next step, so steady-state decoding uploads nothing (the host
    mirrors re-upload only when admission or a finish changes them).

Greedy decode is row-independent, so a request's output does not depend
on what else is in the batch. The engine casts the parameters to the
compute dtype once at construction (the reference casts inside every
jitted call; in eager PyTorch that would be a full-model cast per step).
The paged backend and overlapped admission (the fused mixed step) come
with slice 3 of the port and raise here.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.bucketing import bucket_length
from repro_torch.utils.hotpath import hot_loop

_PREFILL_FLOOR = 8      # smallest prompt bucket


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    output: Optional[np.ndarray] = None


class Engine:
    """Continuous-batching greedy-decode engine over one model + params.

    API: submit(prompt, max_new_tokens, eos_id) -> uid; step() ->
    requests finished by this step; run() -> drain the queue. The engine
    runs where the parameters lie (CUDA or CPU).
    """

    def __init__(self, model, params, *, max_batch: int = 8,
                 max_len: int = 256, cache_dtype=torch.bfloat16,
                 paged: bool = False, overlap: bool = False):
        if paged:
            raise NotImplementedError(
                "paged KV serving is not ported yet: the paged and "
                "ring-paged backends come with slice 3 of the port")
        if overlap:
            raise NotImplementedError(
                "overlapped admission (the fused mixed prefill+decode step) "
                "is not ported yet: it comes with slice 3 of the port; "
                "use overlap=False (the serialized scheduler)")
        if model.prefill_into_slot_token is None:
            raise NotImplementedError(
                f"family {model.cfg.family!r} has no slot-arena entry points")
        self.model = model
        compute = getattr(torch, model.cfg.compute_dtype)
        self.params = {k: v.to(compute) if v.is_floating_point() else v
                       for k, v in params.items()}
        self.device = next(iter(self.params.values())).device
        self.max_batch = int(max_batch)
        self.capacity = bucket_length(max_len)
        self.prefill_shapes: set = set()    # admitted Sp values
        self._prefill = model.prefill_into_slot_token
        self._decode = model.decode_rows_tokens
        self._caches = model.init_arena(self.max_batch, self.capacity,
                                        dtype=cache_dtype, device=self.device)

        self._queue: Deque[Request] = deque()
        self._done: List[Request] = []
        self._next_uid = 0
        self._slot_req: List[Optional[Request]] = [None] * self.max_batch
        self._gen: List[List[int]] = [[] for _ in range(self.max_batch)]
        self._lengths = np.zeros(self.max_batch, np.int32)  # tokens in cache
        self._cur = np.zeros(self.max_batch, np.int32)      # current token
        # device mirrors of the decode step's small operands: the step
        # returns next tokens and advanced positions, which feed straight
        # back in; they re-upload only when admission or a finish makes
        # the host values differ
        self._cur_dev = None
        self._lengths_dev = None
        self._cur_dirty = True
        self._lengths_dirty = True
        self._stats = {
            "admissions": 0,         # requests prefilled into a slot
            "admit_host_s": 0.0,     # host time launching admissions
            "prefill_wait_s": 0.0,   # blocked resolving prefill tokens
            "decode_steps": 0,
            "decode_s": 0.0,         # decode launch + [B]-token fetch
            "decode_dispatch_s": 0.0,   # ... its mirror-sync + launch half
            "decode_fetch_s": 0.0,      # ... its blocked-on-tokens half
            "h2d_uploads": 0,        # mirror re-syncs (stale -> upload)
            "decode_fetch_elems": 0,    # size of the per-step fetch ...
            "decode_fetch_dtype": "",   # ... proof it is [B] int32 ids
        }

    @property
    def stats(self) -> dict:
        """Per-step telemetry, with the reference's keys where they apply:
        admission host time vs prefill wait vs decode step time, mirror
        uploads, and the per-step fetch's size and dtype. The arena never
        preempts and the scheduler is serialized ("" overlap mode)."""
        return dict(self._stats, preemptions=0, overlap_mode="")

    def _put(self, x):
        """Upload host state to a device mirror (a copy: the host array
        keeps changing)."""
        self._stats["h2d_uploads"] += 1
        return torch.tensor(x, device=self.device)

    # ------------------------------------------------------------------
    # request intake
    # ------------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None) -> int:
        """Queue a token-id prompt; returns the request uid. A request is
        bounded by its slot: plen + max_new_tokens <= capacity."""
        prompt = np.asarray(prompt, np.int32)
        assert prompt.ndim == 1 and prompt.size > 0, prompt.shape
        assert max_new_tokens >= 1, max_new_tokens
        if len(prompt) + max_new_tokens > self.capacity:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" exceeds slot capacity {self.capacity}")
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
        """Requests currently decoding in the batch."""
        return sum(r is not None for r in self._slot_req)

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------

    def _admit(self, req: Request, slot: int):
        """Launch the prefill of `req` into `slot` (no host sync) and mark
        the slot live. Returns (req, slot, device token) for
        `_resolve_admission`: the first token is not fetched here, so the
        round's other prefills launch without waiting on this one."""
        plen = len(req.prompt)
        sp = min(bucket_length(plen, _PREFILL_FLOOR), self.capacity)
        self.prefill_shapes.add(sp)
        toks = np.zeros((1, sp), np.int32)
        toks[0, :plen] = req.prompt
        tok_dev, self._caches = self._prefill(
            self.params, torch.from_numpy(toks).to(self.device), plen, slot,
            self._caches)
        self._slot_req[slot] = req
        self._gen[slot] = []
        self._lengths[slot] = plen
        self._lengths_dirty = True
        return req, slot, tok_dev

    def _resolve_admission(self, req: Request, slot: int,
                           tok: int) -> Optional[Request]:
        """Record a resolved first token; returns the request if it
        finished already (budget 1 or EOS on the first token)."""
        self._gen[slot] = [tok]
        self._cur[slot] = tok
        self._cur_dirty = True
        if (req.max_new_tokens == 1
                or (req.eos_id is not None and tok == req.eos_id)):
            return self._finish(slot)
        return None

    def _finish(self, slot: int) -> Request:
        req = self._slot_req[slot]
        req.output = np.asarray(self._gen[slot], np.int32)
        self._slot_req[slot] = None
        self._gen[slot] = []
        self._done.append(req)
        return req

    @hot_loop
    def _admit_round(self, finished: List[Request]) -> bool:
        """One admission round: launch a prefill into every free slot
        (back to back, no host sync between launches), then resolve the
        launched first tokens in one batched fetch. Returns True when
        anything was admitted: an instant finish (budget 1 / EOS on the
        prefill token) frees its slot, so the caller loops for another
        round."""
        t0 = time.perf_counter()
        pending: List[Tuple[Request, int, torch.Tensor]] = []
        for slot in range(self.max_batch):
            if not self._queue:
                break
            if self._slot_req[slot] is not None:
                continue
            pending.append(self._admit(self._queue.popleft(), slot))
            self._stats["admissions"] += 1
        self._stats["admit_host_s"] += time.perf_counter() - t0
        if not pending:
            return False
        t1 = time.perf_counter()
        # repro-lint: disable=host-sync-in-hot-loop -- batched first-token
        # resolution: ONE wait per admission round after every prefill is
        # in flight
        toks = np.asarray(torch.stack([t for _, _, t in pending]).cpu())
        self._stats["prefill_wait_s"] += time.perf_counter() - t1
        for (req, slot, _), tok in zip(pending, toks.tolist()):
            f = self._resolve_admission(req, slot, tok)
            if f is not None:
                finished.append(f)
        return True

    @hot_loop
    def step(self) -> List[Request]:
        """Admit queued requests into free slots, then run ONE decode step
        over the batch; returns the requests finished by this step."""
        return self._step_serialized()

    @hot_loop
    def _step_serialized(self) -> List[Request]:
        """The blocking scheduler: resolve every admission's first token
        before dispatching the decode step."""
        finished: List[Request] = []
        while self._admit_round(finished):
            pass    # instant finishes free slots: try again

        active = [s for s in range(self.max_batch)
                  if self._slot_req[s] is not None]
        if not active:
            return finished

        t0 = time.perf_counter()
        if self._lengths_dirty or self._lengths_dev is None:
            self._lengths_dev = self._put(self._lengths)
            self._lengths_dirty = False
        if self._cur_dirty or self._cur_dev is None:
            self._cur_dev = self._put(self._cur)
            self._cur_dirty = False
        toks_dev, self._caches, self._lengths_dev = self._decode(
            self.params, self._cur_dev, self._caches, self._lengths_dev)
        # the step's outputs are the next step's inputs: tokens and
        # advanced positions stay on the device
        self._cur_dev = toks_dev
        t1 = time.perf_counter()
        self._stats["decode_dispatch_s"] += t1 - t0
        # repro-lint: disable=host-sync-in-hot-loop -- this [B] int32 token
        # fetch IS the per-step device->host contract (never logits)
        nxt = np.asarray(toks_dev.cpu())
        t2 = time.perf_counter()
        self._stats["decode_steps"] += 1
        self._stats["decode_fetch_s"] += t2 - t1
        self._stats["decode_s"] += t2 - t0
        self._stats["decode_fetch_elems"] = int(nxt.size)
        self._stats["decode_fetch_dtype"] = str(nxt.dtype)
        for s in active:
            self._lengths[s] += 1
            tok = int(nxt[s])
            self._gen[s].append(tok)
            self._cur[s] = tok
            req = self._slot_req[s]
            if (len(self._gen[s]) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)):
                finished.append(self._finish(s))
        return finished

    def run(self) -> List[Request]:
        """Drain queue + batch; returns every request completed so far
        (accumulating across earlier step() calls)."""
        while self._queue or self.num_active:
            self.step()
        return list(self._done)
