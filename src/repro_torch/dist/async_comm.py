"""Block-update exchange for the async trainer: versioned KV transports
(the port of `repro/dist/async_comm.py`).

The async runtime needs exactly three primitives — publish a block
update under a unique key, block until a peer's update is available,
and rendezvous at a start barrier.  Three interchangeable transports
provide them:

  * ``TCPStoreKV`` — a `torch.distributed.TCPStore` (it takes the place
    of the reference's jax.distributed coordination-service KV): process
    0 hosts the store, every other process connects to it.  `wait` is a
    server-side blocking wait, so the staleness gate costs no client
    polling.  This is the transport real multi-process runs use.
  * ``FileKV`` — a shared directory with atomic renames; gets poll.
    Dependency-free fallback for environments where no port can be
    opened, and for driving subprocess tests without a store.
  * ``DictKV`` — in-memory, condition-variable based; lets tests run
    multiple async workers as threads inside one process.

Values are pickled numpy payloads (tiny: one token-block delta is
``[M, p]`` float64 — the paper's convex experiments put p in the tens),
so a payload's bytes equal the reference's.  Every key is written at
most once (``delta/<proc>/<round>``), which is what makes the
deterministic global application order well defined.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import threading
import time
import zlib
from datetime import timedelta
from typing import Any

import numpy as np


class KVTimeout(TimeoutError):
    """A blocking get ran past its deadline (straggler died or hung)."""


def encode(obj: Any) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def decode(blob: bytes) -> Any:
    return pickle.loads(blob)


class DictKV:
    """In-process KV for thread-based tests (one instance, many workers)."""

    def __init__(self):
        self._data = {}
        self._cond = threading.Condition()

    def set(self, key: str, value: bytes) -> None:
        with self._cond:
            # write-once keys: a replayed set must carry the identical
            # bytes (chaos tests replay publishes; the file transport
            # tolerates this the same way — last atomic rename wins,
            # with equal content)
            assert self._data.get(key, value) == bytes(value), \
                f"conflicting duplicate key {key}"
            self._data[key] = bytes(value)
            self._cond.notify_all()

    def get(self, key: str, timeout_s: float) -> bytes:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while key not in self._data:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(timeout=remaining):
                    if key in self._data:
                        break
                    raise KVTimeout(key)
            return self._data[key]

    def barrier(self, name: str, num_procs: int, proc: int,
                timeout_s: float) -> None:
        self.set(f"barrier/{name}/{proc}", b"1")
        for q in range(num_procs):
            self.get(f"barrier/{name}/{q}", timeout_s)


class FileKV:
    """Directory-backed KV: one file per key, atomic rename, polling get."""

    def __init__(self, root: str, poll_s: float = 0.0005):
        self.root = root
        self.poll_s = poll_s
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "__"))

    def set(self, key: str, value: bytes) -> None:
        path = self._path(key)
        fd, tmp = tempfile.mkstemp(dir=self.root)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(value)
            os.rename(tmp, path)   # atomic publish: readers never see partials
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, key: str, timeout_s: float) -> bytes:
        path = self._path(key)
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                with open(path, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                if time.monotonic() > deadline:
                    raise KVTimeout(key) from None
                time.sleep(self.poll_s)

    def barrier(self, name: str, num_procs: int, proc: int,
                timeout_s: float) -> None:
        self.set(f"barrier/{name}/{proc}", b"1")
        for q in range(num_procs):
            self.get(f"barrier/{name}/{q}", timeout_s)


class TCPStoreKV:
    """A `torch.distributed.TCPStore` KV: process 0 hosts the store
    (``is_master=True``) and every other process connects to it.

    One instance per process (a store client serializes its requests,
    so threads must not share one while a peer blocks in `get`).  The
    master's store dies with it, so `close` holds the master until every
    peer has said it left: call it last, after the final barrier.
    """

    def __init__(self, host: str, port: int, num_procs: int, proc: int,
                 timeout_s: float = 600.0):
        from torch.distributed import TCPStore

        self.num_procs = num_procs
        self.proc = proc
        self.timeout_s = timeout_s
        self._store = TCPStore(
            host, port, world_size=num_procs, is_master=proc == 0,
            timeout=timedelta(seconds=timeout_s), wait_for_workers=False)

    def set(self, key: str, value: bytes) -> None:
        self._store.set(key, bytes(value))

    def get(self, key: str, timeout_s: float) -> bytes:
        from torch.distributed import DistStoreError

        try:
            self._store.wait([key], timedelta(seconds=timeout_s))
        except DistStoreError as e:
            raise KVTimeout(f"{key}: {e}") from e
        return self._store.get(key)

    def barrier(self, name: str, num_procs: int, proc: int,
                timeout_s: float) -> None:
        self.set(f"barrier/{name}/{proc}", b"1")
        for q in range(num_procs):
            self.get(f"barrier/{name}/{q}", timeout_s)

    def close(self) -> None:
        """Leave: a peer says so under ``left/<proc>``; the master waits
        for every peer's word before it (and its store) may go."""
        if self.proc != 0:
            self.set(f"left/{self.proc}", b"1")
            return
        for q in range(1, self.num_procs):
            self.get(f"left/{q}", self.timeout_s)


class ChaosKV:
    """Fault-injection wrapper for any KV transport (tests only).

    Models the network misbehaviour a write-once KV protocol must
    absorb without moving the digest:

      * **latency** — each publish is delivered to the inner KV after a
        per-key delay drawn from a *key-seeded* RNG, so delivery order
        across keys is scrambled deterministically per seed;
      * **reordering** — falls out of per-key latency: a later ``set``
        can land before an earlier one;
      * **duplicate replays** — with probability ``dup_prob`` the same
        bytes are published a second time after a further delay
        (tolerated because keys are write-once: `DictKV.set` asserts
        byte-equality, `FileKV` re-renames identical content).

    Delivery is guaranteed (every timer fires), so blocking gets always
    terminate provided ``timeout_s`` exceeds ``max_latency_s``.  The
    RNG is seeded from ``(seed, crc32(key))`` — deterministic per
    (seed, key), independent of wall clock and of call interleaving.
    """

    def __init__(self, inner, seed: int = 0, max_latency_s: float = 0.01,
                 dup_prob: float = 0.25):
        self.inner = inner
        self.seed = seed
        self.max_latency_s = max_latency_s
        self.dup_prob = dup_prob
        self._timers = []
        self._lock = threading.Lock()

    def _rng(self, key: str):
        return np.random.default_rng(
            (self.seed, zlib.crc32(key.encode("utf-8"))))

    def set(self, key: str, value: bytes) -> None:
        rng = self._rng(key)
        delay = float(rng.uniform(0.0, self.max_latency_s))
        timers = [threading.Timer(delay, self.inner.set, (key, value))]
        if float(rng.random()) < self.dup_prob:
            extra = float(rng.uniform(0.0, self.max_latency_s))
            timers.append(threading.Timer(
                delay + extra, self.inner.set, (key, value)))
        with self._lock:
            self._timers += timers
        for t in timers:
            t.daemon = True
            t.start()

    def get(self, key: str, timeout_s: float) -> bytes:
        return self.inner.get(key, timeout_s)

    def barrier(self, name: str, num_procs: int, proc: int,
                timeout_s: float) -> None:
        # built from our own set/get so rendezvous traffic rides the
        # same delayed/duplicated delivery path as delta publishes
        self.set(f"barrier/{name}/{proc}", b"1")
        for q in range(num_procs):
            self.get(f"barrier/{name}/{q}", timeout_s)

    def drain(self) -> None:
        """Join all in-flight deliveries (call before final asserts)."""
        with self._lock:
            timers, self._timers = self._timers, []
        for t in timers:
            t.join()
