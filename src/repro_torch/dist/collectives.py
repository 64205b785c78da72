"""Collectives over a mesh's axes, as point-to-point sends (the port's
stand-in for the reference's `jax.lax.ppermute` and for the collectives
that GSPMD inserts from the sharding specs).

  ring_shift     -- one hop on an axis's ring: slot i receives slot i-1's
                    value (the token move of the API-BCD superstep);
  all_gather     -- every rank of a line gets every rank's piece;
  reduce_scatter -- rank j of a line gets the sum of every rank's j-th
                    piece, summed in the line's order, so every rank sums
                    in the same order and the result does not depend on
                    which rank computes it;
  all_reduce     -- a reduce_scatter of the flat tensor's pieces, then an
                    all_gather; on a line of 2, one exchange of the whole
                    tensor, summed in the line's order (the same bytes and
                    sum at one host round trip; metrics, the DP baseline's
                    gradients, the tensor-parallel serving step's sums);
  gather         -- every rank's piece to one rank (a checkpoint's leaves).

Each is a batch of `torch.distributed` isend / irecv pairs, so the bytes a
rank sends are known exactly: `sent[kind]` counts them per call kind
(`ring_shift`, `all_gather`, `reduce_scatter`, `all_reduce`, `gather`),
`calls[kind]` the calls and `ms[kind]` the milliseconds they took;
`axis_ms[axis]` splits the same milliseconds by the axis (or tuple of
axes, or None for every rank) whose line a call ran on.

Transports. On NCCL a CUDA tensor is sent as it is, on NCCL's stream,
which the current stream waits for: nothing waits on the host, and `ms`
is read from CUDA events recorded around each batch (the events resolve
when `ms` is read). On gloo, which moves host tensors only, a CUDA tensor
goes through one pinned host buffer for what a call sends and one for
what it receives, allocated once at the size `reserve` asks for (grown
only if a call needs more); the copies to and from those buffers block
the host, as gloo reads and writes them there, and `ms` is the host's
time from the end of the compute queued before the call (the copy to the
host waits for it anyway) to the copy back. On CPU tensors `ms` is the
host's time.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch


def _nbytes(t):
    return t.numel() * t.element_size()


class Collectives:
    """The collectives of one rank of `mesh` (a `launch.mesh.Mesh` over
    processes) on tensors of `device`."""

    def __init__(self, mesh, device, reserve_bytes=0):
        self.mesh = mesh
        self.device = torch.device(device)
        self.staged = (mesh.backend == "gloo"
                       and self.device.type == "cuda")
        self.sent = defaultdict(int)
        self.calls = defaultdict(int)
        self._ms = defaultdict(float)
        self._axis_ms = defaultdict(float)
        self._events = []           # (kind, axis, start, end) not yet read
        self._host = {}
        if reserve_bytes:
            self.reserve(reserve_bytes)

    def reserve(self, nbytes):
        """Pin the host buffers (one to send from, one to receive into) at
        `nbytes` each; a no-op off the gloo-with-CUDA route."""
        if self.staged:
            for role in ("send", "recv"):
                self._buffer(role, nbytes)

    def _read_events(self):
        for kind, axis, start, end in self._events:
            end.synchronize()
            self._count_ms(kind, axis, start.elapsed_time(end))
        self._events.clear()

    def _count_ms(self, kind, axis, ms):
        self._ms[kind] += ms
        self._axis_ms[axis] += ms

    @property
    def ms(self):
        """{kind: milliseconds} of the calls since `reset` (waits for the
        CUDA events of calls over NCCL still in flight)."""
        self._read_events()
        return self._ms

    @property
    def axis_ms(self):
        """{axis: milliseconds} of the calls since `reset`, as `ms`."""
        self._read_events()
        return self._axis_ms

    def reset(self):
        """Zero the counters (the buffers stay)."""
        self.sent.clear()
        self.calls.clear()
        self._ms.clear()
        self._axis_ms.clear()
        self._events.clear()

    def _buffer(self, role, nbytes):
        buf = self._host.get(role)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._host[role] = buf
        return buf

    def _stage(self, role, tensors):
        """Host views (consecutive regions of the role's buffer) with the
        shapes and dtypes of `tensors`."""
        total = 0
        for t in tensors:
            total += -total % 16 + _nbytes(t)
        buf = self._buffer(role, total)
        views, at = [], 0
        for t in tensors:
            at += -at % 16
            views.append(buf[at:at + _nbytes(t)].view(t.dtype).view(t.shape))
            at += _nbytes(t)
        return views

    def _line(self, axis):
        """(ranks, this rank's index among them, their group, axis) of
        `axis`'s line (an axis or a tuple of axes), or of every rank (the
        default group) for axis None."""
        if axis is None:
            return list(range(self.mesh.size)), self.mesh.rank, None, None
        ranks = self.mesh.line(axis)
        return ranks, ranks.index(self.mesh.rank), self.mesh.group(axis), axis

    def _exchange(self, kind, sends, recvs, group=None, axis=None):
        """Post every (peer, tensor) send and every (peer, out) receive
        (peers by global rank) in `group` (`axis`'s line) as one batch
        and wait for all of them; an empty tensor is not sent (both sides
        know its size)."""
        import torch.distributed as dist

        sends = [(p, t.contiguous()) for p, t in sends if t.numel()]
        recvs = [(p, t) for p, t in recvs if t.numel()]
        events = self.device.type == "cuda" and not self.staged
        if events:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        elif self.staged:
            torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        if self.staged:
            unique = list({id(t): t for _, t in sends}.values())
            hosts = dict(zip(map(id, unique), self._stage("send", unique)))
            for t in unique:
                hosts[id(t)].copy_(t)
            wire_sends = [(p, hosts[id(t)]) for p, t in sends]
            wire_recvs = list(zip((p for p, _ in recvs),
                                  self._stage("recv", [t for _, t in
                                                       recvs])))
        else:
            wire_sends, wire_recvs = sends, recvs
        ops = ([dist.P2POp(dist.isend, t, p, group) for p, t in wire_sends]
               + [dist.P2POp(dist.irecv, t, p, group)
                  for p, t in wire_recvs])
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if self.staged:
            for (_, out), (_, host) in zip(recvs, wire_recvs):
                out.copy_(host)
        if events:
            end.record()
            self._events.append((kind, axis, start, end))
        else:
            self._count_ms(kind, axis, (time.perf_counter() - t0) * 1e3)
        self.sent[kind] += sum(_nbytes(t) for _, t in sends)

    def ring_shift(self, t, axis="agent"):
        """A new tensor holding the value of the previous slot on `axis`'s
        ring (slot i receives slot i-1's); every slot sends. An axis of
        size 1 returns `t` itself."""
        ranks, i, group, axis = self._line(axis)
        n = len(ranks)
        self.calls["ring_shift"] += 1
        if n == 1:
            return t
        out = torch.empty_like(t)
        self._exchange("ring_shift", [(ranks[(i + 1) % n], t)],
                       [(ranks[(i - 1) % n], out)], group, axis)
        return out

    def all_gather(self, t, axis="replica"):
        """[piece of rank j for j along `axis`'s line]; this rank's own
        piece is `t` itself. Every piece has t's shape and dtype."""
        self.calls["all_gather"] += 1
        return self._all_gather(t, *self._line(axis), "all_gather")

    def _all_gather(self, t, ranks, i, group, axis, kind):
        pieces = [t if j == i else torch.empty_like(t)
                  for j in range(len(ranks))]
        self._exchange(kind, [(r, t) for j, r in enumerate(ranks) if j != i],
                       [(r, pieces[j]) for j, r in enumerate(ranks)
                        if j != i], group, axis)
        return pieces

    def reduce_scatter(self, pieces, axis="replica"):
        """The sum over the line's ranks of each rank's `pieces[i]` (i this
        rank's index), in the line's order. `pieces[j]` goes to rank j;
        pieces may differ in size, but every rank's pieces[j] has the same
        shape."""
        self.calls["reduce_scatter"] += 1
        return self._reduce_scatter(pieces, *self._line(axis),
                                    "reduce_scatter")

    def _reduce_scatter(self, pieces, ranks, i, group, axis, kind):
        if len(pieces) != len(ranks):
            raise ValueError(f"{len(pieces)} pieces for a line of "
                             f"{len(ranks)} ranks")
        mine = pieces[i]
        got = [mine if j == i else torch.empty_like(mine)
               for j in range(len(ranks))]
        self._exchange(kind, [(r, pieces[j]) for j, r in enumerate(ranks)
                              if j != i],
                       [(r, got[j]) for j, r in enumerate(ranks) if j != i],
                       group, axis)
        total = got[0].clone()
        for g in got[1:]:
            total += g
        return total

    def all_reduce(self, t, axis=None):
        """The sum of `t` over `axis`'s line (every rank for None), equal on
        every rank: a reduce_scatter of the flat tensor's pieces, then an
        all_gather of the sums. On a line of 2 each rank sends its whole
        `t` in one exchange and sums the two in the line's order: the
        same bytes and the same sum, at one host round trip where the
        two steps make two."""
        line = self._line(axis)
        ranks, i, group, axis = line
        self.calls["all_reduce"] += 1
        if len(ranks) == 1:
            return t.clone()
        if len(ranks) == 2:
            pieces = self._all_gather(t, *line, "all_reduce")
            return pieces[0] + pieces[1]
        pieces = list(t.reshape(-1).tensor_split(len(ranks)))
        mine = self._reduce_scatter(pieces, *line, "all_reduce")
        outs = [mine if j == i else torch.empty_like(pieces[j])
                for j in range(len(ranks))]
        self._exchange("all_reduce",
                       [(r, mine) for j, r in enumerate(ranks) if j != i],
                       [(r, outs[j]) for j, r in enumerate(ranks) if j != i],
                       group, axis)
        return torch.cat(outs).reshape(t.shape)

    def gather(self, t, dst=0):
        """[piece of rank j for every rank] on rank `dst` (its own piece is
        `t`), None on the others. Every piece has t's shape and dtype."""
        self.calls["gather"] += 1
        me, world = self.mesh.rank, self.mesh.size
        if me != dst:
            self._exchange("gather", [(dst, t)], [])
            return None
        pieces = [t if j == me else torch.empty_like(t)
                  for j in range(world)]
        self._exchange("gather", [], [(j, pieces[j]) for j in range(world)
                                      if j != me])
        return pieces
