"""Operations and device-memory bytes of one call of each kernel.

The roofline model of `PERF.md` §6, one function a kernel of `ops` (the
seven forward kernels and the two backward kernels), each taking the
call's tensors and returning a `Cost`:

  * bytes: each input read once and each output written once, in their
    dtypes, whatever the kernel reads again;
  * operations: the fewest the function needs, by the unit that runs
    them: "bf16" (tensor cores on bf16), "tf32" (tensor cores on TF32)
    or "f32" (the f32 units outside the tensor cores). Attention counts
    4 hd a (query head, attended key) pair (two products), on the
    tensor cores for bf16 operands and on the f32 units for f32 ones.

Where the work depends on the data, the inputs' need counts: the decode
kernels read K/V for sum_b min(lengths_b, capacity) rows. On a real
tensor the lengths are read (one host read: counting is never timed);
on a fake tensor (`torch._subclasses.fake_tensor`) every row counts at
the capacity, a cache filled to its length.

`OPEN` is the count that `utils.roofline.StepCost` holds open while a
step runs (None otherwise); `ops` records each call's `Cost` in it.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels.rwkv6_scan import CHUNK as WKV_CHUNK

OPEN = None     # the open StepCost, or None

# f32 operations an element or state step, as PERF.md §6 counts them: the
# fused RG-LRU's 2 bias adds, 2 sigmoids (4 each: negate, exp, add,
# divide), the decay's product and exp, i * xa, a * a, 1 - a^2, the clamp,
# sqrt, the scale's product and the step's 2; the backward kernels' per
# state element and step (WKV: the forward state walked once, the gradient
# state once, three row products and one column product, v . do) and per
# element (RG-LRU: the gates, decay and scale made again, the step, the
# chain back)
PROX_OPS_PER_ELEMENT = 7
RGLRU_OPS_PER_ELEMENT = 21
RGLRU_BWD_OPS_PER_ELEMENT = 42
WKV_BWD_OPS_PER_STATE_STEP = 14


@dataclasses.dataclass(frozen=True)
class Cost:
    """One kernel call: its name, HBM bytes and operations by unit."""
    kernel: str
    bytes: int
    ops: Tuple[Tuple[str, int], ...]      # ((unit, operations), ...)

    @property
    def flops(self) -> int:
        return sum(n for _, n in self.ops)


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _attention_unit(t) -> str:
    return "bf16" if t.element_size() == 2 else "f32"


def attended_pairs(s, t, causal=True, window=0) -> int:
    """(query, key) pairs that `ref.attention`'s masks keep: query i of s
    sees key j < t with j <= i if causal and j > i - window if window."""
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(s,
                                                                    np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def prox_update(x, g, zsum) -> Cost:
    """x, g and zsum read, x_new (x's dtype) and delta (f32) written."""
    n = x.numel()
    nbytes = n * (2 * x.element_size() + g.element_size()
                  + zsum.element_size() + 4)
    return Cost("prox_update", nbytes, (("f32", PROX_OPS_PER_ELEMENT * n),))


def flash_attention(q, k, v, *, causal=True, window=0) -> Cost:
    """q, k and v read, the output (q's shape and dtype) written; both
    products over the attended pairs."""
    b, s, h, hd = q.shape
    pairs = attended_pairs(s, k.shape[1], causal, window)
    nbytes = 2 * _nbytes(q) + _nbytes(k) + _nbytes(v)
    return Cost("flash_attention", nbytes,
                ((_attention_unit(q), 4 * b * h * hd * pairs),))


def _rows(lengths, cap, batch) -> np.ndarray:
    """Each row's valid cache rows, min(length, cap): read from real
    lengths, `cap` for every row of a fake tensor."""
    if is_fake(lengths):
        return np.full(batch, cap, np.int64)
    return np.clip(lengths.detach().cpu().numpy().astype(np.int64), 0, cap)


def _decode(kernel, q, cache, rows, table_entries=0) -> Cost:
    """q read and the output written once, each valid K/V row of `cache`
    ([..., KV, hd]) once, the lengths and the table entries used."""
    b, h, hd = q.shape
    kv = cache.shape[-2]
    used = int(rows.sum())
    nbytes = (2 * _nbytes(q) + 2 * used * kv * hd * cache.element_size()
              + 4 * (b + table_entries))
    return Cost(kernel, nbytes, ((_attention_unit(q), 4 * hd * h * used),))


def decode_attention(q, k, v, *, lengths) -> Cost:
    del v
    return _decode("decode_attention", q, k,
                   _rows(lengths, k.shape[1], q.shape[0]))


def _pages(rows, bs) -> int:
    return int(((rows + bs - 1) // bs).sum())


def decode_attention_paged(q, k_pool, v_pool, block_tables, *,
                           lengths) -> Cost:
    del v_pool
    bs = k_pool.shape[1]
    rows = _rows(lengths, block_tables.shape[1] * bs, q.shape[0])
    return _decode("decode_attention_paged", q, k_pool, rows,
                   _pages(rows, bs))


def decode_attention_ring(q, k_pool, v_pool, block_tables, *, lengths,
                          window) -> Cost:
    del v_pool
    bs = k_pool.shape[1]
    rows = _rows(lengths, min(window, block_tables.shape[1] * bs),
                 q.shape[0])
    return _decode("decode_attention_ring", q, k_pool, rows,
                   _pages(rows, bs))


def rwkv6_scan(r, k, v, w, u, state) -> Cost:
    """r, k, v, w and u read, the f32 output written, the f32 state read
    and written. Operations: the chunked form (chunks of `WKV_CHUNK`
    steps), its four products a step on the TF32 tensor cores (4 hd^2 +
    2 (c + 1) hd) and the bonus and decays on the f32 units (5 hd)."""
    b, h, s, hd = r.shape
    n = b * h * s * hd
    nbytes = (n * (r.element_size() + k.element_size() + v.element_size()
                   + w.element_size() + 4)
              + _nbytes(u) + 2 * _nbytes(state))
    c = min(s, WKV_CHUNK)
    return Cost("rwkv6_scan", nbytes,
                (("tf32", (4 * hd * hd + 2 * (c + 1) * hd) * b * h * s),
                 ("f32", 5 * hd * b * h * s)))


def rwkv6_scan_bwd(r, k, v, w, u, state, dout) -> Cost:
    """r, k, v, w, u, the state and dout read; dr, dk, dv, dw (f32), du
    and the state's gradient written; 14 hd^2 f32 operations a step."""
    b, h, s, hd = r.shape
    n = b * h * s * hd
    nbytes = (n * (r.element_size() + k.element_size() + v.element_size()
                   + w.element_size() + dout.element_size() + 4 * 4)
              + _nbytes(u) + 4 * u.numel() + 2 * _nbytes(state))
    return Cost("rwkv6_scan_bwd", nbytes,
                (("f32", WKV_BWD_OPS_PER_STATE_STEP * b * h * s * hd * hd),))


def rglru_scan(gate_a, gate_i, b_a, b_i, lamb, xa, state) -> Cost:
    """The gate products and xa read, the output (xa's dtype) written;
    the three [W] vectors read; the f32 state read and written."""
    n = xa.numel()
    nbytes = (_nbytes(gate_a) + _nbytes(gate_i) + 2 * _nbytes(xa)
              + _nbytes(b_a) + _nbytes(b_i) + _nbytes(lamb)
              + 2 * _nbytes(state))
    return Cost("rglru_scan", nbytes, (("f32", RGLRU_OPS_PER_ELEMENT * n),))


def rglru_scan_bwd(gate_a, gate_i, b_a, b_i, lamb, xa, state, dout) -> Cost:
    """The gate products, xa and dout (in xa's dtype, as the kernel takes
    it) read, their three f32 gradients written; the [W] vectors read and
    their f32 gradients written; the state read and its gradient
    written."""
    n = xa.numel()
    w = lamb.numel()
    del dout
    nbytes = (_nbytes(gate_a) + _nbytes(gate_i) + 2 * _nbytes(xa)
              + 3 * 4 * n
              + _nbytes(b_a) + _nbytes(b_i) + _nbytes(lamb) + 3 * 4 * w
              + 2 * _nbytes(state))
    return Cost("rglru_scan_bwd", nbytes,
                (("f32", RGLRU_BWD_OPS_PER_ELEMENT * n),))
