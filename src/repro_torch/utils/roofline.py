"""Roofline terms of one NVIDIA H100 and the step counts behind them (the
port of `repro/utils/roofline.py`).

    compute term    = sum over units of FLOPs / (chips * that unit's peak)
    memory term     = HBM bytes / (chips * HBM rate)
    collective term = bytes the chips send / (chips * link rate)

Peaks (NVIDIA's H100 SXM data sheet, dense, at its 700 W limit): 989
TFLOP/s in bf16 on the tensor cores, 495 in TF32, 67 in f32 outside
them; 3.35 TB/s and 80 GB of HBM; NVLink 900 GB/s a GPU in both
directions together, so 450 GB/s for what one GPU sends. A step counted
on one card has no collective term (`collective_bytes` 0, `chips` 1);
the mesh superstep's caller sets both
(`dist.trainer.mesh_collective_bytes`).

`StepCost` counts a step: FLOPs of the aten products by
`torch.utils.flop_counter`'s formulas (its `flop_registry`, what
`FlopCounterMode` applies), HBM bytes under the reference's perfect
elementwise fusion model (`repro/utils/hlo_flops.py`: products move
their operands and results, gathers and slice reads twice their result,
scatters and writes through a view twice their update;
elementwise ops and reductions move nothing), and each kernel call's
`kernels.costs` record. While a kernel's plain version (or its wrapper)
runs, the modes are paused, so a step counts the kernel's work on the
card, on the CPU and on fake tensors alike.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import costs

CARD = "NVIDIA H100 SXM 80GB (data sheet, 700 W)"
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
HBM_BW = 3.35e12          # bytes/s
HBM_BYTES = 80e9          # device memory
LINK_BW = 450e9           # bytes/s one GPU sends over NVLink


def product_unit(dtype) -> str:
    """The unit a product in `dtype` runs on: the bf16 tensor cores for a
    16-bit float, TF32 for f32 where `torch.backends.cuda.matmul.
    allow_tf32` allows it, else the f32 units."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "f32"


def peak_flops(dtype) -> float:
    """Peak FLOP/s for a step computing in `dtype` (a torch dtype or its
    name, as `ArchConfig.compute_dtype`)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return PEAK_FLOPS[product_unit(dtype)]


def compute_seconds(flops_by_unit) -> float:
    return sum(n / PEAK_FLOPS[unit] for unit, n in dict(flops_by_unit).items())


def bound_seconds(cost) -> float:
    """A kernel call's roofline bound: the larger of its bytes over the HBM
    rate and its operations over their units' peaks."""
    return max(cost.bytes / HBM_BW, compute_seconds(cost.ops))


class Roofline:
    """The reference's roofline record: flops, hbm_bytes,
    collective_bytes and chips, with the FLOPs split by unit. The FLOPs
    and bytes are the whole step's, over all its chips."""

    def __init__(self, flops_by_unit, hbm_bytes, collective_bytes=0.0,
                 chips=1):
        self.flops_by_unit = {u: int(n) for u, n in
                              dict(flops_by_unit).items() if n}
        self.flops = float(sum(self.flops_by_unit.values()))
        self.hbm_bytes = float(hbm_bytes)
        self.collective_bytes = float(collective_bytes)
        self.chips = int(chips)

    @property
    def compute_s(self):
        return compute_seconds(self.flops_by_unit) / self.chips

    @property
    def memory_s(self):
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self):
        return self.collective_bytes / (self.chips * LINK_BW)

    @property
    def bound_s(self):
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self):
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_by_unit": self.flops_by_unit,
            "card": CARD,
        }


def count_params(params) -> int:
    """Elements of a {name: tensor} dict (fake tensors too)."""
    return sum(int(t.numel()) for t in params.values())


def active_params(cfg, total: int, expert_params: int = 0) -> float:
    """MoE: active = dense + experts * top_k / num_experts."""
    if cfg.moe is None:
        return float(total)
    m = cfg.moe
    routed = expert_params
    dense = total - routed
    return dense + routed * (m.top_k / m.num_experts)


def model_flops(cfg, shape, total_params: float, act_params: float) -> float:
    """6*N*D for train, 2*N*D forward-only (prefill / decode)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * act_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * act_params * tokens
    tokens = shape.global_batch * 1        # one decode token per sequence
    return 2.0 * act_params * tokens


def mfu(model_flops_: float, seconds: float, dtype) -> float:
    """The share of the card's peak in `dtype` that `model_flops_` in
    `seconds` of wall time reach."""
    return model_flops_ / (seconds * peak_flops(dtype))


# ---------------------------------------------------------------------------
# counting a step
# ---------------------------------------------------------------------------


def _unique_bytes(t) -> int:
    """Bytes of t's distinct elements (a broadcast dim counts once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _tensors(tree):
    """The tensors of a nested dict / list / tuple."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / list / tuple."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _operands_and_results(args, kwargs, out):
    return sum(_unique_bytes(t) for t in _tensors(
        list(args) + list(kwargs.values()) + [out]))


def _result_x2(args, kwargs, out):
    return 2 * sum(_unique_bytes(t) for t in _tensors(out))


def _update_x2(index):
    return lambda args, kwargs, out: 2 * _unique_bytes(args[index])


def _scatter(args, kwargs, out):
    """scatter(self, dim, index, src | value): index's elements written."""
    return 2 * args[2].numel() * args[0].element_size()


def _copy(args, kwargs, out):
    """copy_(dst, src): a write through a view (a cache layer or row, an
    agent's slice of a state leaf) reads the update and writes it; a whole
    tensor's copy is an elementwise pass and moves nothing."""
    dst, src = args[0], args[1]
    if not dst._is_view():
        return 0
    return _unique_bytes(src) + dst.numel() * dst.element_size()


aten = torch.ops.aten
BYTE_RULES = {
    aten.embedding: _result_x2,
    aten.index_select: _result_x2,
    aten.gather: _result_x2,
    aten.index: _result_x2,
    aten.index_put: _update_x2(2),
    aten.index_put_: _update_x2(2),
    aten._index_put_impl_: _update_x2(2),
    aten.index_copy: _update_x2(3),
    aten.index_copy_: _update_x2(3),
    aten.index_add: _update_x2(3),
    aten.index_add_: _update_x2(3),
    aten.scatter: _scatter,
    aten.scatter_: _scatter,
    aten.scatter_add: _scatter,
    aten.scatter_add_: _scatter,
    aten.scatter_reduce: _scatter,
    aten.scatter_reduce_: _scatter,
    aten.embedding_dense_backward: _update_x2(0),
    aten.slice_backward: _update_x2(0),
    aten.select_backward: _update_x2(0),
    aten.slice_scatter: _update_x2(1),
    aten.select_scatter: _update_x2(1),
    aten.copy_: _copy,
}
# metadata queries: no work, and most of a fake step's dispatches
_NO_WORK = {aten.sym_size.default, aten.sym_stride.default,
            aten.sym_numel.default, aten.sym_storage_offset.default,
            aten.is_contiguous.default, aten.size.default,
            aten.stride.default, aten.numel.default, aten.dim.default,
            torch.ops.prim.device.default, torch.ops.prim.layout.default}
_NOT_COMPOSITE = set()      # ops that `decompose` returned unchanged


class _CountMode(TorchDispatchMode):
    def __init__(self, count):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.count.paused_depth or func in _NO_WORK:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            out = func(*args, **kwargs)
            unit = product_unit(next(_tensors(args)).dtype)
            self.count.flops_by_unit[unit] += flop_registry[packet](
                *args, **kwargs, out_val=out)
            self.count.aten_bytes += _operands_and_results(args, kwargs, out)
            return out
        rule = BYTE_RULES.get(packet)
        if rule is None and func not in _NOT_COMPOSITE:
            # an implicit composite (a product inside it) reaches the mode
            # where autograd is off; count its parts, as FlopCounterMode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            _NOT_COMPOSITE.add(func)
        out = func(*args, **kwargs)
        if rule is not None:
            self.count.aten_bytes += rule(args, kwargs, out)
        return out


class StepCost:
    """Count one step's FLOPs and HBM bytes:

        with StepCost() as cost:
            step(...)
        cost.flops, cost.bytes, cost.roofline()

    Products and memory traffic of aten ops are counted in a dispatch
    mode; each kernel call of `kernels.ops` adds its `costs` record and
    pauses the mode while its plain version or its wrapper runs. On fake
    tensors enter it inside the FakeTensorMode. One count is open at a
    time."""

    def __init__(self):
        self.flops_by_unit = defaultdict(int)   # aten products
        self.aten_bytes = 0
        self.kernels = []                        # costs.Cost records
        self.paused_depth = 0
        self._mode = None

    def __enter__(self):
        if costs.OPEN is not None:
            raise RuntimeError("a StepCost is already open")
        self._mode = _CountMode(self)
        self._mode.__enter__()
        costs.OPEN = self
        return self

    def __exit__(self, *exc):
        costs.OPEN = None
        mode, self._mode = self._mode, None
        return mode.__exit__(*exc)

    def record(self, cost):
        self.kernels.append(cost)

    def add(self, other, times=1):
        """Add `times` copies of another count (a step counted in parts)."""
        for unit, n in other.flops_by_unit.items():
            self.flops_by_unit[unit] += times * n
        self.aten_bytes += times * other.aten_bytes
        self.kernels.extend(other.kernels * times)

    @contextlib.contextmanager
    def paused(self):
        """Count nothing inside (a kernel's plain version or wrapper)."""
        self.paused_depth += 1
        try:
            yield
        finally:
            self.paused_depth -= 1

    def ops_by_unit(self):
        """FLOPs by unit, products and kernels together."""
        out = defaultdict(int, self.flops_by_unit)
        for c in self.kernels:
            for unit, n in c.ops:
                out[unit] += n
        return dict(out)

    @property
    def flops(self) -> int:
        return sum(self.ops_by_unit().values())

    @property
    def bytes(self) -> int:
        return self.aten_bytes + sum(c.bytes for c in self.kernels)

    def by_kernel(self):
        """{kernel: {"calls", "flops", "bytes"}} over the recorded calls."""
        out = {}
        for c in self.kernels:
            k = out.setdefault(c.kernel, {"calls": 0, "flops": 0,
                                          "bytes": 0})
            k["calls"] += 1
            k["flops"] += c.flops
            k["bytes"] += c.bytes
        return out

    def roofline(self) -> Roofline:
        return Roofline(self.ops_by_unit(), self.bytes)

    def as_dict(self):
        return {"flops": self.flops, "bytes": self.bytes,
                "flops_by_unit": self.ops_by_unit(),
                "aten_flops": sum(self.flops_by_unit.values()),
                "aten_bytes": self.aten_bytes,
                "kernels": self.by_kernel()}
