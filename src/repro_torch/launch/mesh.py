"""Meshes over `torch.distributed` ranks (the port of
`repro/launch/mesh.py`).

`Mesh` names its axes and their sizes, this rank's coordinates and, for
a mesh over processes, one `torch.distributed` group per line of each
axis of size > 1 (the ranks that differ only in that axis's
coordinate). Ranks are laid out row-major over the axes, as the
reference reshapes its devices into ("agent", "replica", "model").

make_training_mesh: the API-BCD training mesh over the processes of the
    default group: A agents on the ring, R replicas of each (FSDP within
    an agent), model parallel width mp; A * R * mp must equal the world.
make_serving_mesh: the ("data", "model") serving mesh over the default
    group, data = world / mp.
make_production_mesh, training_mesh_shape: the reference's 256- and
    512-device shapes as shape-only meshes (no processes), for the dry
    run and the sharding specs.
run_ranks: the parent of a run across processes (`launch.train
    --processes`, `launch.serve_mesh`): spawn the ranks on this host,
    wait for them, end them all when one fails or time runs out.

The transport is chosen by name: `backend="nccl"` (CUDA tensors, one GPU
a rank) or `"gloo"` (host tensors; a CUDA tensor goes through a host
buffer, `dist.collectives`). NCCL refuses two ranks on one device, so
`check_backend` refuses it where there are more ranks than GPUs.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch

from repro_torch.dist.sharding import DATA_LINE, mesh_coords

TRAINING_AXES = ("agent", "replica", "model")
SERVING_AXES = ("data", "model")
BACKENDS = ("nccl", "gloo")


class Mesh:
    """Axis names and sizes; for a mesh over processes also this rank, its
    coordinates and the groups of its lines (`group(axis)`)."""

    def __init__(self, axis_names, sizes, rank=None, backend=None,
                 groups=None):
        if len(axis_names) != len(sizes):
            raise ValueError(f"axes {axis_names} and sizes {sizes}")
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in sizes)
        self.size = math.prod(self.sizes)
        self.rank = rank
        self.backend = backend
        self._groups = groups or {}

    @property
    def shape(self):
        """{axis: size}, as the reference's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def coords(self):
        """This rank's {axis: index}."""
        if self.rank is None:
            raise ValueError("a shape-only mesh has no rank")
        return mesh_coords(self.shape, self.rank)

    def rank_of(self, coords):
        """The rank at {axis: index} (axes left out: this rank's index)."""
        here = self.coords if self.rank is not None else {}
        rank = 0
        for axis, size in zip(self.axis_names, self.sizes):
            rank = rank * size + coords.get(axis, here.get(axis, 0))
        return rank

    def line(self, axis):
        """The ranks that differ from this one only along `axis`, in the
        order of that axis's coordinate; `axis` may be a tuple of axes,
        whose coordinates then run row-major."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        return [self.rank_of(dict(zip(axes, index))) for index in
                itertools.product(*(range(self.shape[a]) for a in axes))]

    def group(self, axis):
        """The `torch.distributed` group of this rank's line along `axis`
        (an axis, or a tuple of axes that `make_mesh` made lines of; None
        for a line of one rank)."""
        return self._groups.get(axis)

    def __repr__(self):
        where = "" if self.rank is None else f", rank {self.rank}"
        return f"Mesh({self.shape}{where})"


def check_backend(backend, world_size, device):
    """Refuse a transport that cannot carry this run: NCCL needs CUDA
    tensors and one GPU a rank (it refuses two ranks on one device)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend != "nccl":
        return
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the nccl backend moves CUDA tensors only; use "
                         "--backend gloo with --device cpu")
    gpus = torch.cuda.device_count()
    if world_size > gpus:
        raise ValueError(
            f"the nccl backend needs one GPU a rank: {world_size} ranks, "
            f"{gpus} GPU(s) (NCCL refuses two ranks on one device); use "
            "--backend gloo to share a card")


def rank_device(device, rank):
    """The device of `rank`: its own GPU where there are enough, else the
    GPU it shares (rank modulo the count); the CPU stays the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(rank, world_size, coordinator, backend, device,
                     timeout_s=600.0):
    """Join the default group through a TCPStore at `coordinator`
    ("host:port"; rank 0 hosts the store)."""
    import torch.distributed as dist

    check_backend(backend, world_size, device)
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), world_size, rank == 0,
                          timeout=timeout)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = rank_device(device, rank)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout, **kwargs)


def make_mesh(axis_names, sizes, lines=()):
    """A mesh of these axes over the processes of the default group, with
    a group for every line of every axis of size > 1 and of every tuple
    of axes in `lines` (each process makes every group, in the same
    order, as `torch.distributed.new_group` requires)."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(sizes) != world:
        raise ValueError(f"a mesh of {dict(zip(axis_names, sizes))} needs "
                         f"{math.prod(sizes)} processes, not {world}")
    groups = {}
    shape = dict(zip(axis_names, sizes))
    for axis in list(axis_names) + list(lines):
        size = math.prod(shape[a] for a in (axis if isinstance(axis, tuple)
                                            else (axis,)))
        if size == 1:
            continue
        members = dict.fromkeys(
            tuple(Mesh(axis_names, sizes, rank=r).line(axis))
            for r in range(world))
        for line in members:
            group = dist.new_group(list(line))
            if rank in line:
                groups[axis] = group
    return Mesh(axis_names, sizes, rank=rank, backend=dist.get_backend(),
                groups=groups)


def make_training_mesh(num_agents, replica=1, model_parallel=1):
    """The ("agent", "replica", "model") mesh over the default group's
    processes; num_agents * replica * model_parallel must equal the
    world, as the reference asserts. With a model axis above 1 it also
    has the group of the data-parallel line (`DATA_LINE`: the ranks of
    one model coordinate, whose gradients the DP baseline sums)."""
    return make_mesh(TRAINING_AXES, (num_agents, replica, model_parallel),
                     lines=(DATA_LINE,) if model_parallel > 1 else ())


def make_serving_mesh(model_parallel=1):
    """The ("data", "model") mesh over the default group's processes, data
    = world / model_parallel, as the reference reshapes its devices for
    `serve_mesh`: the decode rows split over "data"
    (`dist.serving.RowSplit`), the model over "model"."""
    import torch.distributed as dist

    world = dist.get_world_size()
    if world % model_parallel:
        raise ValueError(f"a model axis of {model_parallel} does not divide "
                         f"{world} processes")
    return make_mesh(SERVING_AXES, (world // model_parallel, model_parallel))


def make_production_mesh(*, multi_pod=False):
    """The reference's production shape, without processes: (16, 16)
    ("data", "model"), or (2, 16, 16) ("pod", "data", "model")."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def training_mesh_shape(num_agents, model_parallel=16, *, multi_pod=False):
    """The reference's training view of the production devices, without
    processes: ("agent", "replica", "model") with replica = devices /
    (A * mp)."""
    total = 512 if multi_pod else 256
    if total % (num_agents * model_parallel):
        raise ValueError(f"{num_agents} agents x {model_parallel} model "
                         f"parallel do not tile {total} devices")
    return Mesh(TRAINING_AXES, (num_agents,
                                total // (num_agents * model_parallel),
                                model_parallel))


@dataclasses.dataclass
class RankRun:
    """What `run_ranks` saw: each rank's output and exit code, whether the
    timeout ended them, the host's `time.perf_counter()` at the spawn and
    when each rank was seen to exit, and `while_running`'s result."""
    outs: list
    rcs: list
    timed_out: bool
    spawned: float
    exited: dict
    during: object = None


def run_ranks(module, argv, processes, rank_flag, timeout,
              while_running=None):
    """Spawn `processes` ranks of `python -m module *argv rank_flag R
    --coordinator localhost:PORT` on this host (a free port; this
    package's `src` first on PYTHONPATH; gloo's links over the loopback
    unless GLOO_SOCKET_IFNAME says otherwise), each writing its output to
    a file of its own; run `while_running()` while they start; wait until
    every rank has exited, one has failed (the others are ended at once)
    or `timeout` seconds have passed (all are ended). Returns a
    `RankRun`."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                 if p]))
    # every rank runs on this host: gloo's links go over the loopback
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(prefix="mesh_ranks_") as logs:
        procs, files, exited = [], [], {}
        timed_out, during = False, None
        spawned = time.perf_counter()
        for r in range(processes):
            f = open(os.path.join(logs, f"rank{r}.log"), "w")
            files.append(f)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *argv, rank_flag, str(r),
                 "--coordinator", f"localhost:{port}"],
                stdout=f, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout
        try:
            if while_running is not None:
                during = while_running()
            while True:
                for r, p in enumerate(procs):
                    if r not in exited and p.poll() is not None:
                        exited[r] = time.perf_counter()
                if (len(exited) == len(procs)
                        or any(p.returncode not in (None, 0) for p in procs)):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in files:
                f.close()
        outs = []
        for r in range(processes):
            with open(os.path.join(logs, f"rank{r}.log")) as f:
                outs.append(f.read())
    return RankRun(outs=outs, rcs=[p.returncode for p in procs],
                   timed_out=timed_out, spawned=spawned, exited=exited,
                   during=during)
