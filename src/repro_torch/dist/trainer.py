"""The API-BCD superstep (gAPI-BCD, eq. 15 + 12b) in one process.

The port of `repro/dist/trainer.py`. Every state leaf carries a leading
agent axis ([A, ...]; the token copies zhat are [A, M, ...]). Each
superstep:

  * every agent computes its loss gradient on its own batch (a loop over
    agents with `torch.autograd.grad` on leaves detached from the agent's
    views of the parameters, one agent's activations at a time; a
    `torch.utils.checkpoint` region inside `train_loss`, which the
    model's remat uses, runs under `torch.autograd.grad` but not under
    `torch.func.grad`),
  * the M token-holding agents, marked by the round-robin schedule
    `(slot - step) % (A/M) == 0`, apply the closed-form update through
    `kernels.ops.prox_update` (the Hopper kernel on CUDA), and credit
    (x_new - x)/A to the token they hold (eq. 12b),
  * tokens move one hop on the agent ring (slot i receives slot i-1's
    token): a roll of the agent axis, where the reference uses ppermute.

Paper-faithful mode (`accumulate_between_visits=False`) leaves the A - M
idle agents untouched; the default accumulates every agent's gradient
between visits and applies the mean at its next activation.

Unlike the reference, which builds whole-tree temporaries, the step
updates the state IN PLACE, one leaf at a time, so that only one leaf's
temporaries exist at once: at full qwen2-0.5b width with A=4 and M=2 the
state alone is ~39.5 GB of the card's 80.

Across processes (`make_mesh_train_step`, the reference's mesh program
over ("agent", "replica", "model")), each rank holds one agent's slot of
every leaf, cut to its tensor-parallel piece on the "model" axis
(`dist.tensor_parallel`: heads, d_ff and vocabulary rows) and to its
"replica" shard (`state_specs`), and runs the same superstep on it: the
model's loss and gradient through `build_model(model_axis=)`, whose sums
over the axis are collectives, and the update on the piece; the token
hop is `dist.collectives.ring_shift`, point-to-point sends where the
reference has ppermute. `make_mesh_dp_baseline_step` splits the DP
baseline the same way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def init_train_state(model, tcfg, generator):
    """Build the API-BCD train state: {"params", "token", "zhat", "gacc"}.

    params: [A, ...] per-agent models, replicated from one model.init
            (the paper's common initialization; tokens start at 0).
    token:  [A, ...] value of the token currently at each ring slot.
    zhat:   [A, M, ...] local token copies zhat_{i,m}.
    gacc:   [A, ...] gradient accumulator (between-visit accumulation).

    Tensors live on the generator's device.
    """
    a, m = tcfg.num_agents, tcfg.num_walks
    if a % m:
        raise ValueError(f"num_agents {a} is not a multiple of num_walks {m}")
    p0 = model.init(generator)
    f32 = torch.float32
    state = {
        "params": {k: v.expand((a,) + v.shape).clone() for k, v in p0.items()},
        "token": {k: v.new_zeros((a,) + v.shape, dtype=f32)
                  for k, v in p0.items()},
        "zhat": {k: v.new_zeros((a, m) + v.shape, dtype=f32)
                 for k, v in p0.items()},
        "gacc": {k: v.new_zeros((a,) + v.shape, dtype=f32)
                 for k, v in p0.items()},
    }
    return state


def _grad(model, params, batch):
    """(grads, (loss, metrics)) of `model.train_loss` at `params`.

    Each leaf is detached (a view on the same storage, so no copy) and
    made to require grad; the gradients come from `torch.autograd.grad`.
    """
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, metrics = model.train_loss(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (dict(zip(leaves, grads)),
            (loss.detach(), {k: v.detach() for k, v in metrics.items()}))


def _token_holders(agents, step, a, period):
    """{local slot: walk} of the slots whose agent (`agents[slot]`, a global
    index) holds a token at `step`: the round-robin schedule
    `(agent - step) % (A/M) == 0`, walk `((agent - step) % A) // (A/M)`."""
    holders = {}
    for slot, i in enumerate(agents):
        rel = (i - step) % a
        if rel % period == 0:
            holders[slot] = rel // period
    return holders


def _update_leaf(x, g, tok, zh, acc, holders, shift, *, period, tau, rho,
                 m, a):
    """One leaf's update, in place, on the local agent slots (all A in one
    process, the rank's one on the mesh): eq. 15 through
    `ops.prox_update` with the global num_agents `a` (the credit of eq.
    12b is divided by A), then, at the token holders only (the others
    stay bit-identical), the new x, the token's credit and its copy in
    zhat (12c), and the token's hop `tok <- shift(tok)`.

    x, tok [n, ...]; zh [n, M, ...]; g the step's gradient [n, ...], or,
    accumulating, the accumulator `acc` itself with this step's gradient
    summed in: its mean over the visit period (the steady-state visit
    interval) is applied and `acc` is zeroed at the holders; acc None in
    paper-faithful mode."""
    g_eff = g / period if acc is not None else g.float()
    zsum = zh.sum(dim=1)
    x_full, d_full = ops.prox_update(
        x, g_eff, zsum, tau=tau, rho=rho, num_walks=m, num_agents=a)
    del g_eff, zsum
    for i, walk in holders.items():
        x[i] = x_full[i]
        tok[i] += d_full[i]
        zh[i, walk] = tok[i]                 # (12c)
        if acc is not None:
            acc[i] = 0.0
    del x_full, d_full
    tok.copy_(shift(tok))


def _roll(t):
    """The token hop in one process: slot i receives slot i-1's value."""
    return torch.roll(t, shifts=1, dims=0)


def _optimizer_step(opt, schedule, params, opt_state, grads, step):
    """The DP baseline's update half: one optimizer step at schedule(step).
    Returns new (params, opt_state), as in the reference."""
    from repro_torch.optim.optimizers import apply_updates

    updates, opt_state = opt.update(grads, opt_state, params, schedule(step))
    return apply_updates(params, updates), opt_state


def make_train_step(model, tcfg):
    """Build the superstep: (state, batch, step) -> (state, metrics).

    batch leaves are [A, ...] (per-agent shards); step is a Python int.
    The state is updated in place and returned. Semantics match the
    reference's `make_train_step`.
    """
    a, m = tcfg.num_agents, tcfg.num_walks
    if a % m:
        raise ValueError(f"num_agents {a} is not a multiple of num_walks {m}")
    period = a // m
    tau, rho = float(tcfg.tau), float(tcfg.rho)
    accumulate = bool(tcfg.accumulate_between_visits)

    def step_fn(state, batch, step):
        params, token = state["params"], state["token"]
        zhat, gacc = state["zhat"], state["gacc"]

        # gradients, one agent at a time: summed into gacc in place
        # (accumulating), else kept per agent for this step
        grads = gacc if accumulate else {
            k: torch.empty(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()}
        losses, nlls, auxs = [], [], []
        for i in range(a):
            g_i, (loss, metr) = _grad(model, {k: v[i] for k, v in
                                              params.items()},
                                      {k: v[i] for k, v in batch.items()})
            for k, g in g_i.items():
                if accumulate:
                    grads[k][i] += g
                else:
                    grads[k][i] = g
            del g_i
            losses.append(loss)
            nlls.append(metr["nll"])
            auxs.append(metr["aux"])

        holders = _token_holders(range(a), step, a, period)
        for k, x in params.items():
            _update_leaf(x, grads[k], token[k], zhat[k],
                         gacc[k] if accumulate else None, holders, _roll,
                         period=period, tau=tau, rho=rho, m=m, a=a)

        metrics = {"loss": torch.stack(losses).mean(),
                   "nll": torch.stack(nlls).mean(),
                   "aux": torch.stack(auxs).mean()}
        return state, metrics

    return step_fn


def make_dp_baseline_step(model, opt, schedule):
    """Synchronous all-reduce data-parallel baseline (what API-BCD
    replaces): one parameter set, the global batch's gradient, one
    optimizer step (`repro_torch.optim`).

    Returns (params, opt_state, batch, step) -> (params, opt_state,
    metrics) with metrics {"loss", "nll", "aux"}; params and opt_state are
    new dicts, as in the reference. On one device the global batch is
    one batch, so there is no all-reduce to make.
    """
    def step_fn(params, opt_state, batch, step):
        grads, (loss, metr) = _grad(model, params, batch)
        params, opt_state = _optimizer_step(opt, schedule, params,
                                            opt_state, grads, step)
        return params, opt_state, {"loss": loss, **metr}

    return step_fn


# ---------------------------------------------------------------------------
# the superstep across processes: one agent a rank, FSDP over "replica"
# ---------------------------------------------------------------------------


def _param_shapes(model):
    """model.init's leaves as fake tensors (shapes and dtypes; nothing is
    allocated; an init that copies real tensors copies them as fakes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return model.init(torch.Generator())


def _state_shapes(shapes, tcfg):
    a, m = tcfg.num_agents, tcfg.num_walks
    stacked = {k: (a,) + tuple(v.shape) for k, v in shapes.items()}
    return {"params": stacked, "token": stacked, "gacc": stacked,
            "zhat": {k: (a, m) + tuple(v.shape) for k, v in shapes.items()}}


def _check_mesh(model, tcfg, mesh):
    """Refuse a mesh the superstep cannot run on."""
    from repro_torch.dist.sharding import axis_sizes

    sizes = axis_sizes(mesh)
    if tcfg.num_walks < 1 or tcfg.num_agents % tcfg.num_walks:
        raise ValueError(f"num_agents {tcfg.num_agents} is not a multiple "
                         f"of num_walks {tcfg.num_walks}")
    if sizes.get("agent") != tcfg.num_agents:
        raise ValueError(f"the mesh's agent axis {sizes.get('agent')} must "
                         f"equal num_agents {tcfg.num_agents}")
    _check_model_axis(model, sizes)
    cfg = getattr(model, "cfg", None)
    if sizes.get("replica", 1) > 1 and cfg is not None and cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: replica > 1 with MoE layers is not supported: the "
            "GShard capacity and the load-balance loss are statistics of "
            "the whole batch, which a split of an agent's rows changes; run "
            "it with replica 1")


def _check_model_axis(model, sizes):
    """Refuse what a model axis of `sizes` cannot train
    (`tensor_parallel.check_tensor_parallel(training=True)`: the dense
    attention stack only, naming the ROADMAP item that would split the
    rest)."""
    mp = sizes.get("model", 1)
    if mp == 1:
        return
    from repro_torch.dist.tensor_parallel import check_tensor_parallel

    cfg = getattr(model, "cfg", None)
    if cfg is None:
        raise ValueError("a model axis above 1 needs the model's config "
                         "(`model.cfg`) to split it")
    check_tensor_parallel(cfg, mp, training=True)


def _rank_model(model, mesh, comm):
    """The model a rank runs: `model` itself, or on a model axis above 1
    this rank's slice of it (`build_model(model_axis=)`)."""
    from repro_torch.dist.sharding import axis_sizes

    if axis_sizes(mesh).get("model", 1) == 1:
        return model
    from repro_torch.dist.tensor_parallel import ModelAxis
    from repro_torch.models import build_model

    return build_model(model.cfg, window=getattr(model, "window", 0),
                       model_axis=ModelAxis(comm, mesh))


def state_specs(model, tcfg, mesh, shapes=None):
    """The specs of the API-BCD state on a training mesh: the agent on dim
    0, "replica" greedy (`sharding.state_shardings`) and, on a model axis
    above 1, "model" on the dim that `tensor_parallel.param_specs`
    splits; the reference's `state_shardings` where the model axis is 1.
    `shapes`: model.init's leaves (default: `_param_shapes(model)`)."""
    from repro_torch.dist.sharding import axis_sizes, state_shardings

    shapes = _param_shapes(model) if shapes is None else shapes
    dims = None
    if axis_sizes(mesh).get("model", 1) > 1:
        from repro_torch.dist.tensor_parallel import model_dims

        _check_model_axis(model, axis_sizes(mesh))
        dims = model_dims(model.cfg, shapes)
    return state_shardings(mesh, _state_shapes(shapes, tcfg), model_dims=dims)


def init_mesh_train_state(model, tcfg, mesh, generator):
    """This rank's part of `init_train_state`: its agent slot of every
    leaf, cut to its piece by `state_specs` (its tensor-parallel piece,
    then its "replica" shard; leaves [1, ...], zhat [1, M, ...]). Every
    rank draws the same `model.init(generator)` and keeps its own piece,
    so the pieces of all ranks make up the one-process state (tokens
    start at 0)."""
    from repro_torch.dist.sharding import local_shard

    _check_mesh(model, tcfg, mesh)
    a, m = tcfg.num_agents, tcfg.num_walks
    p0 = model.init(generator)
    specs = state_specs(model, tcfg, mesh, p0)
    coords = mesh.coords
    f32 = torch.float32
    state = {"params": {}, "token": {}, "zhat": {}, "gacc": {}}
    for k, v in p0.items():
        x = local_shard(v.expand((a,) + v.shape), specs["params"][k], mesh,
                        coords)
        state["params"][k] = x
        state["token"][k] = x.new_zeros(x.shape, dtype=f32)
        state["zhat"][k] = x.new_zeros((1, m) + x.shape[1:], dtype=f32)
        state["gacc"][k] = x.new_zeros(x.shape, dtype=f32)
    del p0
    return state


def _row_weight(batch, local, agent, lead):
    """This replica's share of its agent's loss: its loss-mask tokens over
    the agent's (the loss is sum(nll * mask) / max(sum(mask), 1)), or its
    rows of the batch leaf `lead` over the agent's where there is no
    mask."""
    mask = batch.get("loss_mask")
    if mask is None:
        return local[lead].shape[0] / batch[lead].shape[1]
    return (local["loss_mask"].float().sum()
            / torch.clamp_min(mask[agent].float().sum(), 1.0))


def _all_reduce_sends(numel, n, index):
    """Elements the rank at `index` of a line of n sends in one
    `Collectives.all_reduce` of `numel` elements: the whole tensor on a
    line of 2; else the other ranks' pieces of the flat tensor, then its
    own piece to each of them."""
    piece = numel // n + (index < numel % n)
    return numel + (n - 2) * piece


def model_axis_sends(cfg, mp, index, rows, seq, partial_numel=0):
    """{kind: bytes} the rank at `index` of a model axis of `mp` sends in
    one loss and gradient of `train_loss(axis=)` (remat on, its default)
    on `rows` rows of `seq` tokens: in "all_reduce", the lookup's sum in
    the compute dtype; each layer's two row-parallel sums in the
    forward, the attention's again where remat replays the layer in the
    backward (the replay stops at the layer's last saved tensor, the
    input of `w_down`'s product, before the MLP's sum), and the
    backward's sums of `copy` (q/k/v's and gate/up's inputs, each layer,
    and the head's) in `tensor_parallel.SUM_DTYPE`; the cross-entropy's
    (sum, target logit) pairs in f32; and `partial_numel` elements of
    whole leaves summed by `replicate`; in "all_gather", the
    cross-entropy's maxima in f32."""
    from repro_torch.dist.tensor_parallel import SUM_DTYPE

    f32, wide = 4, SUM_DTYPE.itemsize
    elem = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                       ).element_size()
    tokens = rows * seq
    sums = ([(tokens * cfg.d_model, elem), (2 * tokens, f32),
             (tokens * cfg.d_model, wide), (partial_numel, wide)]
            + [(tokens * cfg.d_model, wide)] * (5 * cfg.num_layers))
    return {"all_reduce": sum(size * _all_reduce_sends(n, mp, index)
                              for n, size in sums if n),
            "all_gather": (mp - 1) * tokens * f32}


def superstep_sends(param_shapes, mesh, rows_per_agent, metrics=3, *,
                    cfg=None, seq=0):
    """[{kind: bytes} for each rank]: what `make_mesh_train_step`'s
    superstep makes each rank send, reckoned from the leaf shapes and the
    mesh's axes: per leaf, the all_gather of its params (R - 1 pieces of
    its shard, where "replica" splits it), the reduce_scatter of its f32
    gradient (R - 1 pieces, where the agent's rows split over "replica")
    and the ring_shift of its f32 token shard (where A > 1); and the
    all_reduce of the `metrics` f32 means over every rank. On a model
    axis above 1 (`cfg`: the whole model's config, `seq` a row's tokens)
    the shards are those of `state_specs`, and each rank also sends the
    sums of the model axis (`model_axis_sends`)."""
    import math

    from repro_torch.dist.sharding import (axis_sizes, param_shardings,
                                           shard_shape, state_shardings)

    sizes = axis_sizes(mesh)
    a, r = sizes["agent"], sizes.get("replica", 1)
    mp = sizes.get("model", 1)
    world = math.prod(sizes.values())
    stacked = {k: (a,) + tuple(v.shape) for k, v in param_shapes.items()}
    if mp > 1:
        from repro_torch.dist.tensor_parallel import PARTIAL, model_dims

        if cfg is None:
            raise ValueError("a model axis above 1: superstep_sends needs "
                             "the model's config")
        specs = state_shardings(sizes, {"params": stacked},
                                model_dims(cfg, param_shapes))["params"]
    else:
        specs = param_shardings(sizes, stacked)
    per_rank = {"ring_shift": 0, "all_gather": 0, "reduce_scatter": 0}
    for k, v in param_shapes.items():
        n = math.prod(shard_shape(stacked[k], specs[k], sizes))
        if a > 1:
            per_rank["ring_shift"] += 4 * n
        if r > 1 and "replica" in specs[k]:
            per_rank["all_gather"] += (r - 1) * n * v.element_size()
        if r > 1 and rows_per_agent % r == 0:
            per_rank["reduce_scatter"] += (r - 1) * 4 * n
    axis = {}
    if mp > 1:
        rows = rows_per_agent // r if rows_per_agent % r == 0 else \
            rows_per_agent
        partial = sum(v.numel() for k, v in param_shapes.items()
                      if k.split(".", 2)[-1] in PARTIAL)
        axis = [model_axis_sends(cfg, mp, i, rows, seq, partial)
                for i in range(mp)]
    out = []
    pieces = [int(p.numel()) for p in torch.empty(metrics).tensor_split(
        world)] if world > 1 else [0]
    for rank in range(world):
        sends = dict(per_rank)
        if world > 1:         # the reduce_scatter, then the all_gather
            sends["all_reduce"] = 4 * (metrics - pieces[rank]
                                       + (world - 1) * pieces[rank])
        for kind, b in (axis[rank % mp].items() if axis else ()):
            sends[kind] = sends.get(kind, 0) + b
        out.append({k: v for k, v in sends.items() if v})
    return out


def mesh_collective_bytes(param_shapes, mesh, rows_per_agent, metrics=3,
                          **model_axis):
    """The bytes every rank of the mesh sends in one superstep, summed: the
    `collective_bytes` of the superstep's `utils.roofline.Roofline`
    (`model_axis`: `superstep_sends`'s keywords)."""
    return sum(sum(s.values()) for s in superstep_sends(
        param_shapes, mesh, rows_per_agent, metrics, **model_axis))


def make_mesh_train_step(model, tcfg, mesh, comm):
    """The superstep of `make_train_step` on this rank's part of the state
    (`init_mesh_train_state`): (state, batch, step) -> (state, metrics).

    batch leaves are the global [A, B, ...] batch (every rank sees the
    same); the rank takes its agent's rows, split over "replica" where B
    divides (`sharding.train_batch_shardings`). With replica R > 1 the
    agent's params (the rank's tensor-parallel piece) are all-gathered,
    each replica takes the gradient on its rows, weighted by its share of
    the agent's loss-mask tokens, and the gradients are reduce-scattered
    back to the shards. On a model axis above 1 the loss and gradient are
    the rank's slice of the model's (`_rank_model`), every rank of a
    model line on the same rows. The update (`kernels.ops.prox_update`,
    with the global num_agents, since the credit of eq. 12b is divided by
    A) runs on the local shard; the token moves one hop on the agent ring
    (`comm.ring_shift`, between the ranks of one replica and model
    coordinate), leaf by leaf, from a separate receive buffer. Metrics
    are means over the agents. With R = 1 and model parallel 1 every
    rank runs its agent's slice of the one-process step on the same
    shapes, so the state equals the one-process state's slices bitwise
    on one device."""
    from repro_torch.dist.sharding import (gather_shards, local_shard,
                                           restrict, train_batch_shardings)
    from repro_torch.utils.hotpath import hot_loop

    _check_mesh(model, tcfg, mesh)
    a, m = tcfg.num_agents, tcfg.num_walks
    period = a // m
    tau, rho = float(tcfg.tau), float(tcfg.rho)
    accumulate = bool(tcfg.accumulate_between_visits)
    r = mesh.shape.get("replica", 1)
    mp = mesh.shape.get("model", 1)
    shapes = _param_shapes(model)
    specs = state_specs(model, tcfg, mesh, shapes)["params"]
    model = _rank_model(model, mesh, comm)
    # the replica axis's part of each leaf's spec, on the agent's leaf
    rspecs = {k: restrict(s[1:], ("replica",)) for k, s in specs.items()}
    rmesh = {"replica": r}
    comm.reserve(4 * max(v.numel() for v in shapes.values()))
    coords = mesh.coords
    agent = coords["agent"]

    def hop(t):
        return comm.ring_shift(t, "agent")

    def gathered(x, k):
        """The agent's whole leaf [1, ...] from the replicas' shards."""
        if r == 1 or "replica" not in specs[k]:
            return x
        return gather_shards(comm.all_gather(x, "replica"),
                             (None,) + rspecs[k], rmesh)

    def grad_shard(g, k, split_rows, weight):
        """This replica's [1, shard] of the agent's gradient."""
        if r == 1:
            return g[None]
        if not split_rows:          # every replica saw every row
            return local_shard(g, rspecs[k], rmesh, coords)[None]
        g = g.float() * weight
        pieces = [local_shard(g, rspecs[k], rmesh, {"replica": j})
                  for j in range(r)]
        return comm.reduce_scatter(pieces, "replica")[None]

    @hot_loop
    def step_fn(state, batch, step):
        params, token = state["params"], state["token"]
        zhat, gacc = state["zhat"], state["gacc"]
        bspecs = train_batch_shardings(mesh, batch)
        local = {k: local_shard(v, bspecs[k], mesh, coords)[0]
                 for k, v in batch.items()}
        lead = next(iter(batch))
        split_rows = r > 1 and "replica" in bspecs[lead]
        weight = (_row_weight(batch, local, agent, lead) if split_rows
                  else 1.0)

        full = {k: gathered(x, k) for k, x in params.items()}
        grads, (loss, metr) = _grad(model, {k: v[0] for k, v in
                                            full.items()}, local)
        del full

        holders = _token_holders([agent], step, a, period)
        for k, x in params.items():
            g = grad_shard(grads.pop(k), k, split_rows, weight)
            if accumulate:
                gacc[k] += g
                g = gacc[k]
            _update_leaf(x, g, token[k], zhat[k],
                         gacc[k] if accumulate else None, holders, hop,
                         period=period, tau=tau, rho=rho, m=m, a=a)
            del g

        # each replica's share of its agent's loss (1/R of it where every
        # replica saw every row), over the A agents and the mp ranks of a
        # model line, which report the same loss
        share = weight if split_rows else 1.0 / r
        vals = torch.stack([loss, metr["nll"], metr["aux"]]).float()
        vals = comm.all_reduce(vals * share / (a * mp))
        return state, {"loss": vals[0], "nll": vals[1], "aux": vals[2]}

    return step_fn


def make_mesh_dp_baseline_step(model, opt, schedule, mesh, comm):
    """The DP baseline across processes: every rank holds the params and
    the optimizer state of its tensor-parallel piece (`tensor_parallel.
    shard_params`; the whole params on a model axis of 1); the global
    batch [N, ...] (every rank sees the same) splits over the
    data-parallel ranks (agent x replica; every rank of a model line
    takes the same rows), each rank's gradient is weighted by its share
    of the loss-mask tokens (else of the rows) and all-reduced over the
    ranks of its model coordinate, and every rank applies the optimizer
    step to its piece (`optim` is elementwise, so a piece's update is
    the whole update's piece). Returns (params, opt_state, batch, step)
    -> (params, opt_state, metrics)."""
    from repro_torch.dist.sharding import (DATA_LINE, axis_sizes,
                                           batch_shardings, local_shard)

    sizes = axis_sizes(mesh)
    _check_model_axis(model, sizes)
    mp = sizes.get("model", 1)
    dp = mesh.size // mp
    # the ranks of this rank's model coordinate (every rank where mp = 1)
    line = None if mp == 1 else DATA_LINE
    coords = mesh.coords
    model = _rank_model(model, mesh, comm)

    def step_fn(params, opt_state, batch, step):
        rows = batch["tokens"].shape[0]
        if rows % dp:
            raise ValueError(f"a global batch of {rows} rows does not split "
                             f"over {dp} data-parallel ranks")
        specs = batch_shardings(mesh, batch, batch_axes=DATA_LINE)
        local = {k: local_shard(v, specs[k], mesh, coords)
                 for k, v in batch.items()}
        mask = batch.get("loss_mask")
        if dp == 1:
            weight = 1.0
        elif mask is None:
            weight = 1.0 / dp
        else:
            weight = (local["loss_mask"].float().sum()
                      / torch.clamp_min(mask.float().sum(), 1.0))
        grads, (loss, metr) = _grad(model, params, local)
        if dp > 1:
            grads = {k: comm.all_reduce(g.float() * weight, line).to(g.dtype)
                     for k, g in grads.items()}
        params, opt_state = _optimizer_step(opt, schedule, params,
                                            opt_state, grads, step)
        # every rank of a model line reports the same loss
        vals = torch.stack([loss, metr["nll"], metr["aux"]]).float()
        vals = comm.all_reduce(vals * weight / mp)
        return params, opt_state, {"loss": vals[0], "nll": vals[1],
                                   "aux": vals[2]}

    return step_fn
