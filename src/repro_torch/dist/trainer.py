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
every leaf, cut to its "replica" shard (`dist.sharding`), and runs the
same superstep on it; the token hop is `dist.collectives.ring_shift`,
point-to-point sends where the reference has ppermute.
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
    if sizes.get("model", 1) != 1:
        from repro_torch.dist.tensor_parallel import TP_TRAINING

        raise NotImplementedError(
            "a model axis above 1 (tensor parallelism) in training is "
            f"{TP_TRAINING}; train with model parallel 1 (serving runs "
            "it: launch.serve_mesh)")
    cfg = getattr(model, "cfg", None)
    if sizes.get("replica", 1) > 1 and cfg is not None and cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: replica > 1 with MoE layers is not supported: the "
            "GShard capacity and the load-balance loss are statistics of "
            "the whole batch, which a split of an agent's rows changes; run "
            "it with replica 1")


def init_mesh_train_state(model, tcfg, mesh, generator):
    """This rank's part of `init_train_state`: its agent slot of every
    leaf, cut to its "replica" shard by `sharding.state_shardings`
    (leaves [1, ...], zhat [1, M, ...]). Every rank draws the same
    `model.init(generator)` and keeps its own piece, so the pieces of all
    ranks make up the one-process state (tokens start at 0)."""
    from repro_torch.dist.sharding import local_shard, state_shardings

    _check_mesh(model, tcfg, mesh)
    a, m = tcfg.num_agents, tcfg.num_walks
    p0 = model.init(generator)
    specs = state_shardings(mesh, _state_shapes(p0, tcfg))
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


def superstep_sends(param_shapes, mesh, rows_per_agent, metrics=3):
    """[{kind: bytes} for each rank]: what `make_mesh_train_step`'s
    superstep makes each rank send, reckoned from the leaf shapes and the
    mesh's axes: per leaf, the all_gather of its params (R - 1 pieces of
    its shard, where "replica" splits it), the reduce_scatter of its f32
    gradient (R - 1 pieces, where the agent's rows split over "replica")
    and the ring_shift of its f32 token shard (where A > 1); and the
    all_reduce of the `metrics` f32 means over every rank."""
    import math

    from repro_torch.dist.sharding import (axis_sizes, param_shardings,
                                           shard_shape)

    sizes = axis_sizes(mesh)
    a, r = sizes["agent"], sizes.get("replica", 1)
    world = math.prod(sizes.values())
    stacked = {k: (a,) + tuple(v.shape) for k, v in param_shapes.items()}
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
    out = []
    pieces = [int(p.numel()) for p in torch.empty(metrics).tensor_split(
        world)] if world > 1 else [0]
    for rank in range(world):
        sends = {k: v for k, v in per_rank.items() if v}
        if world > 1:         # the reduce_scatter, then the all_gather
            sends["all_reduce"] = 4 * (metrics - pieces[rank]
                                       + (world - 1) * pieces[rank])
        out.append(sends)
    return out


def mesh_collective_bytes(param_shapes, mesh, rows_per_agent, metrics=3):
    """The bytes every rank of the mesh sends in one superstep, summed: the
    `collective_bytes` of the superstep's `utils.roofline.Roofline`."""
    return sum(sum(s.values()) for s in superstep_sends(
        param_shapes, mesh, rows_per_agent, metrics))


def make_mesh_train_step(model, tcfg, mesh, comm):
    """The superstep of `make_train_step` on this rank's part of the state
    (`init_mesh_train_state`): (state, batch, step) -> (state, metrics).

    batch leaves are the global [A, B, ...] batch (every rank sees the
    same); the rank takes its agent's rows, split over "replica" where B
    divides (`sharding.train_batch_shardings`). With replica R > 1 the
    agent's params are all-gathered, each replica takes the gradient on
    its rows, weighted by its share of the agent's loss-mask tokens, and
    the gradients are reduce-scattered back to the shards. The update
    (`kernels.ops.prox_update`, with the global num_agents, since the
    credit of eq. 12b is divided by A) runs on the local shard; the token
    moves one hop on the agent ring (`comm.ring_shift`), leaf by leaf,
    from a separate receive buffer. Metrics are means over the agents.
    With R = 1 every rank runs its agent's slice of the one-process step
    on the same shapes, so the state equals the one-process state's
    slices bitwise on one device."""
    from repro_torch.dist.sharding import (gather_shards, local_shard,
                                           restrict, state_shardings,
                                           train_batch_shardings)
    from repro_torch.utils.hotpath import hot_loop

    _check_mesh(model, tcfg, mesh)
    a, m = tcfg.num_agents, tcfg.num_walks
    period = a // m
    tau, rho = float(tcfg.tau), float(tcfg.rho)
    accumulate = bool(tcfg.accumulate_between_visits)
    r = mesh.shape.get("replica", 1)
    shapes = _param_shapes(model)
    specs = state_shardings(mesh, _state_shapes(shapes, tcfg))["params"]
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
        # replica saw every row), over the A agents
        share = weight if split_rows else 1.0 / r
        vals = torch.stack([loss, metr["nll"], metr["aux"]]).float()
        vals = comm.all_reduce(vals * share / a)
        return state, {"loss": vals[0], "nll": vals[1], "aux": vals[2]}

    return step_fn


def make_mesh_dp_baseline_step(model, opt, schedule, mesh, comm):
    """The DP baseline across processes: every rank holds the whole params
    and the optimizer state; the global batch [N, ...] (every rank sees
    the same) splits over all ranks, each rank's gradient is weighted by
    its share of the loss-mask tokens (else of the rows) and all-reduced,
    and every rank applies the same optimizer step. Returns (params,
    opt_state, batch, step) -> (params, opt_state, metrics)."""
    from repro_torch.dist.sharding import batch_shardings, local_shard

    world = mesh.size
    axes = mesh.axis_names
    coords = mesh.coords

    def step_fn(params, opt_state, batch, step):
        rows = batch["tokens"].shape[0]
        if rows % world:
            raise ValueError(f"a global batch of {rows} rows does not split "
                             f"over {world} ranks")
        specs = batch_shardings(mesh, batch, batch_axes=axes)
        local = {k: local_shard(v, specs[k], mesh, coords)
                 for k, v in batch.items()}
        mask = batch.get("loss_mask")
        if world == 1:
            weight = 1.0
        elif mask is None:
            weight = 1.0 / world
        else:
            weight = (local["loss_mask"].float().sum()
                      / torch.clamp_min(mask.float().sum(), 1.0))
        grads, (loss, metr) = _grad(model, params, local)
        if world > 1:
            grads = {k: comm.all_reduce(g.float() * weight).to(g.dtype)
                     for k, g in grads.items()}
        params, opt_state = _optimizer_step(opt, schedule, params,
                                            opt_state, grads, step)
        vals = torch.stack([loss, metr["nll"], metr["aux"]]).float()
        vals = comm.all_reduce(vals * weight)
        return params, opt_state, {"loss": vals[0], "nll": vals[1],
                                   "aux": vals[2]}

    return step_fn
