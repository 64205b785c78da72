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

        rel = [(i - step) % a for i in range(a)]
        active = [i for i in range(a) if rel[i] % period == 0]
        walk_id = {i: rel[i] // period for i in active}

        for k, x in params.items():
            # mean over the visit period (steady-state visit interval)
            g_eff = grads[k] / period if accumulate else grads[k]
            zsum = zhat[k].sum(dim=1)
            x_full, d_full = ops.prox_update(
                x, g_eff, zsum, tau=tau, rho=rho, num_walks=m, num_agents=a)
            del g_eff, zsum
            tok = token[k]
            # only token-holding agents move; the others stay bit-identical
            for i in active:
                x[i] = x_full[i]
                tok[i] += d_full[i]
                zhat[k][i, walk_id[i]] = tok[i]      # (12c)
                if accumulate:
                    gacc[k][i] = 0.0
            del x_full, d_full
            tok.copy_(torch.roll(tok, shifts=1, dims=0))

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
    from repro_torch.optim.optimizers import apply_updates

    def step_fn(params, opt_state, batch, step):
        grads, (loss, metr) = _grad(model, params, batch)
        lr = schedule(step)
        updates, opt_state = opt.update(grads, opt_state, params, lr)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **metr}

    return step_fn
