"""Incremental decentralized methods: I-BCD (Alg. 1), API-BCD (Alg. 2),
gAPI-BCD, in float64 torch on an explicit device (the port of
`repro/core/methods.py`).

All methods share a common token-walk interface consumed by both the serial
driver (`repro_torch.core.driver`) and the asynchronous event-driven
simulator (`repro_torch.core.simulator`): a method holds per-agent models
x_i, M tokens z_m, and (for API-BCD) per-agent local token copies
zhat_{i,m}; `update(state, agent, walk)` executes one activation — steps
3-6 of Alg. 1 / Alg. 2.

State tensors live on the method's device and an update reads nothing
back to the host. `state_from_numpy` / `state_to_numpy` carry a state
to and from the reference's numpy `MethodState`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import losses as L
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class MethodState:
    """Mutable algorithm state (copied on update; tensors are replaced)."""

    xs: torch.Tensor            # [N, p] local models x_i
    tokens: torch.Tensor        # [M, p] token values z_m
    zhat: Optional[torch.Tensor] = None   # [N, M, p] local copies (API-BCD)
    iteration: int = 0
    # staleness accounting: how many updates consumed an explicitly
    # supplied (possibly-stale) token_view rather than the in-state
    # tokens.  Telemetry only — it must never feed back into numerics,
    # so zero-delay views stay bitwise-identical to the default entry
    # points.
    view_updates: int = 0

    def copy(self) -> "MethodState":
        return MethodState(
            xs=self.xs.clone(),
            tokens=self.tokens.clone(),
            zhat=None if self.zhat is None else self.zhat.clone(),
            iteration=self.iteration,
            view_updates=self.view_updates,
        )


def state_from_numpy(ms, device="cuda") -> MethodState:
    """The port's state from one with numpy arrays (the reference's
    `MethodState`, or anything with its fields), bit for bit."""
    device = resolve_device(device)

    def put(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=L.F64, device=device)

    return MethodState(xs=put(ms.xs), tokens=put(ms.tokens),
                       zhat=put(ms.zhat), iteration=int(ms.iteration),
                       view_updates=int(ms.view_updates))


def state_to_numpy(state: MethodState) -> dict:
    """{field: value} with numpy arrays: the reference's
    `MethodState(**state_to_numpy(state))` holds the same bits."""
    def get(t):
        return None if t is None else t.detach().cpu().numpy()

    return {"xs": get(state.xs), "tokens": get(state.tokens),
            "zhat": get(state.zhat), "iteration": state.iteration,
            "view_updates": state.view_updates}


class IncrementalMethod:
    """Base class for token-walk methods."""

    name: str = "base"

    def __init__(self, problem: L.Problem, num_walks: int = 1,
                 device="cuda"):
        self.problem = problem
        self.num_walks = num_walks
        self.device = resolve_device(device)

    def init(self) -> MethodState:
        """Initialization per Alg. 1/2 step 1: x_i^0 = 0, z_m^0 = 0.

        This satisfies the required token initialization (6):
        z^0 = (1/N) sum_i x_i^0 = 0, and keeps the invariant
        z_m^k = (1/N) sum_i x_i^k under the incremental update (8)/(12b).
        """
        n, p = self.problem.num_agents, self.problem.dim
        m = self.num_walks
        zeros = dict(dtype=L.F64, device=self.device)
        zhat = torch.zeros((n, m, p), **zeros) if self.uses_local_copies \
            else None
        return MethodState(xs=torch.zeros((n, p), **zeros),
                           tokens=torch.zeros((m, p), **zeros), zhat=zhat)

    uses_local_copies: bool = False

    def update(self, state: MethodState, agent: int, walk: int) -> MethodState:
        raise NotImplementedError

    def _view(self, state: MethodState, token_view) -> torch.Tensor:
        """The token values the agent receives: `state.tokens`, or the
        supplied (possibly-stale) `token_view`, counted in view_updates."""
        if token_view is None:
            return state.tokens
        state.view_updates += 1
        return torch.as_tensor(token_view, dtype=L.F64, device=self.device)

    def model_estimate(self, state: MethodState) -> torch.Tensor:
        """Global model estimate: mean_i x_i.

        For M=1 this equals the token exactly (invariant of eq. (8));
        for physical API-BCD it equals sum_m z_m (each delta is credited
        to exactly one token, eq. (12b)), which is the consensus model —
        averaging tokens would under-scale by 1/M.
        """
        return state.xs.mean(dim=0)

    def flops_per_update(self) -> float:
        """Rough per-activation compute cost (for the time simulator;
        host arithmetic, as the reference's)."""
        # default: one pass over the local data, 2*d*p flops for grad-like work
        d = int(np.mean([f.shape[0] for f in self.problem.features]))
        return 4.0 * d * self.problem.dim


class IBCD(IncrementalMethod):
    """Incremental BCD — Algorithm 1.

    Single token (M=1); the active agent solves the exact proximal
    subproblem (7) and applies the incremental token update (8).
    """

    name = "I-BCD"

    def __init__(self, problem: L.Problem, tau: float, newton_steps: int = 20,
                 device="cuda"):
        super().__init__(problem, num_walks=1, device=device)
        self.tau = tau
        self._prox = L.make_batched_prox_solver(problem, tau, 1, newton_steps,
                                                self.device)

    def update(self, state: MethodState, agent: int, walk: int = 0) -> MethodState:
        n = self.problem.num_agents
        s = state.copy()
        z = s.tokens[0]
        x_old = s.xs[agent].clone()
        x_new = self._prox(agent, z, x_old)
        s.xs[agent] = x_new
        s.tokens[0] = z + (x_new - x_old) / n          # eq. (8)
        s.iteration += 1
        return s

    def flops_per_update(self) -> float:
        # exact prox: cholesky solve ~ p^2, plus data pass
        d = int(np.mean([f.shape[0] for f in self.problem.features]))
        p = self.problem.dim
        return 2.0 * d * p + 2.0 * p * p


class APIBCD(IncrementalMethod):
    """Asynchronous Parallel Incremental BCD — Algorithm 2.

    M tokens walk in parallel; each agent keeps local copies zhat_{i,m} of
    every token. On activation by token m (steps 3-6):
      zhat_{i,m} <- z_m (received token)               step 3
      x_i <- argmin f_i + (tau/2) sum_m ||x - zhat_{i,m}||^2   (12a)
      z_m <- z_m + (x_i_new - x_i_old)/N               (12b)
      zhat_{i,m} <- z_m^{new}                          (12c)
    """

    name = "API-BCD"
    uses_local_copies = True

    def __init__(self, problem: L.Problem, tau: float, num_walks: int,
                 newton_steps: int = 20, device="cuda"):
        super().__init__(problem, num_walks=num_walks, device=device)
        self.tau = tau
        self._prox = L.make_batched_prox_solver(
            problem, tau, num_walks, newton_steps, self.device)

    def update(self, state: MethodState, agent: int, walk: int,
               token_view=None) -> MethodState:
        """One activation.  ``token_view`` (the staleness-aware entry
        point) is the [M, p] token values the agent *receives* in step 3
        — a possibly-stale replica of the shared estimate.  ``None`` means
        zero delay (the agent sees ``state.tokens``): passing a bitwise
        copy of ``state.tokens`` is bitwise-equivalent to the default."""
        n = self.problem.num_agents
        s = state.copy()
        view = self._view(s, token_view)
        s.zhat[agent, walk] = view[walk]                # step 3: receive token
        z_sum = s.zhat[agent].sum(dim=0)
        x_old = s.xs[agent].clone()
        x_new = self._prox(agent, z_sum, x_old)
        s.xs[agent] = x_new                              # (12a)
        s.tokens[walk] = view[walk] + (x_new - x_old) / n       # (12b)
        s.zhat[agent, walk] = s.tokens[walk]             # (12c)
        s.iteration += 1
        return s

    def update_fresh(self, state: MethodState, agent: int,
                     token_view=None) -> MethodState:
        """Fresh-token synchronous logical view — the setting of Theorem 2.

        All agents share fresh tokens (zhat_{i,m} = z_m for all i), and the
        incremental update (12b) is applied to every token m in M (as in the
        proof's identity (e), which requires z_m^{k+1} = mean_i x_i^{k+1}
        for all m). ``token_view`` substitutes a possibly-stale received
        estimate for ``state.tokens`` (delay-0 view is bitwise-equivalent
        to default).
        """
        n = self.problem.num_agents
        s = state.copy()
        view = self._view(s, token_view)
        s.zhat[:] = view[None, :, :]
        z_sum = view.sum(dim=0)
        x_old = s.xs[agent].clone()
        x_new = self._prox(agent, z_sum, x_old)
        s.xs[agent] = x_new
        s.tokens = view + (x_new - x_old)[None, :] / n          # (12b) all m
        s.zhat[:] = s.tokens[None, :, :]
        s.iteration += 1
        return s

    def flops_per_update(self) -> float:
        d = int(np.mean([f.shape[0] for f in self.problem.features]))
        p = self.problem.dim
        return 2.0 * d * p + 2.0 * p * p


class GAPIBCD(IncrementalMethod):
    """Gradient-based API-BCD (Remark 1, eq. 15).

    First-order surrogate + proximal term rho; closed-form update
        x_i <- (rho x_i - grad f_i(x_i) + tau sum_m zhat_{i,m}) / (rho + tau M)
    which needs one gradient instead of an inner solve. Thm 3 requires
    tau*M/2 + rho - L/2 >= 0 for descent. The update is plain float64
    torch, as the reference's is numpy; the f32 `prox_update` kernel of
    the language-model trainer computes the same formula but is not used.
    """

    name = "gAPI-BCD"
    uses_local_copies = True

    def __init__(self, problem: L.Problem, tau: float, num_walks: int,
                 rho: float, device="cuda"):
        super().__init__(problem, num_walks=num_walks, device=device)
        self.tau = tau
        self.rho = rho
        self._grad = L.make_batched_local_grad(problem, self.device)

    def _step(self, agent, x_old, z_sum):
        g = self._grad(agent, x_old)
        m = self.num_walks
        return ((self.rho * x_old - g + self.tau * z_sum)
                / (self.rho + self.tau * m))             # (15) closed form

    def update(self, state: MethodState, agent: int, walk: int,
               token_view=None) -> MethodState:
        """One activation; ``token_view`` as in `APIBCD.update` (the
        possibly-stale received token values, default zero-delay)."""
        n = self.problem.num_agents
        s = state.copy()
        view = self._view(s, token_view)
        s.zhat[agent, walk] = view[walk]
        z_sum = s.zhat[agent].sum(dim=0)
        x_old = s.xs[agent].clone()
        x_new = self._step(agent, x_old, z_sum)
        s.xs[agent] = x_new
        s.tokens[walk] = view[walk] + (x_new - x_old) / n
        s.zhat[agent, walk] = s.tokens[walk]
        s.iteration += 1
        return s

    def update_fresh(self, state: MethodState, agent: int,
                     token_view=None) -> MethodState:
        """Fresh-token logical view for gAPI-BCD — the setting of Theorem 3.
        ``token_view`` as in `APIBCD.update_fresh`."""
        n = self.problem.num_agents
        s = state.copy()
        view = self._view(s, token_view)
        s.zhat[:] = view[None, :, :]
        z_sum = view.sum(dim=0)
        x_old = s.xs[agent].clone()
        x_new = self._step(agent, x_old, z_sum)
        s.xs[agent] = x_new
        s.tokens = view + (x_new - x_old)[None, :] / n
        s.zhat[:] = s.tokens[None, :, :]
        s.iteration += 1
        return s

    def flops_per_update(self) -> float:
        d = int(np.mean([f.shape[0] for f in self.problem.features]))
        return 4.0 * d * self.problem.dim
