"""Baselines the paper compares against (and the centralized reference),
in float64 torch on an explicit device (the port of
`repro/core/baselines.py`).

* WPG (Mao, Gu, Yin [17]) — walk proximal gradient, the paper's main
  comparison (eq. 19): the token z walks a Hamiltonian cycle; the active
  agent takes a gradient step from z and updates z incrementally.
* DGD (Yuan, Ling, Yin [12]) — synchronous gossip: every agent exchanges
  with every neighbour each round (high communication — the regime the
  incremental methods are designed to beat).
* Centralized prox (eqs. 4-5) — the parameter-server reference solution
  used as ground truth in tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import losses as L
from repro_torch.core.methods import IncrementalMethod, MethodState
from repro_torch.utils.device import resolve_device


class WPG(IncrementalMethod):
    """Walk Proximal Gradient (eq. 19) — single token, gradient update."""

    name = "WPG"

    def __init__(self, problem: L.Problem, alpha: float, device="cuda"):
        super().__init__(problem, num_walks=1, device=device)
        self.alpha = alpha
        self._grad = L.make_batched_local_grad(problem, self.device)

    def update(self, state: MethodState, agent: int, walk: int = 0) -> MethodState:
        n = self.problem.num_agents
        s = state.copy()
        z = s.tokens[0]
        x_old = s.xs[agent].clone()
        g = self._grad(agent, z)
        x_new = z - self.alpha * g                       # eq. (19) top
        s.xs[agent] = x_new
        s.tokens[0] = z + (x_new - x_old) / n            # eq. (19) bottom
        s.iteration += 1
        return s


class DGD:
    """Decentralized gradient descent (gossip): x <- W x - alpha * grad.

    Synchronous: all agents and all links are active every round. Uses the
    Metropolis-Hastings mixing matrix. Not an IncrementalMethod — the
    simulator treats it as a synchronous round-based method where each round
    costs 2|E| communication units (unicast per directed link, as in the
    paper's cost model). A round takes the N gradients in one batch over
    the stacked shards (the reference loops over the agents).
    """

    name = "DGD"

    def __init__(self, problem: L.Problem, alpha: float, mixing: np.ndarray,
                 device="cuda"):
        self.problem = problem
        self.alpha = alpha
        self.device = resolve_device(device)
        self.mixing = torch.as_tensor(np.asarray(mixing), dtype=L.F64,
                                      device=self.device)
        self._shards = L.stacked_shards(problem, self.device)

    def init(self) -> torch.Tensor:
        return torch.zeros((self.problem.num_agents, self.problem.dim),
                           dtype=L.F64, device=self.device)

    def round(self, xs: torch.Tensor) -> torch.Tensor:
        mixed = self.mixing @ xs
        grads = L.shard_grad(self._shards, xs)
        return mixed - self.alpha * grads

    def model_estimate(self, xs: torch.Tensor) -> torch.Tensor:
        return xs.mean(dim=0)

    def flops_per_update(self) -> float:
        d = int(np.mean([f.shape[0] for f in self.problem.features]))
        return 4.0 * d * self.problem.dim


def _inverses(problem: L.Problem, tm: float, device):
    """(H_i + tau*M I)^{-1} [N, p, p] and (H_i + tau*M I)^{-1} c_i [N, p],
    H_i = A_i^T A_i / d_i, c_i = A_i^T b_i / d_i."""
    shards = L.stacked_shards(problem, device)
    eye = torch.eye(problem.dim, dtype=L.F64, device=device)
    invs = torch.linalg.inv(shards.gram() + tm * eye)
    ics = (invs @ shards.moment().unsqueeze(-1)).squeeze(-1)
    return invs, ics, eye


def penalized_solution(problem: L.Problem, tau: float,
                       num_tokens: int = 1, device="cuda"):
    """Exact minimizer (x*, z*) of the penalty objective F (eq. 3 / eq. 10).

    Least-squares only. Stationarity (all tokens equal at the optimum):
        (H_i + tau*M I) x_i = c_i + tau*M z,   z = mean_i x_i,
    with H_i = A_i^T A_i / d_i, c_i = A_i^T b_i / d_i. Eliminating x_i:
        z = [I - tau*M * mean_i (H_i+tau*M I)^{-1}]^{-1}
              mean_i (H_i+tau*M I)^{-1} c_i.
    Returns (xs [N,p], z [p]).
    """
    assert problem.kind == "lsq"
    tm = tau * num_tokens
    invs, ics, eye = _inverses(problem, tm, resolve_device(device))
    z = torch.linalg.solve(eye - tm * invs.mean(dim=0), ics.mean(dim=0))
    # x_i = (H_i + tau*M I)^{-1} (c_i + tau*M z) = ics_i + tau*M * hinv_i z
    xs = ics + tm * (invs @ z)
    return xs, z


def apibcd_stale_fixed_point(problem: L.Problem, tau: float,
                             num_tokens: int, device="cuda"):
    """Exact fixed point of *physical* API-BCD (stale local copies).

    With zero initialization, every x-delta is credited to exactly one
    token, so sum_m z_m tracks mean_i x_i exactly (telescoping eq. 12b).
    At the fixed point therefore
        x_i = (H_i + tau*M I)^{-1} (c_i + tau * zbar),  zbar = mean_i x_i,
    i.e. the consensus pull is tau (not tau*M) while the ridge is tau*M.
    This differs from the minimizer of F (eq. 10) — the gap the paper's
    Remark 2 alludes to, and the reason the paper tunes tau_API << tau_IS
    (their experiments use tau_API-BCD = 0.1 with K = 5 walks).
    Least-squares only. Returns (xs [N,p], zbar [p]).
    """
    assert problem.kind == "lsq"
    invs, ics, eye = _inverses(problem, tau * num_tokens,
                               resolve_device(device))
    zbar = torch.linalg.solve(eye - tau * invs.mean(dim=0), ics.mean(dim=0))
    xs = ics + tau * (invs @ zbar)
    return xs, zbar


def centralized_solution(problem: L.Problem, tau: float = None,
                         iters: int = 2000, lr: float = None,
                         device="cuda") -> torch.Tensor:
    """Reference minimizer of problem (1): min_x sum_i f_i(x).

    Closed form for least squares; full-batch Newton for logistic/softmax
    (60 steps, CG up to 50 iterations on the Hessian + 1e-8 I, stopping
    once ||grad|| < 1e-9: one host read a step).
    """
    device = resolve_device(device)
    shards = L.stacked_shards(problem, device)
    n = problem.num_agents
    if problem.kind == "lsq":
        # tiny ridge for numerical safety (rank-deficient synthetic data)
        gram = shards.gram().sum(dim=0) + 1e-9 * torch.eye(
            problem.dim, dtype=L.F64, device=device)
        return torch.linalg.solve(gram, shards.moment().sum(dim=0))

    x = torch.zeros(problem.dim, dtype=L.F64, device=device)
    for _ in range(60):  # Newton via CG on the true Hessian
        g = L.shard_grad(shards, x.expand(n, -1)).sum(dim=0)
        h = L.shard_hvp(shards, x.expand(n, -1))
        step = L.cg(lambda v: h(v.expand(n, -1)).sum(dim=0) + 1e-8 * v, g,
                    maxiter=50)
        x = x - step
        if float(torch.linalg.norm(g)) < 1e-9:
            break
    return x
