"""Local losses f_i, exact proximal solvers and evaluation metrics, in
float64 torch on an explicit device (the port of `repro/core/losses.py`).

The paper's experiments cover two convex task families:
  * least squares (linear regression; cpusmall, cadata) — NMSE metric,
  * (multinomial) logistic regression (ijcnn1, USPS) — accuracy metric.

f_i(x) = (1/d_i) sum_l loss(x; xi_{i,l})  over the agent's local shard.

For I-BCD / API-BCD the x-update is the proximal subproblem
    argmin_x f_i(x) + (tau/2) sum_m ||x - z_m||^2           (eqs. 7, 12a)
which for least squares has the closed form
    (A^T A / d + tau*M I) x = A^T b / d + tau * sum_m z_m
and for logistic losses is solved by Newton iterations with
Hessian-vector conjugate gradients (as the reference: 20 Newton steps, at
most 20 CG iterations each, no damping). gAPI-BCD (eq. 15) avoids the
sub-solve entirely.

The gradients and Hessian-vector products are closed forms, where the
reference differentiates with `jax.grad` / `jax.jvp`. The CG runs
`jax.scipy.sparse.linalg.cg`'s iteration as a fixed number of steps that
stand still once converged, so a prox makes no host sync.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class Problem:
    """A decentralized convex learning problem (numpy shards, as the
    reference's; each callable built from it puts them on its device).

    Attributes:
      kind: 'lsq' | 'logistic' | 'softmax'.
      features: list/array of per-agent design matrices A_i [d_i, p_in].
      targets:  per-agent targets b_i ([d_i] reals or int labels).
      dim: model dimension p (p_in for lsq/logistic, p_in*classes for softmax).
      num_classes: for 'softmax'.
      test_features / test_targets: held-out global test set.
    """

    kind: str
    features: tuple
    targets: tuple
    dim: int
    num_classes: int = 2
    test_features: Optional[np.ndarray] = None
    test_targets: Optional[np.ndarray] = None

    @property
    def num_agents(self) -> int:
        return len(self.features)


def _features(a, device):
    return torch.as_tensor(np.asarray(a), dtype=F64, device=device)


def _targets(problem: Problem, t, device):
    """Targets on the device: int64 class labels for softmax, else f64."""
    dtype = torch.int64 if problem.kind == "softmax" else F64
    return torch.as_tensor(np.asarray(t), device=device).to(dtype)


# ---------------------------------------------------------------------------
# per-sample losses
# ---------------------------------------------------------------------------


def _lsq_loss(x, a, b):
    r = a @ x - b
    return 0.5 * torch.mean(r * r)


def _logistic_loss(x, a, y):
    """y in {-1, +1}; mean logistic loss (logaddexp, as the reference:
    softplus turns linear past its threshold)."""
    margins = y * (a @ x)
    return torch.mean(torch.logaddexp(torch.zeros_like(margins), -margins))


def _softmax_loss(x, a, y, num_classes):
    w = x.reshape(a.shape[1], num_classes)
    logits = a @ w
    logz = torch.logsumexp(logits, dim=1)
    ll = logits[torch.arange(a.shape[0], device=a.device), y] - logz
    return -torch.mean(ll)


def make_local_loss(problem: Problem, agent: int,
                    device="cuda") -> Callable:
    """Returns f_i: R^p -> R for agent i (closed over its data on
    `device`)."""
    device = resolve_device(device)
    a = _features(problem.features[agent], device)
    b = _targets(problem, problem.targets[agent], device)
    if problem.kind == "lsq":
        return partial(_lsq_loss, a=a, b=b)
    if problem.kind == "logistic":
        return partial(_logistic_loss, a=a, y=b)
    if problem.kind == "softmax":
        return partial(_softmax_loss, a=a, y=b,
                       num_classes=problem.num_classes)
    raise ValueError(problem.kind)


def global_objective(problem: Problem, x: torch.Tensor) -> torch.Tensor:
    """sum_i f_i(x) — the objective of problem (1), on x's device."""
    total = 0.0
    for i in range(problem.num_agents):
        total = total + make_local_loss(problem, i, x.device)(x)
    return total


def penalty_objective(problem: Problem, xs: torch.Tensor, zs: torch.Tensor,
                      tau: float) -> torch.Tensor:
    """F(x, z) of eq. (3) (M=1) / eq. (10) (general M), on xs's device.

    xs: [N, p] local models; zs: [M, p] tokens.
    """
    zs = torch.atleast_2d(zs)
    total = 0.0
    for i in range(problem.num_agents):
        total = total + make_local_loss(problem, i, xs.device)(xs[i])
    pen = 0.5 * tau * torch.sum((xs[:, None, :] - zs[None, :, :]) ** 2)
    return total + pen


# ---------------------------------------------------------------------------
# batched (agent-indexed) losses: the shards stacked once on the device
# ---------------------------------------------------------------------------


def _stacked_data(problem: Problem, device):
    """Pad per-agent shards to a common row count and stack on `device`.

    Returns (features [N, dmax, p], targets [N, dmax], mask [N, dmax],
    counts [N]).  `np.array_split` shards differ by at most one row, so
    the padding overhead is negligible.  Padded feature rows are zero;
    padded targets are 0 (masked out where the per-sample loss of a zero
    row is nonzero).
    """
    n = problem.num_agents
    dmax = max(f.shape[0] for f in problem.features)
    p = problem.features[0].shape[1]
    tgt_dtype = np.asarray(problem.targets[0]).dtype
    feats = np.zeros((n, dmax, p))
    targs = np.zeros((n, dmax), dtype=tgt_dtype)
    mask = np.zeros((n, dmax))
    for i, (f, t) in enumerate(zip(problem.features, problem.targets)):
        d = f.shape[0]
        feats[i, :d] = f
        targs[i, :d] = t
        mask[i, :d] = 1.0
    counts = np.array([f.shape[0] for f in problem.features], dtype=float)
    return (_features(feats, device), _targets(problem, targs, device),
            _features(mask, device), _features(counts, device))


@dataclasses.dataclass(frozen=True)
class Shards:
    """The stacked shards in the form the closed forms take: `a` [N, d,
    p], `y` [N, d] (softmax: one-hot [N, d, C]) and the row weights `w` =
    mask / count [N, d], so a padded row weighs 0 in every kind (for
    softmax it reads class 0 in the one-hot, as the reference's gather
    does, and the weight removes it). `shards[i]` is agent i's."""

    kind: str
    a: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor

    def __getitem__(self, agent):
        return Shards(self.kind, self.a[agent], self.y[agent], self.w[agent])

    def gram(self):
        """A^T A / d per agent (lsq's H_i)."""
        return self.a.transpose(-1, -2) @ (self.w.unsqueeze(-1) * self.a)

    def moment(self):
        """A^T b / d per agent (lsq's c_i)."""
        return _atr(self.a, self.w * self.y)


def stacked_shards(problem: Problem, device="cuda") -> Shards:
    """The problem's shards, stacked once on `device`."""
    device = resolve_device(device)
    feats, targs, mask, counts = _stacked_data(problem, device)
    if problem.kind == "softmax":
        targs = torch.nn.functional.one_hot(
            targs, problem.num_classes).to(F64)
    return Shards(problem.kind, feats, targs, mask / counts[:, None])


def _ax(a, x):
    """A x over the rows, under any leading agent dims (one agent's is one
    matrix-vector product)."""
    return a @ x if x.dim() == 1 else (a @ x.unsqueeze(-1)).squeeze(-1)


def _atr(a, r):
    """A^T r, under any leading agent dims."""
    return r @ a if r.dim() == 1 else (r.unsqueeze(-2) @ a).squeeze(-2)


def _weights(shards: Shards, x):
    """W = x as [..., p_in, C] (softmax)."""
    return x.reshape(x.shape[:-1] + (shards.a.shape[-1], shards.y.shape[-1]))


def shard_loss(shards: Shards, x):
    """f(x) = sum_rows w * loss, per agent of `shards` (batched or one)."""
    a, y, w = shards.a, shards.y, shards.w
    if shards.kind == "lsq":
        r = _ax(a, x) - y                  # padded rows: 0 @ x - 0 = 0
        return 0.5 * (w * r * r).sum(-1)
    if shards.kind == "logistic":
        margins = y * _ax(a, x)
        return (w * torch.logaddexp(torch.zeros_like(margins),
                                    -margins)).sum(-1)
    if shards.kind == "softmax":
        logits = a @ _weights(shards, x)
        ll = (logits * y).sum(-1) - torch.logsumexp(logits, dim=-1)
        return -(w * ll).sum(-1)
    raise ValueError(shards.kind)


def shard_grad(shards: Shards, x):
    """grad f(x) in closed form, per agent of `shards`."""
    a, y, w = shards.a, shards.y, shards.w
    if shards.kind == "lsq":
        return _atr(a, w * (_ax(a, x) - y))
    if shards.kind == "logistic":
        # d/dt logaddexp(0, -t) = -sigmoid(-t)
        return _atr(a, -(w * y) * torch.sigmoid(-y * _ax(a, x)))
    if shards.kind == "softmax":
        p = torch.softmax(a @ _weights(shards, x), dim=-1)
        g = a.transpose(-1, -2) @ (w.unsqueeze(-1) * (p - y))
        return g.flatten(-2)
    raise ValueError(shards.kind)


def shard_hvp(shards: Shards, x) -> Callable:
    """v -> (Hessian of f at x) v, in closed form, per agent of `shards`;
    what depends on x alone is computed once here."""
    a, y, w = shards.a, shards.y, shards.w
    if shards.kind == "lsq":
        return lambda v: _atr(a, w * _ax(a, v))
    if shards.kind == "logistic":
        t = y * _ax(a, x)
        # d^2/dt^2 logaddexp(0, -t) = sigmoid(t) sigmoid(-t); y^2 = 1 on a
        # live row, 0 on a padded one
        h = w * y * y * torch.sigmoid(t) * torch.sigmoid(-t)
        return lambda v: _atr(a, h * _ax(a, v))
    if shards.kind == "softmax":
        p = torch.softmax(a @ _weights(shards, x), dim=-1)
        wp = w.unsqueeze(-1) * p
        at = a.transpose(-1, -2)

        def hvp(v):
            u = a @ _weights(shards, v)
            return (at @ (wp * (u - (p * u).sum(-1, keepdim=True)))
                    ).flatten(-2)
        return hvp
    raise ValueError(shards.kind)


def make_batched_local_loss(problem: Problem, device="cuda") -> Callable:
    """Returns f(agent, x) -> f_agent(x) over the shards stacked once on
    `device`. Matches `make_local_loss(problem, i)(x)` to round-off
    (padded rows contribute 0)."""
    shards = stacked_shards(problem, device)
    return lambda agent, x: shard_loss(shards[agent], x)


def make_batched_local_grad(problem: Problem, device="cuda") -> Callable:
    """Returns g(agent, x) -> grad f_agent(x) (the reference's
    `jax.grad(make_batched_local_loss(problem), argnums=1)`)."""
    shards = stacked_shards(problem, device)
    return lambda agent, x: shard_grad(shards[agent], x)


# ---------------------------------------------------------------------------
# proximal solvers:  argmin_x f_i(x) + (tau/2) sum_m ||x - z_m||^2
# ---------------------------------------------------------------------------


def cg(hvp: Callable, b: torch.Tensor, maxiter: int,
       tol: float = 1e-5) -> torch.Tensor:
    """`jax.scipy.sparse.linalg.cg(hvp, b, maxiter=maxiter)` (x0 = 0, tol
    1e-5, atol 0) as `maxiter` fixed iterations with no host sync.

    JAX iterates while r.r > tol^2 b.b and k < maxiter. Here an
    iteration past that point takes a zero step: alpha is 0, so x and r
    stay as they were (x + 0 p = x), r.r recomputes the same gamma, and p
    is kept by `torch.where` (which carries no NaN from the branch it
    does not take). So the result is the while loop's iterate.
    """
    atol2 = (tol * tol) * torch.dot(b, b)
    x = torch.zeros_like(b)
    r, p = b, b
    gamma = torch.dot(r, r)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(maxiter):
        live = gamma > atol2
        ap = hvp(p)
        alpha = torch.where(live, gamma / torch.dot(p, ap), zero)
        # addcmul: one launch for x + alpha p
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, ap, value=-1.0)
        gamma_new = torch.dot(r, r)
        p = torch.where(live, torch.addcmul(r, gamma_new / gamma, p), p)
        gamma = gamma_new
    return x


def _newton_prox(shards: Shards, tau: float, m: float, newton_steps: int,
                 z_sum, x0):
    """Newton on f(x) + (tau/2)(M||x||^2 - 2<x, z_sum>) from x0, CG up to
    20 iterations a step, no damping (the reference's x - step)."""
    tm = tau * m
    tz = tau * z_sum
    x = x0
    for _ in range(newton_steps):
        g = torch.add(shard_grad(shards, x), x, alpha=tm) - tz
        h = shard_hvp(shards, x)
        x = x - cg(lambda v: torch.add(h(v), v, alpha=tm), g, maxiter=20)
    return x


def _lsq_factors(shards: Shards, tm: float):
    """Cholesky factors of A^T A / d + tau*M I and A^T b / d, per agent of
    `shards` (batched or one). `torch.linalg.cholesky` is lower where
    the reference's `cho_factor` is upper: the solves agree to round-off,
    not bitwise."""
    eye = torch.eye(shards.a.shape[-1], dtype=F64, device=shards.a.device)
    return torch.linalg.cholesky(shards.gram() + tm * eye), shards.moment()


def make_prox_solver(problem: Problem, agent: int, tau: float,
                     num_tokens: int = 1, newton_steps: int = 20,
                     device="cuda") -> Callable:
    """Returns prox(z_sum, x0) -> x_new for one agent.

    z_sum is sum_m z_m (only the sum enters the optimality condition).
    x0 is the warm start (current local model), used by iterative solvers.
    """
    batched = make_batched_prox_solver(problem, tau, num_tokens,
                                       newton_steps, device)
    return partial(batched, agent)


def make_batched_prox_solver(problem: Problem, tau: float,
                             num_tokens: int = 1, newton_steps: int = 20,
                             device="cuda") -> Callable:
    """Agent-indexed prox solver: prox(agent, z_sum, x0) -> x_new, over
    the shards stacked once on `device` (pre-factored Cholesky stack for
    lsq; Newton-CG for logistic and softmax)."""
    shards = stacked_shards(problem, device)
    m = float(num_tokens)

    if problem.kind == "lsq":
        chols, atbs = _lsq_factors(shards, tau * m)

        def prox_lsq(agent, z_sum, x0):
            del x0
            rhs = torch.add(atbs[agent], z_sum, alpha=tau)
            return torch.cholesky_solve(rhs[:, None], chols[agent])[:, 0]

        return prox_lsq

    def prox_newton(agent, z_sum, x0):
        return _newton_prox(shards[agent], tau, m, newton_steps, z_sum, x0)

    return prox_newton


# ---------------------------------------------------------------------------
# metrics (on x's device; the one host read is the returned float)
# ---------------------------------------------------------------------------


def nmse(problem: Problem, x: torch.Tensor) -> float:
    """Test NMSE = ||A x - b||^2 / ||b||^2 (paper's regression metric)."""
    a = _features(problem.test_features, x.device)
    b = _features(problem.test_targets, x.device)
    r = a @ x - b
    return float((r @ r) / (b @ b))


def accuracy(problem: Problem, x: torch.Tensor) -> float:
    a = _features(problem.test_features, x.device)
    y = _targets(problem, problem.test_targets, x.device)
    if problem.kind == "logistic":
        pred = torch.sign(a @ x)
        pred = torch.where(pred == 0, 1.0, pred)
        return float((pred == y).to(F64).mean())
    if problem.kind == "softmax":
        w = x.reshape(a.shape[1], problem.num_classes)
        pred = (a @ w).argmax(dim=1)
        return float((pred == y).to(F64).mean())
    raise ValueError(problem.kind)


def evaluate(problem: Problem, x: torch.Tensor) -> float:
    """Paper metric for the problem kind: NMSE (lower better) or accuracy."""
    if problem.kind == "lsq":
        return nmse(problem, x)
    return accuracy(problem, x)
