"""Decentralized network topology G = (N, E) and token-walk transition rules
(a copy of `repro/core/graph.py`: numpy only, so every walk draws the
same agents from the same `np.random.Generator`).

The paper defines learning over an undirected connected graph of N agents
with |E| = N(N-1)/2 * zeta links (random connected graph with edge density
zeta), and token walks that move between direct neighbours either by a
Markov chain P (random walk) or a deterministic circulant pattern
(Hamiltonian cycle, as in WPG [17] and the paper's own experiments).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Network:
    """An undirected connected communication graph.

    Attributes:
      num_agents: N.
      adjacency: [N, N] bool, symmetric, zero diagonal.
    """

    num_agents: int
    adjacency: np.ndarray

    def __post_init__(self):
        a = self.adjacency
        assert a.shape == (self.num_agents, self.num_agents)
        assert (a == a.T).all(), "graph must be undirected"
        assert not a.diagonal().any(), "no self loops"

    @property
    def num_links(self) -> int:
        return int(self.adjacency.sum()) // 2

    def neighbors(self, i: int) -> np.ndarray:
        return np.flatnonzero(self.adjacency[i])

    def degree(self, i: int) -> int:
        return int(self.adjacency[i].sum())

    def is_connected(self) -> bool:
        n = self.num_agents
        seen = np.zeros(n, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            u = stack.pop()
            for v in np.flatnonzero(self.adjacency[u]):
                if not seen[v]:
                    seen[v] = True
                    stack.append(int(v))
        return bool(seen.all())


def ring_graph(n: int) -> Network:
    """Hamiltonian-cycle ring: agent i <-> (i+1) mod n."""
    a = np.zeros((n, n), dtype=bool)
    for i in range(n):
        a[i, (i + 1) % n] = True
        a[(i + 1) % n, i] = True
    return Network(n, a)


def complete_graph(n: int) -> Network:
    a = ~np.eye(n, dtype=bool)
    return Network(n, a)


def random_graph(n: int, zeta: float, seed: int = 0) -> Network:
    """Random connected graph with expected edge density ``zeta``.

    Matches the paper's setup |E| = N(N-1)/2 * zeta. A Hamiltonian ring is
    embedded first to guarantee connectivity (the paper's deterministic
    selection rule also requires a Hamiltonian cycle to exist), then random
    extra edges are added to reach the target density.
    """
    if not (0.0 < zeta <= 1.0):
        raise ValueError(f"zeta must be in (0, 1], got {zeta}")
    rng = np.random.default_rng(seed)
    a = ring_graph(n).adjacency.copy()
    target = int(round(n * (n - 1) / 2 * zeta))
    target = max(target, n)  # ring already has n edges
    # candidate non-ring edges
    cand = [(i, j) for i in range(n) for j in range(i + 1, n) if not a[i, j]]
    rng.shuffle(cand)
    need = target - n
    for (i, j) in cand[:need]:
        a[i, j] = a[j, i] = True
    return Network(n, a)


def hamiltonian_cycle(net: Network) -> np.ndarray:
    """Return a Hamiltonian cycle order [N] if the natural ring is embedded.

    All graphs built by this module embed the identity ring, so the cycle
    0 -> 1 -> ... -> N-1 -> 0 is always valid; verify and return it.
    """
    n = net.num_agents
    order = np.arange(n)
    for i in range(n):
        j = (i + 1) % n
        if not net.adjacency[order[i], order[j]]:
            raise ValueError("natural Hamiltonian cycle not present in graph")
    return order


def metropolis_hastings_matrix(net: Network) -> np.ndarray:
    """Symmetric doubly-stochastic transition matrix P over G.

    P[i, j] is the probability that a token at agent i moves to agent j
    (j in N_i ∪ {i}), per the paper's Markov-chain walk rule. The
    Metropolis-Hastings construction guarantees uniform stationary
    distribution, so every agent is activated equally often in expectation.
    """
    n = net.num_agents
    p = np.zeros((n, n))
    deg = net.adjacency.sum(axis=1)
    for i in range(n):
        for j in net.neighbors(i):
            p[i, j] = 1.0 / (1 + max(deg[i], deg[j]))
        p[i, i] = 1.0 - p[i].sum()
    assert np.allclose(p.sum(axis=1), 1.0)
    return p


def uniform_neighbor_matrix(net: Network) -> np.ndarray:
    """P[i, j] = 1/|N_i| for j in N_i — simple random walk."""
    n = net.num_agents
    p = net.adjacency.astype(float)
    p /= p.sum(axis=1, keepdims=True)
    return p


class WalkSchedule:
    """Produces the sequence of active agents (i_k) for a token walk."""

    def next_agent(self, current: int, rng: np.random.Generator) -> int:
        raise NotImplementedError


class CyclicWalk(WalkSchedule):
    """Deterministic Hamiltonian-cycle walk (paper's experimental rule)."""

    def __init__(self, order: Sequence[int]):
        self.order = np.asarray(order)
        self._pos = {int(a): idx for idx, a in enumerate(self.order)}

    def next_agent(self, current: int, rng: np.random.Generator) -> int:
        idx = self._pos[int(current)]
        return int(self.order[(idx + 1) % len(self.order)])


class MarkovWalk(WalkSchedule):
    """Random walk by transition matrix P (paper's randomized rule)."""

    def __init__(self, p: np.ndarray):
        self.p = p

    def next_agent(self, current: int, rng: np.random.Generator) -> int:
        return int(rng.choice(len(self.p), p=self.p[int(current)]))


def spread_token_starts(n_agents: int, n_walks: int) -> np.ndarray:
    """Evenly spaced initial token positions (maximizes inter-token gap)."""
    return (np.arange(n_walks) * n_agents) // max(n_walks, 1)
