"""Serial (untimed) driver for token-walk methods (the port of
`repro/core/driver.py`).

Used by tests and quick convergence studies: executes activations in a
deterministic interleaving (round-robin across walks), with no timing model.
Communication units still count one per token hop. The state stays on
the method's device: the loop reads nothing back to the host.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.graph import (
    CyclicWalk, Network, WalkSchedule, hamiltonian_cycle)
from repro_torch.core.methods import IncrementalMethod, MethodState
from repro_torch.utils.hotpath import hot_loop


@hot_loop
def run_serial(
    method: IncrementalMethod,
    network: Network,
    num_iterations: int,
    walks: Optional[Sequence[WalkSchedule]] = None,
    start_agents: Optional[Sequence[int]] = None,
    seed: int = 0,
    callback=None,
) -> MethodState:
    """Round-robin over walks: walk w activates on iterations w, w+M, ..."""
    rng = np.random.default_rng(seed)
    n, m = network.num_agents, method.num_walks
    if walks is None:
        order = hamiltonian_cycle(network)
        walks = [CyclicWalk(order) for _ in range(m)]
    if start_agents is None:
        start_agents = [(w * n) // m for w in range(m)]
    pos = list(map(int, start_agents))

    state = method.init()
    if callback:
        callback(state)
    for k in range(num_iterations):
        w = k % m
        agent = pos[w]
        state = method.update(state, agent, w)
        pos[w] = walks[w].next_agent(agent, rng)
        if callback:
            callback(state)
    return state
