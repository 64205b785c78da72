"""Asynchronous event-driven simulator for decentralized token-walk training
(the port of `repro/core/simulator.py`).

Reproduces the paper's cost model (Section 5):
  * communication cost: 1 unit per link use (unicast),
  * communication delay per hop ~ U(1e-5, 1e-4) seconds,
  * running time = computation time in local agents + communication time
    between agents.

M tokens walk the graph concurrently and *asynchronously*: each token is an
independent event stream; an agent busy with one token delays another token
that arrives meanwhile (single-threaded agents). This realizes the true
asynchronous execution of Algorithm 2 — the mesh runtime in
`repro_torch.dist.trainer` realizes the synchronous fresh-token logical view the
theory analyzes; the simulator is where wall-clock asynchrony lives.

Synchronous gossip baselines (DGD) are simulated round-based: every round
all agents compute in parallel (time = max over agents) and every directed
link carries one message (2|E| units).

The clock is host arithmetic in numpy, as the reference's, so the time,
comm and iteration columns of a trace equal the reference's exactly; only
the metric goes through the device, and `record()`'s read of it is the
loop's one host sync.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import losses as L
from repro_torch.core.graph import Network, WalkSchedule
from repro_torch.core.methods import IncrementalMethod
from repro_torch.utils.hotpath import hot_loop


@dataclasses.dataclass
class TracePoint:
    time: float          # simulated seconds
    comm: int            # cumulative communication units (link uses)
    iteration: int       # cumulative activations
    metric: float        # test NMSE or accuracy (per problem kind)


@dataclasses.dataclass
class SimResult:
    name: str
    trace: List[TracePoint]
    final_state: object

    def as_arrays(self):
        t = np.array([p.time for p in self.trace])
        c = np.array([p.comm for p in self.trace])
        k = np.array([p.iteration for p in self.trace])
        m = np.array([p.metric for p in self.trace])
        return t, c, k, m

    def time_to_metric(self, target: float, lower_is_better: bool = True):
        """First simulated time at which the metric crosses ``target``."""
        for p in self.trace:
            ok = p.metric <= target if lower_is_better else p.metric >= target
            if ok:
                return p.time, p.comm
        return None, None


@dataclasses.dataclass
class DelayModel:
    """Communication + computation timing model (paper Section 5)."""

    comm_low: float = 1e-5       # U(1e-5, 1e-4) s per hop
    comm_high: float = 1e-4
    agent_speed: float = 1e9     # flops/sec per agent
    speed_jitter: float = 0.2    # +-20% heterogeneity across agents

    def comm_delay(self, rng: np.random.Generator) -> float:
        return float(rng.uniform(self.comm_low, self.comm_high))

    def agent_speeds(self, n: int, rng: np.random.Generator) -> np.ndarray:
        return self.agent_speed * (
            1.0 + self.speed_jitter * rng.uniform(-1, 1, size=n))


@hot_loop
def simulate_incremental(
    method: IncrementalMethod,
    network: Network,
    walks: Sequence[WalkSchedule],
    max_iterations: int = 2000,
    max_time: float = np.inf,
    eval_every: int = 10,
    delay: Optional[DelayModel] = None,
    seed: int = 0,
    start_agents: Optional[Sequence[int]] = None,
) -> SimResult:
    """Run an event-driven async simulation of a token-walk method."""
    delay = delay or DelayModel()
    rng = np.random.default_rng(seed)
    n = network.num_agents
    m = method.num_walks
    assert len(walks) == m, "one walk schedule per token"

    if start_agents is None:
        start_agents = [(w * n) // m for w in range(m)]

    speeds = delay.agent_speeds(n, rng)
    state = method.init()
    agent_free = np.zeros(n)  # time at which agent i finishes current work

    # event heap: (arrival_time, seq, walk, agent)
    heap = []
    for w, a in enumerate(start_agents):
        heapq.heappush(heap, (0.0, w, w, int(a)))
    seq = m

    comm = 0
    trace: List[TracePoint] = []

    def record():
        x = method.model_estimate(state)
        trace.append(TracePoint(now, comm, state.iteration,
                                L.evaluate(method.problem, x)))

    now = 0.0
    record()
    while heap and state.iteration < max_iterations and now < max_time:
        arrival, _, walk, agent = heapq.heappop(heap)
        # agent is single-threaded: wait until free, then compute
        start = max(arrival, agent_free[agent])
        compute = method.flops_per_update() / speeds[agent]
        done = start + compute
        agent_free[agent] = done
        now = done

        state = method.update(state, agent, walk)

        # forward token to the next agent on this walk
        nxt = walks[walk].next_agent(agent, rng)
        hop = delay.comm_delay(rng)
        comm += 1
        heapq.heappush(heap, (done + hop, seq, walk, nxt))
        seq += 1

        if state.iteration % eval_every == 0:
            record()

    record()
    return SimResult(method.name, trace, state)


def simulate_gossip(
    dgd,
    network: Network,
    max_rounds: int = 500,
    eval_every: int = 5,
    delay: Optional[DelayModel] = None,
    seed: int = 0,
) -> SimResult:
    """Round-based simulation of synchronous gossip (DGD)."""
    delay = delay or DelayModel()
    rng = np.random.default_rng(seed)
    n = network.num_agents
    speeds = delay.agent_speeds(n, rng)
    links = 2 * network.num_links   # unicast per directed link per round

    xs = dgd.init()
    now, comm = 0.0, 0
    trace = [TracePoint(now, comm, 0,
                        L.evaluate(dgd.problem, dgd.model_estimate(xs)))]
    for r in range(1, max_rounds + 1):
        compute = float(np.max(dgd.flops_per_update() / speeds))
        hop = max(delay.comm_delay(rng) for _ in range(network.num_links))
        now += compute + hop
        comm += links
        xs = dgd.round(xs)
        if r % eval_every == 0:
            trace.append(TracePoint(now, comm, r * n,
                                    L.evaluate(dgd.problem,
                                               dgd.model_estimate(xs))))
    return SimResult(dgd.name, trace, xs)
