"""Core: the paper's contribution — incremental BCD decentralized learning,
in float64 torch on an explicit device (the port of `repro/core`).

Exports the convex reference implementations (Algorithms 1-2, gAPI-BCD,
baselines, async simulator). The trainer that realizes the same
superstep on a language model lives in `repro_torch.dist.trainer`.
"""
from repro_torch.core.graph import (  # noqa: F401
    CyclicWalk,
    MarkovWalk,
    Network,
    complete_graph,
    hamiltonian_cycle,
    metropolis_hastings_matrix,
    random_graph,
    ring_graph,
    spread_token_starts,
    uniform_neighbor_matrix,
)
from repro_torch.core.losses import (  # noqa: F401
    Problem,
    evaluate,
    global_objective,
    make_local_loss,
    make_prox_solver,
    penalty_objective,
)
from repro_torch.core.methods import (  # noqa: F401
    APIBCD,
    GAPIBCD,
    IBCD,
    IncrementalMethod,
    MethodState,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.core.baselines import (  # noqa: F401
    DGD, WPG, centralized_solution)
from repro_torch.core.driver import run_serial  # noqa: F401
from repro_torch.core.simulator import (  # noqa: F401
    DelayModel,
    SimResult,
    simulate_gossip,
    simulate_incremental,
)
