"""Quickstart: decentralized least squares with API-BCD in float64 torch.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Builds a 20-agent network, trains a linear model with 5 parallel token
walks (the paper's Algorithm 2), and compares against the centralized
solution and the single-token I-BCD (Algorithm 1). Runs on the card
unless `--device cpu` is given, and raises when there is no card to run
on. `--max-iterations N` cuts each method's walk to N activations.
"""
import argparse

import numpy as np

from repro_torch.core import (
    APIBCD, IBCD, CyclicWalk, centralized_solution, hamiltonian_cycle,
    random_graph, simulate_incremental,
)
from repro_torch.core.losses import nmse
from repro_torch.data import make_problem
from repro_torch.utils.device import resolve_device

ITERATIONS = 400


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-iterations", type=int, default=None,
                    help=f"cut each walk to this many activations (of "
                         f"{ITERATIONS})")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns {method name: SimResult}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    iters = ITERATIONS
    if args.max_iterations is not None and args.max_iterations < iters:
        iters = args.max_iterations
        print(f"cut: {iters} of {ITERATIONS} activations a method")
    # 20 agents, random connected graph with 70% edge density (paper Fig. 3)
    problem = make_problem("cpusmall", num_agents=20, subsample=2048)
    net = random_graph(20, zeta=0.7, seed=0)
    order = hamiltonian_cycle(net)

    x_star = centralized_solution(problem, device=device)
    print(f"centralized NMSE: {nmse(problem, x_star):.4f} (device {device})")

    results = {}
    for method in (IBCD(problem, tau=1.0, device=device),
                   APIBCD(problem, tau=0.1, num_walks=5, device=device)):
        walks = [CyclicWalk(order) for _ in range(method.num_walks)]
        res = simulate_incremental(method, net, walks, max_iterations=iters,
                                   eval_every=40)
        t, c, k, err = res.as_arrays()
        print(f"\n{method.name} (M={method.num_walks} walks)")
        print(f"  NMSE trace: {np.round(err, 4).tolist()}")
        print(f"  simulated time {t[-1] * 1e3:.2f} ms, "
              f"communication {int(c[-1])} link-uses")
        results[method.name] = res
    return results


if __name__ == "__main__":
    main()
