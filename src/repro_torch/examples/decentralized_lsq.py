"""Full paper-style experiment in float64 torch: all methods, all four
surrogate datasets, time/communication traces written to CSV (reproduces
Figs. 3-6 data).

    PYTHONPATH=src python -m repro_torch.examples.decentralized_lsq \
        --out results/figs
    PYTHONPATH=src python -m repro_torch.examples.decentralized_lsq \
        --device cpu --figures fig3_cpusmall --max-iterations 100

Runs on the card unless `--device cpu` is given, and raises when there is
no card to run on. `--max-iterations N` cuts each figure's walks to N
activations a method (and DGD to max(N // agents, 50) rounds).
"""
import argparse
import os

from repro_torch.core import (
    APIBCD, DGD, GAPIBCD, IBCD, WPG, CyclicWalk, hamiltonian_cycle,
    metropolis_hastings_matrix, random_graph, simulate_gossip,
    simulate_incremental,
)
from repro_torch.data import make_problem
from repro_torch.utils.device import resolve_device

# paper figure captions:
# (dataset, N, zeta, M, alpha, tau_IS, tau_API, subsample, iterations)
FIGURES = {
    "fig3_cpusmall": ("cpusmall", 20, 0.7, 5, 0.5, 1.0, 0.1, None, 600),
    "fig4_cadata": ("cadata", 50, 0.7, 5, 0.2, 2.8, 0.1, None, 1000),
    "fig5_ijcnn1": ("ijcnn1", 50, 0.7, 5, 0.5, 2.8, 0.1, 10000, 800),
    "fig6_usps": ("usps", 10, 0.7, 5, 0.1, 5.0, 1.0, 2000, 300),
}


def build_figure(fig, device="cuda"):
    """(problem, network, [WPG, I-BCD, API-BCD, gAPI-BCD], DGD, iterations)
    of one figure, on `device`."""
    ds, n, zeta, m, alpha, tau_is, tau_api, sub, iters = FIGURES[fig]
    problem = make_problem(ds, num_agents=n, subsample=sub, seed=0)
    net = random_graph(n, zeta=zeta, seed=0)
    methods = [
        WPG(problem, alpha=alpha, device=device),
        IBCD(problem, tau=tau_is, device=device),
        APIBCD(problem, tau=tau_api, num_walks=m, device=device),
        GAPIBCD(problem, tau=tau_api, num_walks=m, rho=2.0, device=device),
    ]
    dgd = DGD(problem, alpha=min(alpha, 0.05),
              mixing=metropolis_hastings_matrix(net), device=device)
    return problem, net, methods, dgd, iters


def run_figure(fig, out_dir, device="cuda", max_iterations=None):
    """Simulate every method of `fig`, write `<out_dir>/<fig>.csv`, and
    return {method name: SimResult}."""
    device = resolve_device(device)
    _, net, methods, dgd, iters = build_figure(fig, device)
    if max_iterations is not None and max_iterations < iters:
        print(f"  cut: {max_iterations} of {iters} activations a method")
        iters = max_iterations
    order = hamiltonian_cycle(net)

    results = {}
    rows = ["method,iteration,sim_time_s,comm_units,metric"]
    for method in methods:
        walks = [CyclicWalk(order) for _ in range(method.num_walks)]
        res = simulate_incremental(method, net, walks,
                                   max_iterations=iters, eval_every=10)
        for p in res.trace:
            rows.append(f"{method.name},{p.iteration},{p.time:.6e},"
                        f"{p.comm},{p.metric:.6f}")
        last = res.trace[-1]
        print(f"  {method.name:10s} final={last.metric:.4f} "
              f"time={last.time * 1e3:.2f}ms comm={last.comm}")
        results[method.name] = res

    res = simulate_gossip(dgd, net,
                          max_rounds=max(iters // net.num_agents, 50))
    for p in res.trace:
        rows.append(f"DGD,{p.iteration},{p.time:.6e},{p.comm},"
                    f"{p.metric:.6f}")
    print(f"  {'DGD':10s} final={res.trace[-1].metric:.4f} "
          f"time={res.trace[-1].time * 1e3:.2f}ms comm={res.trace[-1].comm}")
    results[dgd.name] = res

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{fig}.csv")
    with open(path, "w") as f:
        f.write("\n".join(rows))
    print(f"  wrote {path}")
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/figs")
    ap.add_argument("--figures", nargs="*", default=list(FIGURES))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--max-iterations", type=int, default=None,
                    help="cut each figure's walks to this many activations")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns {figure: {method name: SimResult}}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    for fig in args.figures:
        print(f"== {fig} ==")
        out[fig] = run_figure(fig, args.out, device, args.max_iterations)
    return out


if __name__ == "__main__":
    main()
