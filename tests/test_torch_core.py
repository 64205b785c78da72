"""Parity of the port's convex reference (`repro_torch.core`,
`repro_torch.data.synthetic`) with the JAX package's (`repro.core`,
`repro.data.synthetic`), on the CPU.

The reference runs in jax x64 (conftest), the port in float64 torch on
`device="cpu"`; inputs come from numpy seeds. Graphs, walks and datasets
are copies and must be equal bit for bit. Everything that goes through a
solver differs only by round-off: the reference differentiates with
jax.grad/jvp and factors with `cho_factor` (upper), the port uses closed
forms and `torch.linalg.cholesky` (lower). Measured gaps on the CPU
(torch 2.13, jax 0.9; relative to the largest |value|): losses,
gradients and HVPs <= 7.3e-16; prox solvers <= 5.5e-16 (lsq) and
<= 3.6e-16 (Newton); CG 7.3e-16; walks of every method, fresh views and
the carried state <= 8.0e-16; DGD, the closed-form and centralized
solutions <= 1.2e-15; simulator states <= 2.5e-15 and metrics <= 2.2e-16
(absolute). The tolerances below are the ones the port is held to.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors gain nothing from threads; one thread keeps the parallel
# test workers from oversubscribing the CPU
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as R  # noqa: E402
from repro.core import baselines as RB  # noqa: E402
from repro.core import losses as RL  # noqa: E402
from repro.data import synthetic as RS  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch.core import baselines as PB  # noqa: E402
from repro_torch.core import losses as PL  # noqa: E402
from repro_torch.core.methods import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.data import synthetic as PS  # noqa: E402

CPU = "cpu"
LSQ_TOL = 1e-10       # walks and baselines through a closed-form solve
NEWTON_TOL = 1e-8     # walks through the Newton-CG prox


def both(kind, feats, targs, dim, num_classes=2, test=(None, None)):
    """The same arrays as a reference Problem and a port Problem."""
    args = (kind, tuple(feats), tuple(targs), dim, num_classes, *test)
    return RL.Problem(*args), PL.Problem(*args)


def lsq_pair(rng, n_agents=6, p=5, d=30, noise=0.05):
    """tests/test_core_convergence.py's small_problem."""
    x_true = rng.standard_normal(p)
    feats = [rng.standard_normal((d, p)) for _ in range(n_agents)]
    targs = [a @ x_true + noise * rng.standard_normal(d) for a in feats]
    ta = rng.standard_normal((50, p))
    return both("lsq", feats, targs, p,
                test=(ta, ta @ x_true + noise * rng.standard_normal(50)))


def logistic_pair(rng, n_agents=4, p=5, d=15):
    """tests/test_core_theory.py's random_logistic_problem, with a test
    set of both labels."""
    feats = [rng.standard_normal((d, p)) for _ in range(n_agents)]
    targs = [np.where(rng.uniform(size=d) < 0.5, 1.0, -1.0)
             for _ in range(n_agents)]
    ta = rng.standard_normal((10, p))
    return both("logistic", feats, targs, p,
                test=(ta, np.where(ta[:, 0] > 0, 1.0, -1.0)))


def softmax_pair(n_agents=3):
    """The USPS surrogate cut to 300 rows (p = 2560)."""
    return (RS.make_problem("usps", n_agents, subsample=300),
            PS.make_problem("usps", n_agents, subsample=300))


PAIRS = {"lsq": lambda: lsq_pair(np.random.default_rng(0)),
         "logistic": lambda: logistic_pair(np.random.default_rng(1)),
         "softmax": softmax_pair}


def close(got, want, tol):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    gap = float(np.abs(got - want).max()) / scale
    assert gap <= tol, f"relative gap {gap:.3e} > {tol:.0e}"


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# ---------------------------------------------------------------------------
# graphs, walks, data: copies, equal bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,zeta,seed", [(5, 0.3, 0), (12, 0.7, 3),
                                         (20, 0.7, 0), (50, 0.7, 0)])
def test_graphs_equal(n, zeta, seed):
    got, want = P.random_graph(n, zeta, seed), R.random_graph(n, zeta, seed)
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    np.testing.assert_array_equal(P.hamiltonian_cycle(got),
                                  R.hamiltonian_cycle(want))
    np.testing.assert_array_equal(P.metropolis_hastings_matrix(got),
                                  R.metropolis_hastings_matrix(want))
    np.testing.assert_array_equal(P.uniform_neighbor_matrix(got),
                                  R.uniform_neighbor_matrix(want))
    np.testing.assert_array_equal(P.ring_graph(n).adjacency,
                                  R.ring_graph(n).adjacency)
    np.testing.assert_array_equal(P.complete_graph(n).adjacency,
                                  R.complete_graph(n).adjacency)
    for m in (1, 3, 5):
        np.testing.assert_array_equal(P.spread_token_starts(n, m),
                                      R.spread_token_starts(n, m))


def test_walks_equal():
    net = R.random_graph(15, 0.5, seed=2)
    for make in (lambda lib: lib.CyclicWalk(lib.hamiltonian_cycle(net)),
                 lambda lib: lib.MarkovWalk(lib.uniform_neighbor_matrix(net)),
                 lambda lib: lib.MarkovWalk(
                     lib.metropolis_hastings_matrix(net))):
        seqs = []
        for lib in (R, P):
            walk, rng, cur, seq = make(lib), np.random.default_rng(7), 0, []
            for _ in range(200):
                cur = walk.next_agent(cur, rng)
                seq.append(cur)
            seqs.append(seq)
        assert seqs[0] == seqs[1]


@pytest.mark.parametrize("name,sub", [("cpusmall", 3000), ("cadata", 3000),
                                      ("ijcnn1", 3000), ("usps", 600)])
def test_make_problem_bitwise(name, sub):
    got = PS.make_problem(name, num_agents=7, subsample=sub, seed=1)
    want = RS.make_problem(name, num_agents=7, subsample=sub, seed=1)
    assert (got.kind, got.dim, got.num_classes) == (
        want.kind, want.dim, want.num_classes)
    for g, w in [*zip(got.features, want.features),
                 *zip(got.targets, want.targets),
                 (got.test_features, want.test_features),
                 (got.test_targets, want.test_targets)]:
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert PS.DATASETS == {k: PS.DatasetSpec(*dataclasses.astuple(v))
                           for k, v in RS.DATASETS.items()}


# ---------------------------------------------------------------------------
# losses, gradients, Hessian-vector products, prox solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_losses_grads_hvps(kind):
    rp, pp = PAIRS[kind]()
    rng = np.random.default_rng(3)
    x = 0.3 * rng.standard_normal(pp.dim)
    v = rng.standard_normal(pp.dim)
    r_loss = RL.make_batched_local_loss(rp)
    r_grad = jax.grad(r_loss, argnums=1)
    p_loss = PL.make_batched_local_loss(pp, CPU)
    shards = PL.stacked_shards(pp, CPU)
    for agent in range(pp.num_agents):
        close(PL.make_local_loss(pp, agent, CPU)(t(x)),
              RL.make_local_loss(rp, agent)(jnp.asarray(x)), 1e-12)
        close(p_loss(agent, t(x)), r_loss(agent, jnp.asarray(x)), 1e-12)
        g = PL.shard_grad(shards[agent], t(x))
        close(g, r_grad(agent, jnp.asarray(x)), 1e-12)
        want_hv = jax.jvp(lambda xx: r_grad(agent, xx), (jnp.asarray(x),),
                          (jnp.asarray(v),))[1]
        hv = PL.shard_hvp(shards[agent], t(x))(t(v))
        close(hv, want_hv, 1e-12)
        # the closed forms against torch's own autodiff
        f = lambda xx: p_loss(agent, xx)  # noqa: E731
        close(g, torch.func.grad(f)(t(x)), 1e-12)
        close(hv, torch.func.jvp(torch.func.grad(f), (t(x),), (t(v),))[1],
              1e-12)
    # batched over every agent at once (DGD's round)
    xs = 0.3 * rng.standard_normal((pp.num_agents, pp.dim))
    close(PL.shard_grad(shards, t(xs)),
          np.stack([r_grad(i, jnp.asarray(xs[i]))
                    for i in range(pp.num_agents)]), 1e-12)
    close(PL.global_objective(pp, t(x)), RL.global_objective(rp, jnp.asarray(x)),
          1e-12)
    zs = rng.standard_normal((2, pp.dim))
    close(PL.penalty_objective(pp, t(xs), t(zs), 0.7),
          RL.penalty_objective(rp, jnp.asarray(xs), jnp.asarray(zs), 0.7),
          1e-12)


@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_prox_solvers(kind):
    rp, pp = PAIRS[kind]()
    tol = 1e-12 if kind == "lsq" else 1e-10
    rng = np.random.default_rng(4)
    tau, m = 0.8, 3
    r_prox = jax.jit(RL.make_batched_prox_solver(rp, tau, m))
    p_prox = PL.make_batched_prox_solver(pp, tau, m, device=CPU)
    for agent in range(pp.num_agents):
        z = 0.2 * rng.standard_normal(pp.dim)
        x0 = 0.2 * rng.standard_normal(pp.dim)
        want = r_prox(agent, jnp.asarray(z), jnp.asarray(x0))
        close(p_prox(agent, t(z), t(x0)), want, tol)
        one = PL.make_prox_solver(pp, agent, tau, m, device=CPU)
        close(one(t(z), t(x0)),
              RL.make_prox_solver(rp, agent, tau, m)(jnp.asarray(z),
                                                     jnp.asarray(x0)), tol)


def test_cg_stops_where_jax_stops():
    """Fixed iterations that stand still once converged give the while
    loop's iterate, on an SPD system that converges early and one that
    runs to maxiter; b = 0 stays 0."""
    rng = np.random.default_rng(5)
    for n, maxiter in [(4, 20), (30, 7)]:
        q = rng.standard_normal((n, n))
        a = q @ q.T + n * np.eye(n) * (1 if n == 4 else 1e-3)
        b = rng.standard_normal(n)
        want, _ = jax.scipy.sparse.linalg.cg(lambda v: jnp.asarray(a) @ v,
                                             jnp.asarray(b), maxiter=maxiter)
        close(PL.cg(lambda v: t(a) @ v, t(b), maxiter), want, 1e-12)
    zero = PL.cg(lambda v: 2.0 * v, torch.zeros(3, dtype=torch.float64), 5)
    assert not zero.abs().max()


# ---------------------------------------------------------------------------
# methods over full walks, and the state carry
# ---------------------------------------------------------------------------


def net_for(problem):
    return R.ring_graph(problem.num_agents)


def methods(kind, rp, pp):
    """(reference, port) pairs of every method for a problem kind."""
    tau = 1.3 if kind == "lsq" else 0.6
    out = [(R.IBCD(rp, tau=tau), P.IBCD(pp, tau=tau, device=CPU)),
           (R.APIBCD(rp, tau=tau, num_walks=3),
            P.APIBCD(pp, tau=tau, num_walks=3, device=CPU)),
           (R.GAPIBCD(rp, tau=tau, num_walks=2, rho=4.0),
            P.GAPIBCD(pp, tau=tau, num_walks=2, rho=4.0, device=CPU)),
           (R.WPG(rp, alpha=0.1), P.WPG(pp, alpha=0.1, device=CPU))]
    return out


def state_close(got, want, tol):
    arrays = state_to_numpy(got)
    for key in ("xs", "tokens", "zhat"):
        if getattr(want, key) is None:
            assert arrays[key] is None
        else:
            close(arrays[key], getattr(want, key), tol)
    assert (got.iteration, got.view_updates) == (want.iteration,
                                                 want.view_updates)


@pytest.mark.parametrize("kind", ["lsq", "logistic"])
def test_methods_over_full_walks(kind):
    rp, pp = PAIRS[kind]()
    tol = LSQ_TOL if kind == "lsq" else NEWTON_TOL
    n = pp.num_agents
    for rm, pm in methods(kind, rp, pp):
        iters = 3 * n * rm.num_walks
        want = R.run_serial(rm, net_for(rp), num_iterations=iters)
        got = P.run_serial(pm, net_for(pp), num_iterations=iters)
        state_close(got, want, tol)
        close(pm.model_estimate(got), rm.model_estimate(want), tol)
        # the state carry: both go on from the reference's state
        carried = state_from_numpy(want, CPU)
        back = R.MethodState(**state_to_numpy(carried))
        for key in ("xs", "tokens", "zhat"):
            a, b = getattr(back, key), getattr(want, key)
            assert (a is None and b is None) or a.tobytes() == b.tobytes()
        for k in range(n):
            want = rm.update(want, k % n, k % rm.num_walks)
            carried = pm.update(carried, k % n, k % pm.num_walks)
        state_close(carried, want, tol)


def test_softmax_walk():
    rp, pp = softmax_pair()
    for rm, pm in methods("softmax", rp, pp)[:3]:
        want = R.run_serial(rm, net_for(rp), num_iterations=6)
        got = P.run_serial(pm, net_for(pp), num_iterations=6)
        state_close(got, want, NEWTON_TOL)


@pytest.mark.parametrize("kind", ["lsq", "logistic"])
def test_fresh_updates_and_token_views(kind):
    """update_fresh and the token_view entry points against the
    reference; a bitwise copy of the tokens as the view equals the
    default bitwise in the port (view_updates is telemetry only)."""
    rp, pp = PAIRS[kind]()
    tol = LSQ_TOL if kind == "lsq" else NEWTON_TOL
    n = pp.num_agents
    rng = np.random.default_rng(6)
    for rm, pm in methods(kind, rp, pp)[1:3]:
        want, got, viewed = rm.init(), pm.init(), pm.init()
        for k in range(2 * n):
            agent, walk = int(rng.integers(n)), k % rm.num_walks
            if k % 2:
                want = rm.update_fresh(want, agent)
                got = pm.update_fresh(got, agent)
                viewed = pm.update_fresh(viewed, agent,
                                         token_view=viewed.tokens.clone())
            else:
                want = rm.update(want, agent, walk,
                                 token_view=want.tokens.copy())
                got = pm.update(got, agent, walk)
                viewed = pm.update(viewed, agent, walk,
                                   token_view=viewed.tokens.clone())
            for key in ("xs", "tokens", "zhat"):
                assert torch.equal(getattr(viewed, key), getattr(got, key))
        assert viewed.view_updates == 2 * n and got.view_updates == 0
        assert want.view_updates == n
        got.view_updates = n
        state_close(got, want, tol)
        # a stale view: the reference's and the port's agree on it too
        stale = 0.5 * want.tokens
        state_close(pm.update(got, 1, 0, token_view=stale),
                    rm.update(want, 1, 0, token_view=stale), tol)


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["lsq", "logistic"])
def test_dgd_rounds(kind):
    rp, pp = PAIRS[kind]()
    net = R.random_graph(pp.num_agents, 0.7, seed=1)
    mix = R.metropolis_hastings_matrix(net)
    rd, pd = R.DGD(rp, 0.05, mix), P.DGD(pp, 0.05, mix, device=CPU)
    want, got = rd.init(), pd.init()
    for _ in range(30):
        want, got = rd.round(want), pd.round(got)
    close(got, want, LSQ_TOL)
    close(pd.model_estimate(got), rd.model_estimate(want), LSQ_TOL)


@pytest.mark.parametrize("m", [1, 3])
def test_closed_form_solutions(m):
    rp, pp = lsq_pair(np.random.default_rng(8))
    for fn, rfn in [(PB.penalized_solution, RB.penalized_solution),
                    (PB.apibcd_stale_fixed_point,
                     RB.apibcd_stale_fixed_point)]:
        (xs, z), (wxs, wz) = fn(pp, 1.7, m, device=CPU), rfn(rp, 1.7, m)
        close(xs, wxs, LSQ_TOL)
        close(z, wz, LSQ_TOL)


@pytest.mark.parametrize("kind", ["lsq", "logistic"])
def test_centralized_solution(kind):
    rp, pp = PAIRS[kind]()
    close(PB.centralized_solution(pp, device=CPU),
          RB.centralized_solution(rp), LSQ_TOL)
    x = PB.centralized_solution(pp, device=CPU)
    assert PL.evaluate(pp, x) == pytest.approx(RL.evaluate(rp, np.asarray(x)),
                                               abs=1e-12)


# ---------------------------------------------------------------------------
# the event simulator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpusmall():
    """tests/test_core_simulator.py's fixture, in both packages."""
    pp = PS.make_problem("cpusmall", num_agents=20, subsample=2000, seed=0)
    rp = RS.make_problem("cpusmall", num_agents=20, subsample=2000, seed=0)
    net = R.random_graph(20, zeta=0.7, seed=0)
    return rp, pp, net, R.hamiltonian_cycle(net)


def traces_equal(got, want, metric_tol=1e-9):
    assert got.name == want.name
    (gt, gc, gk, gm), (wt, wc, wk, wm) = got.as_arrays(), want.as_arrays()
    assert gt.tobytes() == wt.tobytes()
    assert gc.tobytes() == wc.tobytes() and gk.tobytes() == wk.tobytes()
    np.testing.assert_allclose(gm, wm, rtol=0, atol=metric_tol)


@pytest.mark.parametrize("which", ["I-BCD", "API-BCD", "gAPI-BCD", "WPG",
                                   "API-BCD markov"])
def test_simulate_incremental_traces(cpusmall, which):
    rp, pp, net, order = cpusmall
    make = {"I-BCD": lambda lib, pr, **d: lib.IBCD(pr, tau=1.0, **d),
            "API-BCD": lambda lib, pr, **d: lib.APIBCD(pr, tau=0.1,
                                                       num_walks=5, **d),
            "gAPI-BCD": lambda lib, pr, **d: lib.GAPIBCD(
                pr, tau=0.1, num_walks=5, rho=2.0, **d),
            "WPG": lambda lib, pr, **d: lib.WPG(pr, alpha=0.5, **d),
            "API-BCD markov": lambda lib, pr, **d: lib.APIBCD(
                pr, tau=0.25, num_walks=3, **d)}[which]
    results = []
    for lib, pr, dev in [(R, rp, {}), (P, pp, {"device": CPU})]:
        method = make(lib, pr, **dev)
        if which.endswith("markov"):
            walks = [lib.MarkovWalk(lib.uniform_neighbor_matrix(net))
                     for _ in range(method.num_walks)]
        else:
            walks = [lib.CyclicWalk(order) for _ in range(method.num_walks)]
        results.append(lib.simulate_incremental(
            method, net, walks, max_iterations=200, eval_every=10, seed=1,
            delay=lib.DelayModel()))
    got, want = results[1], results[0]
    traces_equal(got, want)
    state_close(got.final_state, want.final_state, LSQ_TOL)
    target = float(np.median(want.as_arrays()[3]))
    assert got.time_to_metric(target) == want.time_to_metric(target)


def test_simulate_gossip_trace(cpusmall):
    rp, pp, net, _ = cpusmall
    mix = R.metropolis_hastings_matrix(net)
    want = R.simulate_gossip(R.DGD(rp, 0.05, mix), net, max_rounds=100)
    got = P.simulate_gossip(P.DGD(pp, 0.05, mix, device=CPU), net,
                            max_rounds=100)
    traces_equal(got, want)
    close(got.final_state, want.final_state, LSQ_TOL)


def test_figure_example_writes_the_reference_csv(tmp_path):
    """`repro_torch.examples.decentralized_lsq` takes the reference
    example's FIGURES and writes its CSV: every method, iteration,
    simulated time and communication equal as printed, the metric
    within its printed precision."""
    import importlib.util
    import pathlib

    from repro_torch.examples import decentralized_lsq

    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "decentralized_lsq.py")
    spec = importlib.util.spec_from_file_location("reference_figs", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert decentralized_lsq.FIGURES == ref.FIGURES
    ref.run_figure("fig3_cpusmall", str(tmp_path / "ref"))
    decentralized_lsq.run_figure("fig3_cpusmall", str(tmp_path / "port"),
                                 device=CPU)
    want, got = ((tmp_path / d / "fig3_cpusmall.csv").read_text().split()
                 for d in ("ref", "port"))
    assert len(got) == len(want) == 1 + 4 * 62 + 11    # 600 activations, 50 rounds
    for g, w in zip(got, want):
        *g_head, g_metric = g.split(",")
        *w_head, w_metric = w.split(",")
        assert g_head == w_head
        if w_metric != "metric":
            assert abs(float(g_metric) - float(w_metric)) <= 1e-6
