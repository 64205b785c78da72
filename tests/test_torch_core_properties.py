"""The claims of tests/test_core_{convergence,graph,simulator,theory}.py,
held by the port alone (`repro_torch.core` in float64 torch on the CPU):
exact penalized optimum, the stale fixed point, the descent inequalities
of Theorems 1-3, the token-mean invariant, API-BCD faster than I-BCD in
simulated time, incremental methods beating gossip on communication.
Seeded cases are parametrised where the reference sweeps them.

The `cuda` tests hold one lsq and one Newton prox and a 20-update walk
on the card against the CPU; they skip without a GPU. This file imports
no JAX, so it also runs without JAX installed, with `--noconftest`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors gain nothing from threads; one thread keeps the parallel
# test workers from oversubscribing the CPU
torch.set_num_threads(1)

from repro_torch.core import (  # noqa: E402
    APIBCD, DGD, GAPIBCD, IBCD, WPG, CyclicWalk, DelayModel, MarkovWalk,
    Problem, centralized_solution, complete_graph, hamiltonian_cycle,
    metropolis_hastings_matrix, penalty_objective, random_graph, ring_graph,
    run_serial, simulate_gossip, simulate_incremental, spread_token_starts,
    uniform_neighbor_matrix,
)
from repro_torch.core import losses as L  # noqa: E402
from repro_torch.core.baselines import (  # noqa: E402
    apibcd_stale_fixed_point, penalized_solution)
from repro_torch.data import make_problem  # noqa: E402

CPU = "cpu"


def cases(n):
    return pytest.mark.parametrize("seed", range(n))


def lsq_problem(rng, n_agents=6, p=5, d=30, noise=0.05):
    """tests/test_core_convergence.py's small_problem."""
    feats, targs = [], []
    x_true = rng.standard_normal(p)
    for _ in range(n_agents):
        a = rng.standard_normal((d, p))
        feats.append(a)
        targs.append(a @ x_true + noise * rng.standard_normal(d))
    ta = rng.standard_normal((50, p))
    tb = ta @ x_true + noise * rng.standard_normal(50)
    return Problem("lsq", tuple(feats), tuple(targs), p,
                   test_features=ta, test_targets=tb)


def random_lsq_problem(rng, n_agents=5, p=6, d=12):
    """tests/test_core_theory.py's random_lsq_problem."""
    feats = [rng.standard_normal((d, p)) for _ in range(n_agents)]
    targs = [rng.standard_normal(d) for _ in range(n_agents)]
    return Problem("lsq", tuple(feats), tuple(targs), p,
                   test_features=rng.standard_normal((20, p)),
                   test_targets=rng.standard_normal(20))


def random_logistic_problem(rng, n_agents=4, p=5, d=15):
    feats, targs = [], []
    for _ in range(n_agents):
        feats.append(rng.standard_normal((d, p)))
        targs.append(np.where(rng.uniform(size=d) < 0.5, 1.0, -1.0))
    return Problem("logistic", tuple(feats), tuple(targs), p,
                   test_features=rng.standard_normal((10, p)),
                   test_targets=np.ones(10))


def lsq_smoothness(problem):
    """L = max_i lambda_max(A_i^T A_i / d_i) for least squares."""
    return max(float(np.linalg.eigvalsh(a.T @ a / a.shape[0])[-1])
               for a in problem.features)


def np_(t):
    return t.detach().cpu().numpy()


def F(problem, state, tau):
    return float(penalty_objective(problem, state.xs, state.tokens, tau))


# ---------------------------------------------------------------------------
# graphs and walks (test_core_graph.py)
# ---------------------------------------------------------------------------


@cases(6)
def test_random_graph_connected_and_dense_enough(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    zeta = float(rng.uniform(0.2, 1.0))
    net = random_graph(n, zeta, seed=int(rng.integers(1000)))
    assert net.is_connected()
    assert net.num_links >= min(round(n * (n - 1) / 2 * zeta), n)


def test_ring_complete_and_token_starts():
    assert ring_graph(5).num_links == 5
    assert complete_graph(5).num_links == 10
    assert ring_graph(7).is_connected()
    np.testing.assert_array_equal(spread_token_starts(16, 4), [0, 4, 8, 12])
    np.testing.assert_array_equal(spread_token_starts(10, 3), [0, 3, 6])
    assert len(set(spread_token_starts(16, 5).tolist())) == 5


@cases(5)
def test_mh_matrix_doubly_stochastic_and_walks_stay_on_edges(seed):
    rng = np.random.default_rng(seed)
    net = random_graph(int(rng.integers(4, 20)), 0.6,
                       seed=int(rng.integers(100)))
    p = metropolis_hastings_matrix(net)
    np.testing.assert_allclose(p.sum(axis=0), 1.0, atol=1e-12)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-12)
    assert (p >= 0).all()
    off = p * (~net.adjacency & ~np.eye(net.num_agents, dtype=bool))
    assert np.abs(off).max() == 0.0
    walk, cur = MarkovWalk(uniform_neighbor_matrix(net)), 0
    for _ in range(200):
        nxt = walk.next_agent(cur, rng)
        assert net.adjacency[cur, nxt], "walk left the graph"
        cur = nxt


def test_cyclic_walk_covers_all_agents():
    walk = CyclicWalk(hamiltonian_cycle(random_graph(12, 0.7, seed=0)))
    rng = np.random.default_rng(0)
    cur, seen = 0, {0}
    for _ in range(11):
        cur = walk.next_agent(cur, rng)
        seen.add(cur)
    assert seen == set(range(12))


# ---------------------------------------------------------------------------
# fixed points and convergence (test_core_convergence.py)
# ---------------------------------------------------------------------------


@cases(4)
def test_ibcd_reaches_exact_penalized_optimum(seed):
    rng = np.random.default_rng(seed)
    problem = lsq_problem(rng)
    tau = float(rng.uniform(0.5, 5.0))
    xs_star, z_star = penalized_solution(problem, tau, device=CPU)
    method = IBCD(problem, tau=tau, device=CPU)
    state = run_serial(method, ring_graph(6), num_iterations=400 * 6)
    assert torch.linalg.norm(state.tokens[0] - z_star) < 1e-6
    assert (state.xs - xs_star).abs().max() < 1e-6


@cases(4)
def test_apibcd_physical_reaches_stale_fixed_point(seed):
    rng = np.random.default_rng(seed)
    problem = lsq_problem(rng)
    tau = float(rng.uniform(0.5, 3.0))
    m = int(rng.integers(2, 4))
    xs_star, zbar = apibcd_stale_fixed_point(problem, tau, m, device=CPU)
    method = APIBCD(problem, tau=tau, num_walks=m, device=CPU)
    state = run_serial(method, ring_graph(6), num_iterations=600 * 6)
    assert (state.xs - xs_star).abs().max() < 1e-6
    # every delta is credited to one token: sum_m z_m tracks mean_i x_i
    assert (state.tokens.sum(0) - zbar).abs().max() < 1e-6


@cases(4)
def test_apibcd_fresh_view_reaches_penalized_optimum(seed):
    rng = np.random.default_rng(seed)
    problem = lsq_problem(rng)
    tau = float(rng.uniform(0.5, 3.0))
    m = int(rng.integers(2, 4))
    xs_star, z_star = penalized_solution(problem, tau, num_tokens=m,
                                         device=CPU)
    method = APIBCD(problem, tau=tau, num_walks=m, device=CPU)
    state = method.init()
    for k in range(400 * 6):
        state = method.update_fresh(state, k % 6)
    for w in range(m):
        assert torch.linalg.norm(state.tokens[w] - z_star) < 1e-6
    assert (state.xs - xs_star).abs().max() < 1e-6


@cases(3)
def test_gapibcd_reaches_stale_fixed_point(seed):
    rng = np.random.default_rng(seed)
    problem = lsq_problem(rng, n_agents=4, d=20)
    xs_star, _ = apibcd_stale_fixed_point(problem, 2.0, 2, device=CPU)
    method = GAPIBCD(problem, tau=2.0, num_walks=2,
                     rho=lsq_smoothness(problem), device=CPU)
    state = run_serial(method, ring_graph(4), num_iterations=2500 * 4)
    err = float((state.xs - xs_star).abs().max())
    assert err < 1e-4, f"gAPI-BCD error to stale fixed point: {err:.2e}"


def test_penalty_bias_shrinks_with_tau():
    """Paper §2: larger tau implies better agreement between (2) and (3)."""
    problem = lsq_problem(np.random.default_rng(11))
    x_star = centralized_solution(problem, device=CPU)
    errs = []
    for tau in (0.5, 5.0, 50.0, 500.0):
        _, z_tau = penalized_solution(problem, tau, device=CPU)
        errs.append(float(torch.linalg.norm(z_tau - x_star)
                          / torch.linalg.norm(x_star)))
    assert all(errs[i + 1] < errs[i] for i in range(len(errs) - 1)), errs
    assert errs[-1] < 1e-3, errs


@pytest.mark.parametrize("name,seed,make,iters,bound", [
    ("I-BCD", 5, lambda p: IBCD(p, tau=100.0, device=CPU), 1500, 0.02),
    ("WPG", 3, lambda p: WPG(p, alpha=0.05, device=CPU), 800, 0.05)],
    ids=["I-BCD", "WPG"])
def test_walks_track_centralized(name, seed, make, iters, bound):
    problem = lsq_problem(np.random.default_rng(seed))
    x_star = centralized_solution(problem, device=CPU)
    state = run_serial(make(problem), ring_graph(6),
                       num_iterations=iters * 6)
    err = float(torch.linalg.norm(state.tokens[0] - x_star)
                / torch.linalg.norm(x_star))
    assert err < bound, f"{name} consensus error {err:.4f}"


def test_dgd_converges():
    problem = lsq_problem(np.random.default_rng(4))
    x_star = centralized_solution(problem, device=CPU)
    net = random_graph(6, zeta=0.7, seed=1)
    dgd = DGD(problem, alpha=0.05, mixing=metropolis_hastings_matrix(net),
              device=CPU)
    xs = dgd.init()
    for _ in range(1500):
        xs = dgd.round(xs)
    err = float(torch.linalg.norm(dgd.model_estimate(xs) - x_star)
                / torch.linalg.norm(x_star))
    assert err < 0.05, f"DGD consensus error {err:.3f}"


def test_classification_surrogates_train():
    problem = make_problem("ijcnn1", num_agents=6, subsample=1200)
    method = APIBCD(problem, tau=0.5, num_walks=2, newton_steps=15,
                    device=CPU)
    state = run_serial(method, ring_graph(6), num_iterations=240)
    acc = L.evaluate(problem, method.model_estimate(state))
    assert acc > 0.75, f"ijcnn1 accuracy {acc:.3f}"   # guessing: 0.5
    problem = make_problem("usps", num_agents=4, subsample=600)
    method = GAPIBCD(problem, tau=1.0, num_walks=2, rho=5.0, device=CPU)
    state = run_serial(method, ring_graph(4), num_iterations=800)
    acc = L.evaluate(problem, method.model_estimate(state))
    assert acc > 0.5, f"usps accuracy {acc:.3f}"       # guessing: 0.1


def test_logistic_centralized_solution_is_stationary():
    problem = random_logistic_problem(np.random.default_rng(2))
    x = centralized_solution(problem, device=CPU)
    g = torch.func.grad(lambda v: L.global_objective(problem, v))(x)
    assert float(torch.linalg.norm(g)) < 1e-8


def test_larger_tau_tightens_consensus():
    problem = lsq_problem(np.random.default_rng(7))
    gaps = []
    for tau in (1.0, 100.0):
        state = run_serial(IBCD(problem, tau=tau, device=CPU), ring_graph(6),
                           num_iterations=200 * 6)
        gaps.append(float((state.xs - state.tokens[0]).norm(dim=1).max()))
    assert gaps[1] < gaps[0], f"consensus gap did not shrink: {gaps}"


# ---------------------------------------------------------------------------
# the descent inequalities (test_core_theory.py)
# ---------------------------------------------------------------------------


@cases(8)
def test_theorem1_descent(seed):
    rng = np.random.default_rng(seed)
    problem = random_lsq_problem(rng)
    tau = float(rng.uniform(0.2, 3.0))
    method = IBCD(problem, tau=tau, device=CPU)
    state, n = method.init(), problem.num_agents
    for k in range(n):        # a warm-up walk, so x and z are generic
        state = method.update(state, k % n)
    for _ in range(2 * n):
        agent = int(rng.integers(n))
        new = method.update(state, agent)
        dx = np_(new.xs[agent] - state.xs[agent])
        dz = np_(new.tokens[0] - state.tokens[0])
        bound = -tau / 2 * dx @ dx - tau * n / 2 * dz @ dz
        df = F(problem, new, tau) - F(problem, state, tau)
        assert df <= bound + 1e-8, f"Thm1: dF={df:.3e} bound={bound:.3e}"
        state = new


@pytest.mark.parametrize("gradient", [False, True], ids=["thm2", "thm3"])
@cases(8)
def test_theorems_2_and_3_descent_fresh_tokens(seed, gradient):
    """Thm 2 (API-BCD) and Thm 3 (gAPI-BCD, rho above L/2), in the
    fresh-token view that update_fresh realizes."""
    rng = np.random.default_rng(seed)
    problem = random_lsq_problem(rng)
    tau = float(rng.uniform(0.2, 2.0))
    if gradient:
        l_smooth = lsq_smoothness(problem)
        m = int(rng.integers(1, 4))
        rho = l_smooth / 2 + float(rng.uniform(0.1, 1.0))
        method = GAPIBCD(problem, tau=tau, num_walks=m, rho=rho, device=CPU)
        coeff, slack = tau * m / 2 + rho - l_smooth / 2, 1e-7
    else:
        m = int(rng.integers(2, 4))
        method = APIBCD(problem, tau=tau, num_walks=m, device=CPU)
        coeff, slack = tau * m / 2, 1e-8
    state, n = method.init(), problem.num_agents
    for k in range(n):        # the warm-up keeps z_m = mean x
        state = method.update_fresh(state, k % n)
    for _ in range(2 * n):
        agent = int(rng.integers(n))
        state.zhat[:] = state.tokens[None, :, :]
        new = method.update_fresh(state, agent)
        dx = np_(new.xs[agent] - state.xs[agent])
        dz = np_(new.tokens - state.tokens)
        bound = -coeff * dx @ dx - tau * n / 2 * float((dz * dz).sum())
        df = F(problem, new, tau) - F(problem, state, tau)
        assert df <= bound + slack, f"dF={df:.3e} bound={bound:.3e}"
        state = new


@cases(4)
def test_theorem1_descent_logistic(seed):
    """Thm 1 holds for any convex f_i: the Newton-CG prox too."""
    rng = np.random.default_rng(seed)
    problem = random_logistic_problem(rng)
    tau = float(rng.uniform(0.5, 2.0))
    method = IBCD(problem, tau=tau, newton_steps=30, device=CPU)
    state, n = method.init(), problem.num_agents
    for _ in range(2 * n):
        agent = int(rng.integers(n))
        new = method.update(state, agent)
        dx = np_(new.xs[agent] - state.xs[agent])
        dz = np_(new.tokens[0] - state.tokens[0])
        bound = -tau / 2 * dx @ dx - tau * n / 2 * dz @ dz
        df = F(problem, new, tau) - F(problem, state, tau)
        assert df <= bound + 1e-6, f"Thm1(logistic): dF={df:.3e}"
        state = new


def test_token_mean_invariant():
    """z^k = (1/N) sum_i x_i^k under init (6) and update (8)."""
    rng = np.random.default_rng(0)
    problem = random_lsq_problem(rng)
    method = IBCD(problem, tau=1.0, device=CPU)
    state, n = method.init(), problem.num_agents
    for _ in range(3 * n):
        state = method.update(state, int(rng.integers(n)))
        np.testing.assert_allclose(np_(state.tokens[0]),
                                   np_(state.xs.mean(dim=0)), atol=1e-10)


# ---------------------------------------------------------------------------
# the event simulator (test_core_simulator.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cpusmall():
    problem = make_problem("cpusmall", num_agents=20, subsample=2000, seed=0)
    net = random_graph(20, zeta=0.7, seed=0)
    return problem, net, hamiltonian_cycle(net)


def simulate(method, net, order, iters):
    walks = [CyclicWalk(order) for _ in range(method.num_walks)]
    return simulate_incremental(method, net, walks, max_iterations=iters,
                                eval_every=10)


def test_simulator_claims(cpusmall):
    """Monotone traces; API-BCD reaches NMSE 0.2 in less simulated time
    than I-BCD (Fig. 3b) and its 5 walks overlap in time; I-BCD uses a
    fifth of DGD's communication or less (Fig. 3a); WPG improves."""
    problem, net, order = cpusmall
    res_i = simulate(IBCD(problem, tau=1.0, device=CPU), net, order, 400)
    res_a = simulate(APIBCD(problem, tau=0.1, num_walks=5, device=CPU), net,
                     order, 400)
    t, c, _, m = res_i.as_arrays()
    assert (np.diff(t) >= 0).all() and (np.diff(c) >= 0).all()
    assert m[-1] < m[0], "NMSE did not improve"
    t_i, c_i = res_i.time_to_metric(0.2)
    t_a, _ = res_a.time_to_metric(0.2)
    assert t_i is not None and t_a is not None and t_a < t_i
    # the first 200 activations: 5 walks ~5x faster than one
    at = {k: tt for tt, _, k, _ in zip(*res_a.as_arrays())}
    it = {k: tt for tt, _, k, _ in zip(*res_i.as_arrays())}
    assert at[200] < 0.5 * it[200]
    dgd = DGD(problem, alpha=0.05, mixing=metropolis_hastings_matrix(net),
              device=CPU)
    _, c_g = simulate_gossip(dgd, net, max_rounds=400,
                             eval_every=5).time_to_metric(0.2)
    if c_g is None:
        c_g = 2 * net.num_links * 400     # gossip never got there
    assert c_i < c_g / 5, f"I-BCD comm {c_i} vs DGD comm {c_g}"
    _, _, _, m = simulate(WPG(problem, alpha=0.5, device=CPU), net, order,
                          300).as_arrays()
    assert m[-1] < m[0]


def test_markov_walk_simulation(cpusmall):
    problem, net, _ = cpusmall
    p = uniform_neighbor_matrix(net)
    method = APIBCD(problem, tau=0.25, num_walks=3, device=CPU)
    res = simulate_incremental(method, net, [MarkovWalk(p) for _ in range(3)],
                               max_iterations=200, eval_every=20, seed=1,
                               delay=DelayModel())
    _, _, k, m = res.as_arrays()
    assert m[-1] < m[0] and k[-1] == 200


# ---------------------------------------------------------------------------
# on the card, against the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def card_close(card, cpu, tol=1e-9):
    card, cpu = np_(card), np_(cpu)
    assert np.abs(card - cpu).max() <= tol * np.abs(cpu).max()


@pytest.mark.cuda
@pytest.mark.parametrize("name,sub", [("cpusmall", 2000), ("ijcnn1", 2000)])
def test_prox_on_card_matches_cpu(cuda, name, sub):
    problem = make_problem(name, num_agents=10, subsample=sub)
    rng = np.random.default_rng(0)
    z = torch.as_tensor(0.2 * rng.standard_normal(problem.dim))
    x0 = torch.as_tensor(0.2 * rng.standard_normal(problem.dim))
    for agent in (0, 7):
        got = L.make_batched_prox_solver(problem, 0.5, 3, device=cuda)(
            agent, z.to(cuda), x0.to(cuda))
        want = L.make_batched_prox_solver(problem, 0.5, 3, device=CPU)(
            agent, z, x0)
        assert got.device.type == "cuda" and got.dtype == torch.float64
        card_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cpusmall", "ijcnn1"])
def test_walk_on_card_matches_cpu(cuda, name):
    problem = make_problem(name, num_agents=10, subsample=2000)
    net = ring_graph(10)
    for dev in (cuda, CPU):
        method = APIBCD(problem, tau=0.1, num_walks=5, device=dev)
        state = run_serial(method, net, num_iterations=20)
        if dev == CPU:
            card_close(card.xs, state.xs)
            card_close(card.tokens, state.tokens)
        card = state
