"""Batched fast solver vs oracle: the rebuild's analog of the reference's
oracle tests (`test_1st_order_loik_optimized_correctness*`,
tests/loik-loid.cpp:305-671) — the production path must reproduce the dense
oracle's trajectories, plus batched-specific semantics the reference has no
analog for (masked early exit, per-problem freeze, warm start as state)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loik_tpu.model import robots
from loik_tpu.oracle import OracleSolver
from loik_tpu.params import SolverParams
from loik_tpu.problem import make_problem
from loik_tpu.solver import solve

from tests.test_oracle import PANDA_Q, fixture_problem, fixture_q

TIGHT = SolverParams(max_iter=300, tol_abs=1e-6, tol_rel=1e-6)


def assert_matches_oracle(tree, params, q, problem, atol=1e-10):
    res = solve(tree, params, q, problem)
    orc = OracleSolver(tree, params).solve(np.asarray(q), problem)
    assert bool(res.converged[0]) == orc.converged
    assert int(res.iterations[0]) == orc.iterations
    np.testing.assert_allclose(np.asarray(res.nu[0]), orc.nu, atol=atol)
    np.testing.assert_allclose(np.asarray(res.vis[0]), orc.vis, atol=atol)
    np.testing.assert_allclose(np.asarray(res.z[0]), orc.z, atol=atol)
    np.testing.assert_allclose(
        float(res.primal_residual[0]), orc.primal_residual, atol=atol
    )
    np.testing.assert_allclose(float(res.dual_residual[0]), orc.dual_residual, atol=atol)
    return res, orc


@pytest.mark.parametrize("robot", [
    "ur5", "panda",
    pytest.param("solo12", marks=pytest.mark.slow),
    pytest.param("talos", marks=pytest.mark.slow),
])
def test_fast_matches_oracle_fixture(robot):
    tree = robots.get(robot)
    problem = fixture_problem(tree, b3=0.3)
    assert_matches_oracle(tree, TIGHT, fixture_q(tree), problem)


@pytest.mark.parametrize("robot", ["ur5", "panda"])
def test_fast_matches_oracle_random_q(robot):
    tree = robots.get(robot)
    problem = fixture_problem(tree, b3=0.2)
    for seed in range(3):
        q = tree.random_configuration(jax.random.PRNGKey(seed))
        assert_matches_oracle(tree, TIGHT, q, problem)


def test_fast_matches_oracle_multi_constraint():
    """Solo-12: constraints at all four feet + the base (BASELINE configs[2])."""
    tree = robots.solo12()
    feet = tree.leaf_joints
    c_links = (0,) + feet
    b = np.zeros((len(c_links), 6))
    b[0, 2] = 0.1  # base heave
    problem = make_problem(
        tree, c_links, b=b, lb=-10 * np.ones(tree.nv), ub=10 * np.ones(tree.nv)
    )
    assert_matches_oracle(tree, TIGHT, tree.neutral(), problem)


def test_fast_matches_oracle_mu_adaptation():
    """Parameters where mu adapts both up and down (rp/rd ratio crossing 10),
    exercising the per-problem (B,) penalty vector against the scalar spec."""
    tree = robots.ur5()
    problem = fixture_problem(tree, b3=0.4)
    params = SolverParams(
        max_iter=300, tol_abs=1e-8, tol_rel=1e-8, mu=1e-5, mu_equality_scale_factor=10.0
    )
    res, orc = assert_matches_oracle(tree, params, tree.neutral(), problem, atol=1e-8)
    # make sure this case exercised the adaptation
    assert len(set(orc.info.mus)) > 1


def test_fast_batched_matches_per_problem_solves():
    """Each problem in a batch with different q must equal its own
    single-problem solve — the masked-freeze correctness test (no reference
    analog; SURVEY.md §7 hard part 4)."""
    tree = robots.panda()
    problem = fixture_problem(tree, b3=0.2)
    B = 6
    qs = tree.random_configuration(jax.random.PRNGKey(7), (B,))
    # guarantee heterogeneous stopping points: a known fast-converging config
    # and the singular neutral config (primal-infeasible -> tail solve), so
    # the masked freeze is actually exercised
    qs = qs.at[0].set(jnp.asarray(PANDA_Q))
    qs = qs.at[1].set(tree.neutral())
    res = solve(tree, TIGHT, qs, problem)
    iters = set()
    for i in range(B):
        ri = solve(tree, TIGHT, qs[i], problem)
        np.testing.assert_allclose(
            np.asarray(res.nu[i]), np.asarray(ri.nu[0]), atol=1e-10
        )
        assert int(res.iterations[i]) == int(ri.iterations[0])
        assert bool(res.converged[i]) == bool(ri.converged[0])
        iters.add(int(ri.iterations[0]))
    assert len(iters) >= 2, f"batch stopping points not heterogeneous: {iters}"


def test_fast_batched_heterogeneous_targets():
    """Batch where per-problem b differs (leading-batch problem leaves),
    including one infeasible member — flags must be per-problem."""
    tree = robots.panda()
    B = 4
    b = np.zeros((B, 1, 6))
    b[:, 0, 2] = [0.1, 0.3, 0.5, 50.0]  # last one unreachable
    problem = make_problem(
        tree,
        (tree.njoints - 1,),
        b=np.zeros((1, 6)),
        lb=-4.0 * np.ones(tree.nv),
        ub=4.0 * np.ones(tree.nv),
    ).replace(b=jnp.asarray(b))
    qs = jnp.broadcast_to(jnp.asarray(PANDA_Q), (B, 9))
    res = solve(tree, TIGHT, qs, problem)
    assert bool(res.converged[0]) and bool(res.converged[1]) and bool(res.converged[2])
    assert not bool(res.converged[3])
    # per-problem single solves agree
    for i in range(B):
        pi = problem.replace(b=jnp.asarray(b[i]))
        ri = solve(tree, TIGHT, PANDA_Q, pi)
        np.testing.assert_allclose(np.asarray(res.nu[i]), np.asarray(ri.nu[0]), atol=1e-9)
        assert int(res.iterations[i]) == int(ri.iterations[0])
        assert bool(res.primal_infeasible[i]) == bool(ri.primal_infeasible[0])


def test_fast_repeated_solve_deterministic():
    """State leakage across solves (reset tests, tests/loik-loid.cpp:674-984):
    5 repeated solves must give bitwise-identical results."""
    tree = robots.ur5()
    problem = fixture_problem(tree)
    q = tree.neutral()
    first = solve(tree, TIGHT, q, problem)
    for _ in range(4):
        again = solve(tree, TIGHT, q, problem)
        np.testing.assert_array_equal(np.asarray(first.nu), np.asarray(again.nu))
        assert int(first.iterations[0]) == int(again.iterations[0])


def test_fast_warm_start():
    """Warm starting from the converged state must converge at least as fast
    and to the same solution (Reset(warm_start) semantics,
    loik-loid-data-optimized.hxx:114-127)."""
    tree = robots.panda()
    problem = fixture_problem(tree, b3=0.2)
    cold = solve(tree, TIGHT, PANDA_Q, problem)
    warm_params = TIGHT.replace(warm_start=True)
    warm = solve(tree, warm_params, PANDA_Q, problem, warm_state=cold.state)
    assert bool(warm.converged[0])
    assert int(warm.iterations[0]) <= int(cold.iterations[0])
    np.testing.assert_allclose(np.asarray(warm.nu[0]), np.asarray(cold.nu[0]), atol=1e-5)


def test_fast_infeasibility_parity():
    """Panda at neutral (singular): primal infeasibility must be detected and
    the tail solve leave the iterates stationary (cf. oracle test)."""
    tree = robots.panda()
    problem = fixture_problem(tree)
    params = SolverParams(max_iter=300, tol_abs=1e-8, tol_rel=1e-8)
    res = solve(tree, params, tree.neutral(), problem)
    assert not bool(res.converged[0])
    assert bool(res.primal_infeasible[0])
    assert float(res.state.delta_x_inf[0]) < params.tol_tail_solve
    assert float(res.state.delta_z_inf[0]) < params.tol_tail_solve
    orc = OracleSolver(tree, params).solve(np.asarray(tree.neutral()), problem)
    assert orc.primal_infeasible


def test_fast_logging():
    tree = robots.ur5()
    problem = fixture_problem(tree)
    params = TIGHT.replace(logging=True)
    res = solve(tree, params, tree.neutral(), problem)
    n = int(res.iterations[0])
    rp = np.asarray(res.log_rp[:, 0])
    assert np.all(np.isfinite(rp[:n]))
    assert np.all(np.isnan(rp[n:]))
    # logged residuals decrease overall
    assert rp[n - 1] < rp[0]


def test_fast_f32():
    """f32 path (the production default) still converges at loose tolerance."""
    tree = robots.ur5("float32")
    problem = fixture_problem(tree)
    params = SolverParams(max_iter=200, tol_abs=1e-3, tol_rel=1e-3)
    q = tree.neutral().astype(jnp.float32)
    res = solve(tree, params, q, problem)
    assert res.nu.dtype == jnp.float32
    assert bool(res.converged[0])
    orc = OracleSolver(robots.ur5(), SolverParams(max_iter=200)).solve(
        np.asarray(tree.neutral(), np.float64), fixture_problem(robots.ur5())
    )
    np.testing.assert_allclose(np.asarray(res.nu[0]), orc.nu, atol=1e-3)


def test_tail_solve_off_freezes_at_detection():
    # tail_solve=False must (a) flag the same problems primal-infeasible,
    # (b) spend zero tail iterations on them, (c) leave converged problems
    # bit-identical (the tail only touches infeasible problems)
    import jax
    import jax.numpy as jnp

    tree = robots.panda_arm("float32")
    b = np.zeros((1, 6)); b[0, 2] = 0.2
    prob = make_problem(tree, (6,), b=b, lb=-4 * np.ones(7), ub=4 * np.ones(7),
                        dtype=jnp.float32)
    qs = tree.random_configuration(jax.random.PRNGKey(11), (256,)).astype(jnp.float32)
    p_on = SolverParams(max_iter=64, tol_abs=2e-5, tol_rel=2e-5)
    p_off = p_on.replace(tail_solve=False)
    r_on = solve(tree, p_on, qs, prob)
    r_off = solve(tree, p_off, qs, prob)
    np.testing.assert_array_equal(np.asarray(r_on.primal_infeasible),
                                  np.asarray(r_off.primal_infeasible))
    np.testing.assert_array_equal(np.asarray(r_on.converged),
                                  np.asarray(r_off.converged))
    assert np.asarray(r_off.tail_iterations).max() == 0
    pinf = np.asarray(r_on.primal_infeasible)
    assert pinf.any()
    it_on = np.asarray(r_on.iterations)
    it_off = np.asarray(r_off.iterations)
    assert (it_off[pinf] <= it_on[pinf]).all()
    assert it_off[pinf].mean() < it_on[pinf].mean()
    conv = np.asarray(r_on.converged)
    np.testing.assert_array_equal(np.asarray(r_on.nu)[conv],
                                  np.asarray(r_off.nu)[conv])


def test_spd_inv_matches_linalg_inv():
    import jax.numpy as jnp
    from loik_tpu.solver import batched_spatial as bsp

    rng = np.random.default_rng(7)
    for k in (1, 2, 3, 6):
        A = rng.normal(size=(5, k, k, 16))
        D = np.einsum("...ijb,...kjb->...ikb", A, A) + 0.1 * np.eye(k)[:, :, None]
        got = np.asarray(bsp.spd_inv(jnp.asarray(D)))
        want = np.linalg.inv(np.moveaxis(D, -1, 1))
        np.testing.assert_allclose(got, np.moveaxis(want, 1, -1), atol=1e-9)


def test_logging_per_block_residuals_match_oracle():
    """params.logging returns per-iteration per-block residual components,
    penalty split and tail diagnostics (the batched LoikSolverInfo,
    loik-loid.hpp:40-121) matching the oracle's logs at 1e-10."""
    tree = robots.panda()
    problem = fixture_problem(tree, b3=0.2)
    q = fixture_q(tree)
    params = TIGHT.replace(logging=True, max_iter=60)
    res = solve(tree, params, q, problem)
    orc = OracleSolver(tree, params).solve(np.asarray(q), problem)
    T = orc.iterations
    info = orc.info
    pairs = [
        (res.log_rp, info.primal_residuals),
        (res.log_rd, info.dual_residuals),
        (res.log_mu, info.mus),
        (res.log_rp_task, info.primal_residuals_task),
        (res.log_rp_slack, info.primal_residuals_slack),
        (res.log_rd_v, info.dual_residuals_v),
        (res.log_rd_nu, info.dual_residuals_nu),
        (res.log_mu_eq, info.mu_eqs),
        (res.log_mu_ineq, info.mu_ineqs),
        (res.log_dx, info.delta_x_infs),
        (res.log_dz, info.delta_z_infs),
    ]
    for fast, want in pairs:
        got = np.asarray(fast)[:T, 0]
        assert np.all(np.isfinite(got)), got
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-10)
    # beyond the stopping iteration the logs stay NaN (problem frozen)
    assert np.all(np.isnan(np.asarray(res.log_rp)[T:, 0]))


def test_logging_tail_solve_flags():
    """Tail-solve iterations are flagged in log_in_tail, and masking the
    per-iteration logs by it recovers the reference's tail_solve_*_list_
    content (unreachable-target fixture: certified primal-infeasible)."""
    tree = robots.panda()
    problem = fixture_problem(tree, b3=50.0)  # unreachable: certified infeasible
    params = TIGHT.replace(logging=True, max_iter=80, tail_solve=True)
    res = solve(tree, params, jnp.asarray(PANDA_Q), problem)
    assert bool(res.primal_infeasible[0])
    n_tail = int(res.tail_iterations[0])
    assert n_tail > 0
    in_tail = np.asarray(res.log_in_tail)[:, 0]
    assert np.nansum(in_tail) == n_tail
    orc = OracleSolver(tree, params).solve(np.asarray(PANDA_Q), problem)
    assert orc.primal_infeasible
    assert orc.tail_solve_iterations == n_tail
    # the flagged block sits at the END of the ran-iterations window
    T = int(res.iterations[0])
    np.testing.assert_array_equal(in_tail[T - n_tail:T], 1.0)
