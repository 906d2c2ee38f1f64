"""check_interval (OSQP's check_termination knob): K-1 check-free ADMM
iterations between convergence/infeasibility checks.

K=1 is the reference's per-iteration semantics (loik-loid-optimized.hpp:
502-577) and compiles the identical program; K>1 trades detection
granularity for skipping the residual half of the loop body (the BwdPass2
dual-residual sweep, the norm reductions, the certificate pieces and the
masked merges) on skipped iterations.  Solutions still satisfy the same
residual tolerances at the check — pinned here against the K=1 path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loik_tpu.model import robots
from loik_tpu.params import SolverParams
from loik_tpu.problem import make_problem
from loik_tpu.solver import solve

from tests.test_oracle import fixture_problem, fixture_q

TIGHT = SolverParams(max_iter=300, tol_abs=1e-6, tol_rel=1e-6)


def test_check_interval_validation():
    with pytest.raises(ValueError):
        SolverParams(check_interval=0)
    with pytest.raises(ValueError):
        SolverParams(check_interval=-2)


@pytest.mark.parametrize("K", [2, 4])
def test_check_interval_converges_to_same_solution(K):
    """K>1 must reach the same tolerances; iterations land on multiples of K
    and never undercut the K=1 count."""
    tree = robots.panda()
    problem = fixture_problem(tree, b3=0.3)
    q = fixture_q(tree)
    r1 = solve(tree, TIGHT, q, problem)
    rK = solve(tree, TIGHT.replace(check_interval=K), q, problem)
    assert bool(rK.converged[0])
    itK = int(rK.iterations[0])
    it1 = int(r1.iterations[0])
    assert itK % K == 0
    assert it1 <= itK <= K * ((it1 + K - 1) // K)
    # both satisfy the same adaptive tolerances; the iterates agree to the
    # tolerance scale (they are different iterates of the same contraction)
    assert float(rK.primal_residual[0]) <= float(r1.primal_residual[0]) * 50 + 1e-6
    np.testing.assert_allclose(
        np.asarray(rK.nu[0]), np.asarray(r1.nu[0]), atol=5e-5
    )


def test_check_interval_batch_masking():
    """Frozen problems must be restored wholesale across the K-unrolled body:
    solving a batch where problems converge at different checks must equal
    solving each problem alone."""
    K = 3
    tree = robots.ur5()
    problem = fixture_problem(tree, b3=0.2)
    qs = tree.random_configuration(jax.random.PRNGKey(0), (5,))
    params = TIGHT.replace(check_interval=K)
    batch = solve(tree, params, qs, problem)
    iters = set()
    for i in range(5):
        single = solve(tree, params, qs[i : i + 1], problem)
        np.testing.assert_array_equal(
            np.asarray(batch.converged[i]), np.asarray(single.converged[0])
        )
        assert int(batch.iterations[i]) == int(single.iterations[0])
        np.testing.assert_allclose(
            np.asarray(batch.nu[i]), np.asarray(single.nu[0]), atol=1e-12
        )
        iters.add(int(single.iterations[0]))
    assert all(it % K == 0 for it in iters)


def test_check_interval_f32_subbatch_invariant():
    """The K-unrolled body in f32 is per-problem: solving two halves of a
    batch reproduces the whole-batch solve exactly, iteration counts stay
    on multiples of K."""
    K = 2
    tree = robots.get("panda_arm", "float32")
    b = np.zeros((1, 6))
    b[0, 2] = 0.2
    prob = make_problem(
        tree, (tree.njoints - 1,), b=b,
        lb=-4 * np.ones(tree.nv), ub=4 * np.ones(tree.nv), dtype=jnp.float32,
    )
    qs = tree.random_configuration(jax.random.PRNGKey(1), (32,)).astype(
        jnp.float32
    )
    params = SolverParams(max_iter=60, tol_abs=1e-4, tol_rel=1e-4,
                          check_interval=K)
    whole = solve(tree, params, qs, prob)
    halves = [solve(tree, params, qs[s], prob)
              for s in (slice(0, 16), slice(16, 32))]
    for name in ("nu", "iterations", "converged", "primal_infeasible"):
        np.testing.assert_array_equal(
            np.asarray(getattr(whole, name)),
            np.concatenate([np.asarray(getattr(h, name)) for h in halves]))
    assert (np.asarray(whole.iterations) % K == 0).all()
    assert np.asarray(whole.converged).mean() > 0.5


def test_check_interval_infeasible_still_detected():
    """A certified-infeasible problem (flagship probe: EE velocity outside
    the box) must still be flagged under K>1 — detection may lag by up to
    K-1 checks but never vanish."""
    tree = robots.panda()
    # commanded EE velocity far outside what |nu| <= 0.01 can produce
    b = np.zeros((1, 6))
    b[0, 2] = 5.0
    problem = make_problem(
        tree, (tree.njoints - 1,), b=b,
        lb=-0.01 * np.ones(tree.nv), ub=0.01 * np.ones(tree.nv),
    )
    q = fixture_q(tree)
    params = SolverParams(max_iter=200, tol_abs=1e-6, tol_rel=1e-6)
    r1 = solve(tree, params, q, problem)
    assert bool(r1.primal_infeasible[0])
    rK = solve(tree, params.replace(check_interval=4), q, problem)
    assert bool(rK.primal_infeasible[0])


def test_check_interval_logging_nan_slots():
    """With logging, skipped iterations' log slots stay NaN; check slots
    carry the residuals."""
    K = 3
    tree = robots.ur5()
    problem = fixture_problem(tree, b3=0.2)
    q = fixture_q(tree)
    res = solve(tree, TIGHT.replace(check_interval=K, logging=True), q,
                problem)
    it = int(res.iterations[0])
    log_rp = np.asarray(res.log_rp[:, 0])
    for j in range(it):
        if (j + 1) % K == 0:
            assert np.isfinite(log_rp[j])
        else:
            assert np.isnan(log_rp[j])
    assert np.isnan(log_rp[it:]).all()
