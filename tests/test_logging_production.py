"""params.logging on the f32 production path: the per-iteration logs
describe the production run itself (plain and check_interval schedules,
warm tracking ticks, sub-batches), and logging changes no outcome."""

import jax.numpy as jnp
import numpy as np
import pytest

from loik_tpu.api import DiffIkSolver
from loik_tpu.solver import solve

from tests.test_production_f32 import PARAMS, _workload


def _check_logs(res, params):
    log_rp = np.asarray(res.log_rp)
    iters = np.asarray(res.iterations)
    K = params.check_interval
    assert log_rp.shape == (params.max_iter, iters.shape[0])
    for j, it in enumerate(iters):
        ran = log_rp[:it, j]
        assert np.isfinite(ran[K - 1::K]).all()      # check slots
        if K > 1:
            assert np.isnan(ran[0::K]).all()         # skipped slots
        assert np.isnan(log_rp[it:, j]).all()        # frozen after stop
        if it:
            np.testing.assert_allclose(log_rp[it - 1, j],
                                       float(res.primal_residual[j]),
                                       rtol=1e-6)


@pytest.mark.parametrize("check_interval", [1, 4])
def test_logging_production_solve(check_interval):
    """params.logging on the f32 production solve: residual logs cover
    exactly the iterations each problem ran, on the K schedule, and end at
    the reported residual."""
    tree, prob, qs = _workload(B=32, seed=3)
    params = PARAMS.replace(max_iter=60, logging=True,
                            check_interval=check_interval)
    res = solve(tree, params, qs, prob)
    assert res.log_rp.dtype == jnp.float32
    _check_logs(res, params)


def test_logging_matches_unlogged_solve():
    """Logging changes no outcome: flags, iterations and nu equal the
    unlogged solve."""
    tree, prob, qs = _workload(B=32, seed=3)
    plain = solve(tree, PARAMS, qs, prob)
    logged = solve(tree, PARAMS.replace(logging=True), qs, prob)
    for name in ("nu", "iterations", "converged", "primal_infeasible"):
        np.testing.assert_array_equal(np.asarray(getattr(plain, name)),
                                      np.asarray(getattr(logged, name)))


def test_logging_warm_tick():
    """A logged warm tracking tick (DiffIkSolver.solve_tracking) logs only
    its own few iterations."""
    tree, prob, qs = _workload(B=16, seed=4)
    params = PARAMS.replace(warm_start=True, logging=True)
    solver = DiffIkSolver(tree, params, prob.constraint_links, prob)
    ee = prob.constraint_links[0]
    cold = solver.solve_tracking(qs, ee, b=np.asarray(prob.b[0]))
    warm = solver.solve_tracking(qs, ee, b=np.asarray(prob.b[0]))
    _check_logs(cold, params)
    _check_logs(warm, params)
    conv = np.asarray(cold.converged)
    assert np.all(np.asarray(warm.iterations)[conv] <= 2)


def test_logging_sub_batch():
    """Logging a sub-batch reproduces the whole batch's log columns for
    those problems."""
    tree, prob, qs = _workload(B=32, seed=5)
    params = PARAMS.replace(max_iter=60, logging=True)
    whole = solve(tree, params, qs, prob)
    idx = np.array([3, 17, 30])
    sub = solve(tree, params, qs[idx], prob)
    np.testing.assert_array_equal(np.asarray(sub.log_rp),
                                  np.asarray(whole.log_rp)[:, idx])
    np.testing.assert_array_equal(np.asarray(sub.iterations),
                                  np.asarray(whole.iterations)[idx])
