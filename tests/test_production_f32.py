"""The f32 production path (the masked `lax.while_loop` every entry point
runs) against the f64 oracle, and its invariances: batch splits, warm
starts, dtype under x64 and the jit cache.  Per-iteration logging on the
same path is in tests/test_logging_production.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loik_tpu.api import DiffIkSolver
from loik_tpu.model import robots
from loik_tpu.oracle import OracleSolver
from loik_tpu.params import SolverParams
from loik_tpu.problem import make_problem
from loik_tpu.solver import solve
from loik_tpu.utils import no_recompile_guard

PARAMS = SolverParams(max_iter=100, tol_abs=1e-4, tol_rel=1e-4)


def _workload(robot="panda_arm", B=32, seed=0, dtype=jnp.float32):
    tree = robots.get(robot, str(np.dtype(dtype)))
    b = np.zeros((1, 6))
    b[0, 2] = 0.2
    prob = make_problem(
        tree, (tree.njoints - 1,), b=b,
        lb=-4 * np.ones(tree.nv), ub=4 * np.ones(tree.nv), dtype=dtype,
    )
    qs = tree.random_configuration(jax.random.PRNGKey(seed), (B,)).astype(dtype)
    return tree, prob, qs


@pytest.mark.parametrize("robot", ["panda_arm", "ur5", "solo12"])
def test_f32_solve_matches_oracle(robot):
    """Flags match the f64 oracle; converged f32 solutions agree with it to
    f32-at-tol-1e-4 accuracy (2e-3 leaves room for conditioning)."""
    tree, prob, qs = _workload(robot, B=8, seed=1)
    res = solve(tree, PARAMS, qs, prob)
    assert res.nu.dtype == jnp.float32
    tree64 = robots.get(robot, "float64")
    prob64 = make_problem(tree64, prob.constraint_links,
                          b=np.asarray(prob.b, np.float64),
                          lb=np.asarray(prob.lb, np.float64),
                          ub=np.asarray(prob.ub, np.float64))
    both = 0
    for i in range(6):
        o = OracleSolver(tree64, PARAMS).solve(np.asarray(qs[i], np.float64),
                                               prob64)
        assert (bool(res.converged[i]), bool(res.primal_infeasible[i])) == (
            o.converged, o.primal_infeasible)
        if o.converged:
            both += 1
            np.testing.assert_allclose(np.asarray(res.nu[i]), o.nu, atol=2e-3)
    assert both > 0


@pytest.mark.parametrize("check_interval", [1, 4])
def test_f32_batch_split_invariant(check_interval):
    """Problems are independent: solving any split of the batch reproduces
    the whole-batch solve bit for bit."""
    tree, prob, qs = _workload(B=48)
    params = PARAMS.replace(check_interval=check_interval)
    whole = solve(tree, params, qs, prob)
    parts = [solve(tree, params, qs[s], prob)
             for s in (slice(0, 16), slice(16, 48))]
    for name in ("nu", "iterations", "converged", "primal_infeasible"):
        np.testing.assert_array_equal(
            np.asarray(getattr(whole, name)),
            np.concatenate([np.asarray(getattr(p, name)) for p in parts]))


def test_f32_warm_start():
    """A warm re-solve of converged problems finishes within two
    iterations."""
    tree, prob, qs = _workload(B=16)
    params = PARAMS.replace(warm_start=True)
    cold = solve(tree, params, qs, prob)
    warm = solve(tree, params, qs, prob, cold.state)
    conv = np.asarray(cold.converged)
    assert conv.any()
    assert np.all(np.asarray(warm.iterations)[conv] <= 2)
    assert np.asarray(warm.converged)[conv].all()


def test_f32_outputs_stay_f32_under_x64():
    """x64 is on in this suite: f32 inputs still produce an f32 solve, the
    state included (no silent promotion to f64)."""
    assert jax.config.jax_enable_x64
    tree, prob, qs = _workload(B=8)
    res = solve(tree, PARAMS, qs, prob)
    for name in ("nu", "z", "vis", "primal_residual", "dual_residual"):
        assert getattr(res, name).dtype == jnp.float32, name
    floats = [x for x in jax.tree_util.tree_leaves(res.state)
              if jnp.issubdtype(x.dtype, jnp.floating)]
    assert floats and all(x.dtype == jnp.float32 for x in floats)


def test_f32_no_recompile_on_repeat():
    """Repeated f32 solves and tracking ticks of one shape hit the jit
    cache."""
    tree, prob, qs = _workload(B=16)
    solver = DiffIkSolver(tree, PARAMS.replace(warm_start=True),
                          prob.constraint_links, prob)
    ee = prob.constraint_links[0]
    b = np.zeros(6, np.float32)
    solve(tree, PARAMS, qs, prob)
    for _ in range(2):  # cold tick, then the warm-state signature
        solver.solve_tracking(qs, ee, b=b)
    with no_recompile_guard():
        for t in range(3):
            solve(tree, PARAMS, qs, prob)
            b[2] = 0.05 * t
            solver.solve_tracking(qs, ee, b=b)
