"""Observability + checkpoint utilities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loik_tpu.model import robots
from loik_tpu.params import SolverParams
from loik_tpu.problem import make_problem
from loik_tpu.solver import solve
from loik_tpu.utils import load_state, no_recompile_guard, save_state

from tests.test_oracle import fixture_problem

PARAMS = SolverParams(max_iter=100, tol_abs=1e-6, tol_rel=1e-6)


def test_no_recompile_guard_passes_when_warm():
    tree = robots.ur5()
    problem = fixture_problem(tree)
    q = tree.neutral()
    solve(tree, PARAMS, q, problem)  # warm up
    with no_recompile_guard():
        for _ in range(3):
            solve(tree, PARAMS, q, problem)


def test_no_recompile_guard_detects_shape_leak():
    tree = robots.ur5()
    problem = fixture_problem(tree)
    solve(tree, PARAMS, tree.neutral(), problem)
    with pytest.raises(RuntimeError, match="no_recompile_guard"):
        with no_recompile_guard():
            # new batch shape -> recompile -> the guard must fire
            qs = jnp.broadcast_to(tree.neutral(), (3, tree.nq))
            solve(tree, PARAMS, qs, problem)


def test_checkpoint_roundtrip(tmp_path):
    tree = robots.ur5()
    problem = fixture_problem(tree)
    res = solve(tree, PARAMS, tree.neutral(), problem)
    path = str(tmp_path / "state.npz")
    save_state(path, res.state)
    restored = load_state(path, res.state)
    for a, b in zip(
        jax.tree_util.tree_leaves(res.state), jax.tree_util.tree_leaves(restored)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # resuming from the restored state works (warm start)
    warm = solve(
        tree, PARAMS.replace(warm_start=True), tree.neutral(), problem, restored
    )
    assert int(warm.iterations[0]) <= int(res.iterations[0])


def test_verbose_console_mode(capfd):
    """params.verbose streams an iteration banner + terminal notices to the
    host console (the reference's verbose_ mode, loik-loid.hpp:501-506,
    loik-loid.hxx:320/345/362 — batched, so lines report batch aggregates)."""
    tree = robots.ur5()
    b = np.zeros((1, 6))
    b[0, 2] = 0.1
    problem = make_problem(tree, (tree.njoints - 1,), b=b,
                           lb=-2 * np.ones(tree.nv), ub=2 * np.ones(tree.nv))
    params = SolverParams(max_iter=40, tol_abs=1e-6, tol_rel=1e-6,
                          verbose=True)
    q = tree.random_configuration(jax.random.PRNGKey(0), (4,))
    res = solve(tree, params, q, problem)
    jax.effects_barrier()
    out = capfd.readouterr().out
    assert "[loik] iter 1:" in out
    assert "primal res" in out and "dual res" in out
    assert "[loik] solve finished:" in out


def test_verbose_infeasibility_warning(capfd):
    """An infeasible batch (empty box) triggers the WARNING line."""
    tree = robots.ur5()
    b = np.zeros((1, 6))
    b[0, 2] = 1.0  # commanded EE velocity with all joints pinned to zero
    problem = make_problem(tree, (tree.njoints - 1,), b=b,
                           lb=np.zeros(tree.nv), ub=np.zeros(tree.nv))
    params = SolverParams(max_iter=60, tol_abs=1e-6, tol_rel=1e-6,
                          verbose=True, tail_solve=False)
    q = tree.random_configuration(jax.random.PRNGKey(1), (2,))
    res = solve(tree, params, q, problem)
    jax.effects_barrier()
    out = capfd.readouterr().out
    assert bool(np.asarray(res.primal_infeasible).any())
    assert "WARNING" in out and "infeasible" in out


def test_verbose_f32_tracking_tick(capfd):
    """verbose runs on the f32 production tracking tick too."""
    from loik_tpu.api import DiffIkSolver

    tree = robots.get("ur5", "float32")
    b = np.zeros((1, 6))
    problem = make_problem(tree, (tree.njoints - 1,), b=b,
                           lb=-2 * np.ones(tree.nv), ub=2 * np.ones(tree.nv),
                           dtype=jnp.float32)
    params = SolverParams(max_iter=40, tol_abs=1e-4, tol_rel=1e-4,
                          verbose=True, warm_start=True)
    q = tree.random_configuration(jax.random.PRNGKey(0), (4,)).astype(
        jnp.float32)
    solver = DiffIkSolver(tree, params, (tree.njoints - 1,), problem=problem)
    res = solver.solve_tracking(q, tree.njoints - 1, b=np.full(6, 0.01))
    jax.effects_barrier()
    out = capfd.readouterr().out
    assert "[loik] solve finished:" in out
    assert res.nu.dtype == jnp.float32
    assert bool(np.asarray(res.converged).any())
