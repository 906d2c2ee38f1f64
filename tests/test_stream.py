"""Device-resident tracking streams (`solve_stream` / `track_scan`) vs a
Python loop of per-tick `solve_tracking`: identical trajectories.

The stream is the public form of the scanned tick driver the bench's 1 kHz
device-side tracking number is measured on (VERDICT r3 next step 1;
reference tailored control overload loik-loid-optimized.hpp:596-695)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loik_tpu.api import DiffIkSolver
from loik_tpu.model import robots
from loik_tpu.params import SolverParams
from loik_tpu.problem import make_problem
from loik_tpu.solver.stream import solve_stream


def _setup(dtype=jnp.float64, B=8, warm=True):
    tree = robots.get("ur5", str(np.dtype(dtype)))
    b = np.zeros((1, 6))
    b[0, 2] = 0.1
    problem = make_problem(tree, (tree.njoints - 1,), b=b,
                           lb=-2 * np.ones(tree.nv), ub=2 * np.ones(tree.nv),
                           dtype=dtype)
    params = SolverParams(max_iter=60, tol_abs=1e-5, tol_rel=1e-5,
                          warm_start=warm)
    q = tree.random_configuration(jax.random.PRNGKey(0), (B,)).astype(dtype)
    return tree, params, problem, q


def _b_seq(T, dtype):
    b_seq = np.zeros((T, 6))
    b_seq[:, 2] = 0.1 * np.cos(2 * np.pi * np.arange(T) / T)
    b_seq[:, 0] = 0.05 * np.sin(2 * np.pi * np.arange(T) / T)
    return b_seq.astype(dtype)


def test_track_scan_matches_tick_loop():
    """One scanned program == T sequential solve_tracking dispatches."""
    tree, params, problem, q = _setup()
    T = 6
    b_seq = _b_seq(T, np.float64)
    ee = tree.njoints - 1

    s_loop = DiffIkSolver(tree, params, (ee,), problem=problem)
    loop_nu, loop_conv, loop_iters = [], [], []
    for t in range(T):
        res = s_loop.solve_tracking(q, ee, b=b_seq[t])
        loop_nu.append(np.asarray(res.nu))
        loop_conv.append(np.asarray(res.converged))
        loop_iters.append(np.asarray(res.iterations))

    s_scan = DiffIkSolver(tree, params, (ee,), problem=problem)
    stream = s_scan.track_scan(q, b_seq)
    np.testing.assert_allclose(np.asarray(stream.nu), np.stack(loop_nu),
                               rtol=1e-12, atol=1e-12)
    assert np.array_equal(np.asarray(stream.converged), np.stack(loop_conv))
    assert np.array_equal(np.asarray(stream.iterations), np.stack(loop_iters))
    # warm state carries out: further per-tick calls continue seamlessly
    res_next = s_scan.solve_tracking(q, ee, b=b_seq[-1])
    res_next_loop = s_loop.solve_tracking(q, ee, b=b_seq[-1])
    np.testing.assert_allclose(np.asarray(res_next.nu),
                               np.asarray(res_next_loop.nu),
                               rtol=1e-12, atol=1e-12)
    # and the solver's problem holds the final tick's target
    np.testing.assert_allclose(np.asarray(s_scan.problem.b)[0], b_seq[-1])


def test_stream_per_tick_q_and_A():
    """(T, B, nq) configuration streams and per-tick A updates both apply."""
    tree, params, problem, q = _setup(B=4)
    T = 4
    b_seq = _b_seq(T, np.float64)
    keys = jax.random.split(jax.random.PRNGKey(3), T)
    q_seq = jnp.stack([tree.random_configuration(k, (4,)) for k in keys])
    A_seq = np.tile(np.eye(6), (T, 1, 1))
    A_seq[:, 0, 0] = np.linspace(1.0, 0.5, T)  # de-weight v_x over the horizon

    stream = solve_stream(tree, params, q_seq, problem, 0, b_seq,
                          A_seq=A_seq)
    assert stream.nu.shape == (T, 4, tree.nv)

    # equivalent eager loop: update A and b, solve with per-tick q
    from loik_tpu.solver import solve

    st = None
    for t in range(T):
        prob_t = problem.update_constraint(0, A=A_seq[t], b=b_seq[t])
        res = solve(tree, params, q_seq[t], prob_t, st)
        st = res.state
        np.testing.assert_allclose(np.asarray(stream.nu[t]),
                                   np.asarray(res.nu),
                                   rtol=1e-12, atol=1e-12)
        assert np.array_equal(np.asarray(stream.converged[t]),
                              np.asarray(res.converged))


def test_stream_f32_matches_tick_loop():
    """The f32 stream equals a Python loop of f32 `solve_tracking` ticks
    (the production tracking tick) and stays f32 under x64."""
    tree, params, problem, q = _setup(dtype=jnp.float32, B=8)
    T = 3
    b_seq = _b_seq(T, np.float32)
    stream = solve_stream(tree, params, q, problem, 0, b_seq)
    assert stream.nu.dtype == jnp.float32
    solver = DiffIkSolver(tree, params, (tree.njoints - 1,), problem=problem)
    for t in range(T):
        res = solver.solve_tracking(q, tree.njoints - 1, b=b_seq[t])
        np.testing.assert_allclose(np.asarray(stream.nu[t]),
                                   np.asarray(res.nu), rtol=1e-6, atol=1e-6)
        assert np.array_equal(np.asarray(stream.converged[t]),
                              np.asarray(res.converged))
        assert np.array_equal(np.asarray(stream.iterations[t]),
                              np.asarray(res.iterations))


def test_stream_rejects_logging():
    tree, params, problem, q = _setup()
    with pytest.raises(ValueError, match="logging"):
        solve_stream(tree, params.replace(logging=True), q, problem, 0,
                     _b_seq(2, np.float64))


def test_track_scan_link_validation():
    tree, params, problem, q = _setup()
    solver = DiffIkSolver(tree, params, (tree.njoints - 1,), problem=problem)
    with pytest.raises(ValueError, match="no constraint"):
        solver.track_scan(q, _b_seq(2, np.float64), link=0)


def test_delta_stream_matches_eager_warm_loop():
    """refine='delta' streams the tol-1e-6 path: each tick == an eager
    solve_delta_duals warm-started from the previous tick's (full-space)
    state."""
    from loik_tpu.solver.refine import solve_delta_duals

    tree, params, problem, q = _setup(dtype=jnp.float64, B=4)
    params = params.replace(tol_abs=1e-6, tol_rel=1e-6)
    T = 3
    b_seq = _b_seq(T, np.float64)

    stream = solve_stream(tree, params, q, problem, 0, b_seq,
                          refine="delta")
    st = None
    for t in range(T):
        prob_t = problem.update_constraint(0, b=b_seq[t])
        res = solve_delta_duals(tree, params, q, prob_t, warm_state=st)
        st = res.state
        np.testing.assert_allclose(np.asarray(stream.nu[t]),
                                   np.asarray(res.nu),
                                   rtol=1e-12, atol=1e-12)
        assert np.array_equal(np.asarray(stream.converged[t]),
                              np.asarray(res.converged))
        assert np.array_equal(np.asarray(stream.iterations[t]),
                              np.asarray(res.iterations))
