"""Differentiable solves: gradients through the unrolled solver vs central
finite differences (f64, CPU).  No reference analog — net-new
surface (see solver/diff.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from loik_tpu.model import robots
from loik_tpu.params import SolverParams
from loik_tpu.problem import make_problem
from loik_tpu.solver import solve
from loik_tpu.solver.diff import solve_unrolled

PARAMS = SolverParams(tol_abs=1e-10, tol_rel=1e-10)


def _setup():
    tree = robots.ur5()
    A = np.zeros((1, 6, 6))
    A[0, 2, 2] = 1.0                      # one effective task row (v_z)
    b = np.zeros((1, 6))
    b[0, 2] = 0.1
    problem = make_problem(tree, (tree.njoints - 1,), A=A, b=b,
                           lb=-10 * np.ones(tree.nv),
                           ub=10 * np.ones(tree.nv))
    q = tree.random_configuration(jax.random.PRNGKey(3), (2,))
    return tree, problem, q


def test_unrolled_matches_while_loop_solve():
    """Same body, fixed unroll: primal outputs match the masked while-loop
    production solve once both have converged."""
    tree, problem, q = _setup()
    params = SolverParams(max_iter=100, tol_abs=1e-9, tol_rel=1e-9)
    res_w = solve(tree, params, q, problem)
    res_u = solve_unrolled(tree, params, q, problem, num_iters=60)
    assert bool(np.asarray(res_u.converged).all())
    np.testing.assert_allclose(np.asarray(res_u.nu), np.asarray(res_w.nu),
                               rtol=1e-8, atol=1e-10)


def test_grad_wrt_task_target_matches_fd():
    """d loss / d b through the whole ADMM solve vs central differences."""
    tree, problem, q = _setup()

    def loss(bz):
        prob = problem.replace(b=problem.b.at[0, 2].set(bz))
        res = solve_unrolled(tree, PARAMS, q, prob, num_iters=60)
        return jnp.sum(res.nu ** 2)

    bz0 = 0.1
    g = jax.grad(loss)(jnp.asarray(bz0, jnp.float64))
    eps = 1e-5
    fd = (loss(bz0 + eps) - loss(bz0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-4)


def test_grad_wrt_configuration_matches_fd():
    """d loss / d q flows through FK into the solve."""
    tree, problem, q = _setup()

    def loss(qv):
        res = solve_unrolled(tree, PARAMS, qv, problem, num_iters=60)
        return jnp.sum(res.nu ** 2)

    g = jax.grad(loss)(q)
    eps = 1e-6
    # spot-check two coordinates of the gradient
    for (bi, ji) in [(0, 1), (1, 4)]:
        qp = q.at[bi, ji].add(eps)
        qm = q.at[bi, ji].add(-eps)
        fd = (loss(qp) - loss(qm)) / (2 * eps)
        np.testing.assert_allclose(float(g[bi, ji]), float(fd), rtol=5e-4,
                                   atol=1e-8)


def test_grad_with_active_box_constraint():
    """With a binding box bound the clamped dof's velocity is pinned: its
    gradient w.r.t. the target goes to ~0 while free dofs keep nonzero
    sensitivity (subgradient of the projection, as in unrolled OptNet-style
    layers)."""
    tree, problem, q = _setup()
    # tighten one dof's bounds until it binds
    lb = np.full(tree.nv, -10.0)
    ub = np.full(tree.nv, 10.0)
    lb[1], ub[1] = -1e-4, 1e-4
    prob = problem.replace(lb=jnp.asarray(lb), ub=jnp.asarray(ub))

    def nu_of_b(bz):
        p = prob.replace(b=prob.b.at[0, 2].set(bz))
        res = solve_unrolled(tree, PARAMS, q, p, num_iters=80)
        return res.z[0]                      # projected (feasible) velocities

    jac = jax.jacobian(nu_of_b)(jnp.asarray(0.1, jnp.float64))
    jac = np.asarray(jac)
    assert abs(jac[1]) < 1e-6               # clamped dof: no sensitivity
    assert np.abs(jac).max() > 1e-2         # free dofs: real sensitivity
