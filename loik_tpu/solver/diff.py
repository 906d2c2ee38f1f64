"""Differentiable solves: gradients THROUGH the diff-IK optimization.

Net-new surface with no reference analog (the C++ solver is not
differentiable in any form): policy learning, contact-implicit trajectory
optimization, and model identification all want d(solution)/d(inputs) —
d nu*/dq through the forward kinematics, d nu*/d(b, A, H_ref, bounds)
through the QP data.  The production `solve` uses a masked
`lax.while_loop`, which JAX cannot reverse-differentiate; `solve_unrolled`
runs the SAME iteration body (`make_loop_body` — identical math, flags,
penalty adaptation, masked freezing) for a FIXED number of iterations
under `lax.scan`, which is reverse-differentiable.  Each iteration is
rematerialized (`jax.checkpoint`), so the backward pass costs one extra
forward sweep per iteration instead of storing every intermediate — the
standard unrolled-optimizer recipe.

Converged problems freeze under the masked merge exactly as in the
while-loop driver, so for `num_iters` past the convergence point the
output (and therefore the gradient of the FROZEN fixed point) stops
changing — unrolled-ADMM gradients approach the implicit-function-theorem
gradient as iterations increase; the test suite pins them against central
finite differences.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..params import SolverParams
from ..problem import IkProblem
from .solve import (_flat_nu, _reset_state, fwd_pass_init, make_loop_body,
                    prepare_problem)
from .state import SolveResult, SolverState, init_state


def _solve_loop_unrolled(tree, prob, params, st, num_iters):
    body = jax.checkpoint(make_loop_body(tree, prob, params))

    def step(carry, _):
        return body(carry), None

    st, _ = jax.lax.scan(step, st, None, length=num_iters)
    return st


def solve_unrolled(tree, params: SolverParams, q, problem: IkProblem,
                   num_iters: int = 32,
                   warm_state: Optional[SolverState] = None) -> SolveResult:
    """Batched solve with a FIXED `num_iters`-iteration unrolled loop —
    identical math to `solve` (shared `make_loop_body`), but reverse-mode
    differentiable with respect to `q` and every `problem` leaf.

    Use inside a loss: ``jax.grad(lambda b: loss(solve_unrolled(...)))``.
    `num_iters` should comfortably exceed the typical converged iteration
    count for the problem class (converged problems freeze, so extra
    iterations cost forward/backward FLOPs but do not change the answer);
    check ``res.converged`` on the primal values as usual.  Wrap in
    `jax.jit` at the loss level — this function is plain traced code."""
    if params.logging or params.verbose:
        raise ValueError("solve_unrolled supports neither logging nor "
                         "verbose (use solve)")
    q = jnp.asarray(q)
    if q.ndim == 1:
        q = q[None]  # results stay batched, like `solve` (callers index [0])
    dtype = q.dtype
    B = q.shape[0]
    # budget must not freeze problems before the unroll ends: the body's
    # iteration-budget logic reads params.max_iter
    params = params.replace(max_iter=num_iters + 2)
    prob = prepare_problem(tree, problem, B, dtype)
    if tree.has_q_dependent_S:
        S_list = []
        for i in range(tree.njoints):
            Si = tree.joint_S(i, q).astype(dtype)
            if Si.ndim == 2:
                Si = jnp.broadcast_to(Si[:, :, None], Si.shape + (B,))
            else:
                Si = jnp.moveaxis(Si, 0, -1)
            S_list.append(Si)
        prob = dataclasses.replace(prob, S_list=tuple(S_list))
    st = warm_state if warm_state is not None else init_state(
        tree, B, problem.num_constraints, dtype)
    st = _reset_state(tree, params, st, dtype)
    liMi_R, liMi_p = fwd_pass_init(tree, q)
    st = dataclasses.replace(st, liMi_R=liMi_R, liMi_p=liMi_p)
    with jax.default_matmul_precision("highest"):
        st = _solve_loop_unrolled(tree, prob, params, st, num_iters)
    return SolveResult(
        nu=_flat_nu(tree, st.nu),
        z=_flat_nu(tree, st.z),
        vis=jnp.moveaxis(st.vis, -1, 0),
        converged=st.converged,
        primal_infeasible=st.primal_infeasible,
        dual_infeasible=st.dual_infeasible,
        iterations=st.iterations,
        tail_iterations=st.tail_iterations,
        primal_residual=st.primal_residual,
        dual_residual=st.dual_residual,
        state=st,
    )
