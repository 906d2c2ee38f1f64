"""Closed-loop inverse kinematics (position-level IK) on top of the
differential solver.

The reference is strictly a *differential* IK solver; its tailored per-tick
overload `Solve(q, c_id, Ai, bi)` (loik-loid-optimized.hpp:596-695) is the
building block it expects callers to wrap in exactly this loop: measure the
end-effector pose, command a velocity toward the target, solve, integrate.
`solve_clik` closes that loop device-side — the whole iteration
(FK -> pose error -> constrained diff-IK solve -> manifold integration)
runs as ONE `lax.scan` program for a batch of problems, warm-starting each
tick's duals from the previous tick (the reference's warm_start_ semantics
across control ticks).

Per tick, for each problem in the batch:
  1. FK: world placement M_ee of the constrained joint at the current q.
  2. Local-frame pose error twist  err = log6(M_ee^-1 * M_target)
     (Pinocchio convention: spatial velocities live in the joint's LOCAL
     frame, ik-id-description.hpp:106-135 — so the commanded velocity is
     simply `gain * err`, no frame juggling).
  3. One constrained diff-IK solve with A = I6, b = gain * err and the
     problem's box bounds — saturation and secondary objectives (H_ref,
     v_ref) are handled BY the solver, which is the point of CLIK-via-QP
     over the classic pseudoinverse loop.
  4. q <- integrate(q, dt * nu) on the configuration manifold.

Fixed tick count (batched problems reach their targets at different times;
finished problems keep solving a ~zero-error problem, which warm-started
costs ~2 iterations/tick).  `reached` reports per-problem success against
pos_tol / rot_tol at the final tick.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from .. import spatial
from ..params import SolverParams
from ..problem import IkProblem, make_problem
from .solve import _solve_impl
from .state import SolverState, init_state


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ClikResult:
    """Outcome of a closed-loop IK run (leading batch axis B)."""

    q: jnp.ndarray            # (B, nq) final configurations
    reached: jnp.ndarray      # (B,) bool: final pose error within tolerances
    pos_err: jnp.ndarray      # (B,) |translation error| at the final tick [m]
    rot_err: jnp.ndarray      # (B,) |rotation error| at the final tick [rad]
    err_history: jnp.ndarray  # (T, B) inf-norm of the 6-D error twist/tick
    nu: jnp.ndarray           # (B, nv) last commanded joint velocities
    state: SolverState        # final solver state (warm start for more ticks)
    converged: jnp.ndarray    # (B,) last tick's diff-IK convergence flags
    iterations: jnp.ndarray   # (B,) last tick's diff-IK iteration counts


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _clik_jit(tree, params, link, steps, dt, gain, vmax,
              q0, target_R, target_p, problem, warm_state):
    # full f32 for the FK and pose-error dots too: in TF32 (a GPU's default
    # for f32 dots) the loop converged to poses ~3e-4 m off their reported
    # error (measured on an H100, 256 panda_arm poses)
    with jax.default_matmul_precision("highest"):
        return _clik_body(tree, params, link, steps, dt, gain, vmax, q0,
                          target_R, target_p, problem, warm_state)


def _clik_body(tree, params, link, steps, dt, gain, vmax,
               q0, target_R, target_p, problem, warm_state):
    dt_ = jnp.asarray(dt, q0.dtype)
    gain_ = jnp.asarray(gain, q0.dtype)
    # the self-heal target is a genuinely cold state (NOT warm_state, which
    # may carry user-provided duals)
    cold = init_state(tree, q0.shape[0], problem.num_constraints, q0.dtype)

    def pose_error(q):
        _, _, oR, op = tree.fwd_kinematics(q)
        Ri, pi = spatial.se3_inverse(oR[..., link, :, :], op[..., link, :])
        Rd, pd = spatial.se3_compose(Ri, pi, target_R, target_p)
        return spatial.se3_log(Rd, pd)                       # (B, 6) local

    def tick(carry, _):
        q, st = carry
        err = pose_error(q)
        v_cmd = gain_ * err
        if vmax is not None:
            # cap the commanded twist: during the far-from-target approach
            # the uncapped gain*err can exceed what the velocity bounds can
            # realize, making the per-tick QP infeasible (standard CLIK
            # velocity saturation, direction-preserving)
            mag = jnp.max(jnp.abs(v_cmd), axis=-1, keepdims=True)
            v_cmd = v_cmd * jnp.minimum(
                1.0, jnp.asarray(vmax, q0.dtype) / jnp.maximum(mag, 1e-30)
            )
        prob = problem.update_constraint(0, b=v_cmd)
        res = _solve_impl(tree, params, q, prob, st)
        # self-heal: warm-start the next tick only from CONVERGED solves.
        # A tick whose QP was infeasible (e.g. saturated approach phase)
        # leaves diverged duals that would poison every later warm solve
        # (measured: rp pinned at ~0.6 forever after an infeasible phase);
        # those problems restart cold instead.
        conv = res.converged

        def heal(w, c):
            return w if w.ndim == 0 else jnp.where(conv, w, c)

        st_next = jax.tree_util.tree_map(heal, res.state, cold)
        q_next = tree.integrate(q, dt_ * res.nu)
        return (q_next, st_next), (
            jnp.max(jnp.abs(err), axis=-1),
            res.nu, res.converged, res.iterations,
        )

    (qT, stT), (err_hist, nus, convs, iters) = jax.lax.scan(
        tick, (q0, warm_state), None, length=steps
    )
    err_final = pose_error(qT)
    return qT, stT, err_hist, nus[-1], convs[-1], iters[-1], err_final


def solve_clik(tree, params: SolverParams, q0, target_R, target_p,
               link: int, *, dt: float = 0.05, steps: int = 64,
               gain: float = 1.0,
               max_task_velocity: Optional[float] = None,
               problem: Optional[IkProblem] = None,
               warm_state: Optional[SolverState] = None,
               pos_tol: float = 1e-4, rot_tol: float = 1e-3) -> ClikResult:
    """Drive joint `link` of a batch of configurations to target SE(3)
    poses with a device-resident closed-loop IK scan (see module docstring).

    Args:
      q0: (B, nq) or (nq,) start configurations.
      target_R / target_p: target world placements — (B, 3, 3)/(B, 3) per
        problem, or a single (3, 3)/(3,) pose broadcast to the batch.
      link: the constrained joint index (its world placement is driven).
      dt: integration step per tick [s]; gain: error-to-velocity feedback
        gain [1/s].  Effective per-tick contraction is ~dt*gain when the
        velocity bounds are inactive.
      max_task_velocity: optional inf-norm cap on the commanded twist
        (direction-preserving saturation).  With tight joint-velocity
        bounds, set this to what the arm can actually realize — an
        uncapped gain*err during the approach phase makes the per-tick QP
        infeasible; the loop still self-heals (non-converged ticks restart
        the next tick's duals cold) but capped commands converge faster.
      problem: optional IkProblem (ONE constraint at `link`) supplying
        tracking weights H_ref/v_ref and box bounds lb/ub — its `b` slot is
        overwritten every tick.  Default: reference-fixture weights with the
        model's velocity-limit bounds (`make_problem` defaults).
      steps: fixed tick count (no data-dependent early exit — batched).

    Returns a ClikResult; `reached` = final |pos err| < pos_tol and
    |rot err| < rot_tol.
    """
    q0 = jnp.asarray(q0)
    if q0.ndim == 1:
        q0 = q0[None]
    B = q0.shape[0]
    dtype = q0.dtype
    target_R = jnp.broadcast_to(jnp.asarray(target_R, dtype), (B, 3, 3))
    target_p = jnp.broadcast_to(jnp.asarray(target_p, dtype), (B, 3))
    if problem is None:
        problem = make_problem(tree, (link,), dtype=dtype)
    elif problem.constraint_links != (link,):
        raise ValueError(
            f"problem must have exactly one constraint at link {link}; got "
            f"links {problem.constraint_links}"
        )
    # per-problem b slots (the error twist differs across the batch)
    b0 = jnp.zeros((B, 1, 6), dtype)
    A0 = jnp.broadcast_to(jnp.asarray(problem.A, dtype), (B, 1, 6, 6))
    problem = problem.replace(A=A0, b=b0)
    # Infeasibility certificates OFF: as the loop converges b -> 0, which
    # makes the OSQP certificate's b'dy condition trivially true and the
    # A'dy/dy ratio test noise-dominated (warm duals wiggle at the optimum)
    # — ticks get spuriously frozen as "infeasible" and the error plateaus
    # ~1e-4 instead of contracting to ~1e-9.  This is inherited from the
    # reference's certificate (loik-loid-optimized.hxx:572-606), which has
    # the same b -> 0 edge; in a CLIK loop failure is reported by `reached`
    # (an unreachable pose stalls at its closest-approach error), so the
    # certificate adds nothing here.
    params = params.replace(warm_start=True, check_feasibility=False)
    if warm_state is None:
        warm_state = init_state(tree, B, 1, dtype)
    vmax = None if max_task_velocity is None else float(max_task_velocity)
    qT, stT, err_hist, nu, conv, iters, err_final = _clik_jit(
        tree, params, int(link), int(steps), float(dt), float(gain), vmax,
        q0, target_R, target_p, problem, warm_state,
    )
    pos_err = jnp.linalg.norm(err_final[..., :3], axis=-1)
    rot_err = jnp.linalg.norm(err_final[..., 3:], axis=-1)
    reached = (pos_err < pos_tol) & (rot_err < rot_tol)
    return ClikResult(
        q=qT, reached=reached, pos_err=pos_err, rot_err=rot_err,
        err_history=err_hist, nu=nu,
        state=stT, converged=conv, iterations=iters,
    )
