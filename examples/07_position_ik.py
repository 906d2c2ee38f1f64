"""Position-level IK: drive a batch of arms to target SE(3) poses.

The reference solver is differential — it answers "what joint VELOCITY
realizes this task right now".  Reaching a target POSE is the closed loop
its tailored per-tick overload exists for (loik-loid-optimized.hpp:596-695):
measure the pose error, command a velocity toward the target, solve,
integrate.  `solve_clik` runs that whole loop as ONE device program
(`lax.scan` over ticks) for a batch of poses; saturation and the secondary
tracking objective are handled by the constrained QP itself, which is the
advantage over classic pseudoinverse CLIK.

Run:  python examples/07_position_ik.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax
import jax.numpy as jnp
import numpy as np

from loik_tpu import SolverParams, make_problem, solve_clik
from loik_tpu.model import robots

jax.config.update("jax_enable_x64", True)

tree = robots.panda_arm()
ee = tree.njoints - 1
params = SolverParams(max_iter=100, tol_abs=1e-6, tol_rel=1e-6)

# --- batch of reachable target poses (FK of perturbed configurations) ----
B = 16
q0 = jnp.broadcast_to(tree.neutral(), (B,) + tree.neutral().shape)
rng = np.random.default_rng(0)
dq = jnp.asarray(0.35 * rng.normal(size=(B, tree.nv)))
q_goal = jax.vmap(tree.integrate)(q0, dq)
_, _, oR, op = tree.fwd_kinematics(q_goal)
target_R, target_p = oR[:, ee], op[:, ee]

# f64 for the ~1e-7 pose-error floor (f32 floors at ~1e-3; see README)
res = solve_clik(tree, params, q0, target_R, target_p, link=ee,
                 dt=0.1, steps=80, gain=2.0)
print(f"reached {int(res.reached.sum())}/{B} poses")
print(f"pose error: pos max {float(res.pos_err.max()):.2e} m, "
      f"rot max {float(res.rot_err.max()):.2e} rad")
hist = np.asarray(res.err_history)
print("error contraction (batch max |err|_inf per tick):",
      " -> ".join(f"{hist[t].max():.1e}" for t in (0, 10, 20, 40, 79)))

# --- tight velocity bounds: cap the commanded twist so every tick's QP ---
# stays feasible while the box constraint shapes the motion
ub = 0.5 * np.ones(tree.nv)
problem = make_problem(tree, (ee,), lb=-ub, ub=ub)
res_b = solve_clik(tree, params, q0, target_R, target_p, link=ee,
                   dt=0.1, steps=120, gain=4.0, max_task_velocity=0.3,
                   problem=problem)
print(f"\nwith |nu| <= 0.5 rad/s bounds: reached {int(res_b.reached.sum())}"
      f"/{B}; final-tick joint speed "
      f"{float(jnp.max(jnp.abs(res_b.nu))):.1e} rad/s (settled)")

# --- an unreachable pose fails loudly, not silently -----------------------
far = solve_clik(tree, params, q0[:1], jnp.eye(3, dtype=q0.dtype),
                 jnp.asarray([3.0, 0.0, 0.5], q0.dtype), link=ee, steps=40)
print(f"\nunreachable pose: reached={bool(far.reached[0])}, stalls at "
      f"closest approach (pos err {float(far.pos_err[0]):.2f} m)")
