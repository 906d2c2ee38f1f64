"""Closed-loop position IK (solve_clik): the canonical application loop the
reference expects callers to build on its tailored per-tick overload
(loik-loid-optimized.hpp:596-695) — FK -> pose error -> constrained diff-IK
-> manifold integration, device-resident.

Also pins the SE(3) log map (spatial.se3_log) that the loop is built on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loik_tpu import spatial
from loik_tpu.model import robots
from loik_tpu.params import SolverParams
from loik_tpu.solver.clik import solve_clik

PARAMS = SolverParams(max_iter=100, tol_abs=1e-6, tol_rel=1e-6)


# --------------------------------------------------------------------------
# SE(3) log map
# --------------------------------------------------------------------------

def test_se3_log_roundtrip_regimes():
    """log(exp(v)) == v across angle regimes incl. the near-pi branch."""
    rng = np.random.default_rng(0)
    for mag in (1e-9, 1e-5, 0.3, 1.5, 2.9, np.pi - 1e-3, np.pi - 1e-7):
        for _ in range(8):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            v = jnp.asarray(np.concatenate([rng.normal(size=3), mag * axis]))
            R, p = spatial.se3_exp(v)
            np.testing.assert_allclose(
                np.asarray(spatial.se3_log(R, p)), np.asarray(v), atol=1e-7
            )


def test_se3_log_at_pi_and_identity():
    """Exactly pi (both axis signs valid -> exp must reproduce R) and the
    exact identity (w = 0, pure translation)."""
    for axis in ([1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [0.6, -0.64, 0.48]):
        a = np.asarray(axis) / np.linalg.norm(axis)
        v = jnp.asarray(np.concatenate([[0.1, 0.2, 0.3], np.pi * a]))
        R, p = spatial.se3_exp(v)
        R2, p2 = spatial.se3_exp(spatial.se3_log(R, p))
        np.testing.assert_allclose(np.asarray(R2), np.asarray(R), atol=1e-9)
        np.testing.assert_allclose(np.asarray(p2), np.asarray(p), atol=1e-9)
    v = spatial.se3_log(jnp.eye(3, dtype=jnp.float64),
                        jnp.asarray([1.0, 2.0, 3.0]))
    np.testing.assert_allclose(np.asarray(v), [1, 2, 3, 0, 0, 0], atol=1e-15)


def test_se3_log_batched():
    """Batched placements round-trip through exp(log(.)) — the log returns
    the PRINCIPAL twist (|w| <= pi), so compare placements, not raw twists
    (random Gaussian rotation vectors can exceed pi)."""
    vs = jnp.asarray(np.random.default_rng(1).normal(size=(32, 6)))
    R, p = spatial.se3_exp(vs)
    R2, p2 = spatial.se3_exp(spatial.se3_log(R, p))
    np.testing.assert_allclose(np.asarray(R2), np.asarray(R), atol=1e-12)
    np.testing.assert_allclose(np.asarray(p2), np.asarray(p), atol=1e-12)


# --------------------------------------------------------------------------
# solve_clik
# --------------------------------------------------------------------------

def _goal_poses(tree, q0, dqs):
    """World EE placements of q0 perturbed by rows of dqs (reachable)."""
    q_goal = jax.vmap(tree.integrate)(
        jnp.broadcast_to(q0, (dqs.shape[0],) + q0.shape), jnp.asarray(dqs)
    )
    _, _, oR, op = tree.fwd_kinematics(q_goal)
    ee = tree.njoints - 1
    return oR[:, ee], op[:, ee]


def test_clik_reaches_reachable_pose():
    tree = robots.panda_arm()
    q0 = tree.neutral()
    rng = np.random.default_rng(0)
    tR, tp = _goal_poses(tree, q0, 0.3 * rng.normal(size=(1, tree.nv)))
    res = solve_clik(tree, PARAMS, q0, tR[0], tp[0], link=tree.njoints - 1,
                     dt=0.1, steps=80, gain=2.0)
    assert bool(res.reached[0])
    assert float(res.pos_err[0]) < 1e-4
    assert float(res.rot_err[0]) < 1e-3
    # error history contracts
    hist = np.asarray(res.err_history[:, 0])
    assert hist[-1] < 1e-3 * hist[0]
    # warm ticks are cheap once settled
    assert int(res.iterations[0]) <= 5


def test_clik_batched_reaches_distinct_targets():
    """A batch of different targets: every problem reaches ITS pose.  (q is
    NOT compared against single-problem runs: the 7-dof arm is redundant —
    different compiled batch shapes legitimately settle different null-space
    components over the 60-tick feedback loop.)"""
    tree = robots.panda_arm()
    q0 = tree.neutral()
    rng = np.random.default_rng(3)
    dqs = 0.25 * rng.normal(size=(4, tree.nv))
    tR, tp = _goal_poses(tree, q0, dqs)
    q0b = jnp.broadcast_to(q0, (4,) + q0.shape)
    batch = solve_clik(tree, PARAMS, q0b, tR, tp, link=tree.njoints - 1,
                       dt=0.1, steps=60, gain=2.0)
    assert np.asarray(batch.reached).all()
    # each final q realizes its own target pose (checked via FK)
    _, _, oR, op = tree.fwd_kinematics(batch.q)
    ee = tree.njoints - 1
    np.testing.assert_allclose(np.asarray(op[:, ee]), np.asarray(tp),
                               atol=1e-3)
    for i in range(4):
        np.testing.assert_allclose(np.asarray(oR[i, ee]), np.asarray(tR[i]),
                                   atol=1e-3)


def test_clik_unreachable_pose_is_finite():
    """A pose far outside the workspace: no NaNs, reached=False, and the
    arm stalls at its closest approach (error plateaus, stays bounded)."""
    tree = robots.panda_arm()
    q0 = tree.neutral()
    tR = jnp.eye(3, dtype=q0.dtype)
    tp = jnp.asarray([3.0, 0.0, 0.5], q0.dtype)  # ~2 m beyond reach
    res = solve_clik(tree, PARAMS, q0, tR, tp, link=tree.njoints - 1,
                     dt=0.1, steps=50, gain=2.0)
    assert not bool(res.reached[0])
    assert np.isfinite(np.asarray(res.q)).all()
    assert np.isfinite(np.asarray(res.err_history)).all()
    assert float(res.pos_err[0]) > 1.0  # genuinely unreachable


def test_clik_warm_state_continues():
    """Splitting one run into two (threading state+q) equals one long run."""
    tree = robots.panda_arm()
    q0 = tree.neutral()
    rng = np.random.default_rng(5)
    tR, tp = _goal_poses(tree, q0, 0.3 * rng.normal(size=(1, tree.nv)))
    full = solve_clik(tree, PARAMS, q0, tR[0], tp[0], link=tree.njoints - 1,
                      dt=0.1, steps=40, gain=2.0)
    a = solve_clik(tree, PARAMS, q0, tR[0], tp[0], link=tree.njoints - 1,
                   dt=0.1, steps=20, gain=2.0)
    b = solve_clik(tree, PARAMS, a.q, tR[0], tp[0], link=tree.njoints - 1,
                   dt=0.1, steps=20, gain=2.0, warm_state=a.state)
    np.testing.assert_allclose(np.asarray(b.q), np.asarray(full.q),
                               atol=1e-10)


def test_clik_respects_velocity_bounds():
    """Tight joint-velocity bounds + a commanded-twist cap: the loop reaches
    the target while every tick's joint velocities obey the box.  Without
    the cap, the approach-phase QP is infeasible (commanded EE twist beyond
    what 0.5 rad/s joints can realize) and the loop relies on the
    self-heal; with it, ticks stay feasible throughout."""
    import loik_tpu

    tree = robots.panda_arm()
    q0 = tree.neutral()
    rng = np.random.default_rng(7)
    tR, tp = _goal_poses(tree, q0, 0.4 * rng.normal(size=(1, tree.nv)))
    ub = 0.5 * np.ones(tree.nv)
    problem = loik_tpu.make_problem(tree, (tree.njoints - 1,), lb=-ub, ub=ub)
    res = solve_clik(tree, PARAMS, q0, tR[0], tp[0], link=tree.njoints - 1,
                     dt=0.1, steps=100, gain=4.0, max_task_velocity=0.3,
                     problem=problem)
    assert bool(res.reached[0])
    assert float(jnp.max(jnp.abs(res.nu))) <= 0.5 + 1e-6


def test_clik_self_heals_after_infeasible_phase():
    """UNcapped commands with tight bounds: the approach-phase per-tick QPs
    are infeasible and their diverged duals must not poison later feasible
    ticks (non-converged ticks restart the next tick cold).  The measured
    failure without healing: error pinned at ~5e-4 with rp ~0.6 forever."""
    import loik_tpu

    tree = robots.panda_arm()
    q0 = tree.neutral()
    rng = np.random.default_rng(7)
    tR, tp = _goal_poses(tree, q0, 0.4 * rng.normal(size=(1, tree.nv)))
    ub = 0.5 * np.ones(tree.nv)
    problem = loik_tpu.make_problem(tree, (tree.njoints - 1,), lb=-ub, ub=ub)
    res = solve_clik(tree, PARAMS, q0, tR[0], tp[0], link=tree.njoints - 1,
                     dt=0.1, steps=100, gain=4.0, problem=problem)
    assert bool(res.reached[0])


def test_clik_rejects_mismatched_problem():
    tree = robots.panda_arm()
    import loik_tpu

    problem = loik_tpu.make_problem(tree, (0,))
    with pytest.raises(ValueError):
        solve_clik(tree, PARAMS, tree.neutral(), jnp.eye(3),
                   jnp.zeros(3), link=tree.njoints - 1, problem=problem)


def test_api_reach():
    """DiffIkSolver.reach wraps solve_clik with the solver's problem."""
    from loik_tpu import DiffIkSolver

    tree = robots.panda_arm()
    q0 = tree.neutral()
    rng = np.random.default_rng(9)
    tR, tp = _goal_poses(tree, q0, 0.3 * rng.normal(size=(1, tree.nv)))
    solver = DiffIkSolver(tree, PARAMS, (tree.njoints - 1,))
    res = solver.reach(q0, tR[0], tp[0], dt=0.1, steps=80, gain=2.0)
    assert bool(res.reached[0])
    direct = solve_clik(tree, PARAMS, q0, tR[0], tp[0],
                        link=tree.njoints - 1, dt=0.1, steps=80, gain=2.0)
    np.testing.assert_allclose(np.asarray(res.q), np.asarray(direct.q),
                               atol=1e-12)


def test_clik_sharded_matches_unsharded():
    """solve_clik under a batch mesh: sharded inputs must reproduce the
    unsharded run (the whole loop is per-problem; no collectives)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from loik_tpu.parallel.sharding import make_mesh

    tree = robots.panda_arm()
    B = 16
    q0 = jnp.broadcast_to(tree.neutral(), (B,) + tree.neutral().shape)
    rng = np.random.default_rng(2)
    tR, tp = _goal_poses(tree, tree.neutral(),
                         0.25 * rng.normal(size=(B, tree.nv)))
    ref = solve_clik(tree, PARAMS, q0, tR, tp, link=tree.njoints - 1,
                     dt=0.1, steps=40, gain=2.0)
    mesh = make_mesh()
    sh = NamedSharding(mesh, P("batch"))
    q0s = jax.device_put(q0, sh)
    tRs = jax.device_put(tR, sh)
    tps = jax.device_put(tp, sh)
    res = solve_clik(tree, PARAMS, q0s, tRs, tps, link=tree.njoints - 1,
                     dt=0.1, steps=40, gain=2.0)
    np.testing.assert_allclose(np.asarray(res.q), np.asarray(ref.q),
                               atol=1e-10)
    np.testing.assert_array_equal(np.asarray(res.reached),
                                  np.asarray(ref.reached))


def test_clik_dots_run_at_full_f32():
    """Every dot of the CLIK program (FK, pose error, solve) is pinned to
    HIGHEST precision: in a GPU's default TF32 the reported final pose error
    differed from its f64 re-evaluation by ~3e-4 m (H100, 256 poses), far
    above the 1e-4 m `pos_tol`; at HIGHEST by ~2e-7."""
    tree = robots.get("panda_arm", "float32")
    q0 = jnp.asarray(tree.neutral(), jnp.float32)[None]
    target_R = jnp.eye(3, dtype=jnp.float32)
    target_p = jnp.asarray([0.3, 0.0, 0.5], jnp.float32)
    hlo = jax.jit(lambda q: solve_clik(
        tree, PARAMS, q, target_R, target_p, link=tree.njoints - 1,
        steps=2).q).lower(q0).as_text()
    dots = [ln for ln in hlo.splitlines() if "dot_general" in ln]
    assert dots and all("precision = [HIGHEST, HIGHEST]" in ln for ln in dots)
