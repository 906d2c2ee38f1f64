"""Broadened joint model: unbounded revolute (nq=2), translation, planar,
universal, helical, spherical-ZYX, composite — construction, kinematics,
subspace consistency, integration,
URDF mapping (incl. `continuous` -> unbounded, the Pinocchio convention),
native-parser parity, and fast-vs-oracle solver parity.

The reference supports these joints through Pinocchio's generic visitor
dispatch (`jmodel.calc_aba`, loik-loid-optimized.hxx:60); here each type gets
an explicit subspace/transform/integrate implementation (model/tree.py) and
the solver consumes exact-size per-joint D blocks as before — universal
joints additionally exercise the configuration-dependent subspace path
(PreparedProblem.S_list)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loik_tpu.model import robots
from loik_tpu.model.builders import random_tree
from loik_tpu.model.tree import (FREE_FLYER, HELICAL, MIMIC_PAIR,
                                 PLANAR, PRISMATIC,
                                 REVOLUTE, REVOLUTE_UNBOUNDED, SPHERICAL,
                                 SPHERICAL_ZYX, TRANSLATION, UNIVERSAL,
                                 make_tree)
from loik_tpu.model.urdf import load_urdf
from loik_tpu.oracle import OracleSolver
from loik_tpu.params import SolverParams
from loik_tpu.problem import make_problem
from loik_tpu.solver import solve

PARAMS = SolverParams(max_iter=150, tol_abs=1e-6, tol_rel=1e-6)

ALL_TYPES = (REVOLUTE, PRISMATIC, FREE_FLYER, SPHERICAL, REVOLUTE_UNBOUNDED,
             TRANSLATION, PLANAR, UNIVERSAL, HELICAL, SPHERICAL_ZYX)


def one_joint_tree(t, axis=(0, 0, 1), axis2=(0, 1, 0), pitch=0.12):
    return make_tree(
        [dict(name="j0", parent=-1, type=t, axis=axis, axis2=axis2,
              pitch=pitch, velocity_limit=3.0)],
        name=f"one_{t}",
    )


# --------------------------------------------------------------------------- #
# kinematic consistency: d/dt M(integrate(q, t*dq))|_0 == S(q) @ dq
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("t", ALL_TYPES)
def test_subspace_matches_finite_difference(t):
    """For every joint type, the motion subspace must be the local-frame
    derivative of the configuration map along `integrate` — the property the
    whole solver recursion rests on (v_i = X^-1 v_parent + S nu)."""
    tree = one_joint_tree(t, axis=(0.36, 0.48, 0.8), axis2=(0.8, 0, 0.6))
    rng = np.random.default_rng(int(t))
    q = np.asarray(tree.random_configuration(jax.random.PRNGKey(int(t))))
    for trial in range(3):
        dq = rng.uniform(-1.0, 1.0, size=tree.nv)
        h = 1e-6
        q1 = np.asarray(tree.integrate(jnp.asarray(q), h * jnp.asarray(dq)))
        R0, p0 = tree.joint_calc(0, jnp.asarray(q))
        R1, p1 = tree.joint_calc(0, jnp.asarray(q1))
        R0, p0, R1, p1 = map(np.asarray, (R0, p0, R1, p1))
        lin = R0.T @ (p1 - p0) / h
        dR = R0.T @ R1
        ang = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                        dR[1, 0] - dR[0, 1]]) / (2 * h)
        S = np.asarray(tree.joint_S(0, jnp.asarray(q))
                       if tree.has_q_dependent_S else tree.joint_S(0))
        v = S @ dq
        np.testing.assert_allclose(lin, v[:3], atol=2e-6)
        np.testing.assert_allclose(ang, v[3:], atol=2e-6)


def test_helical_screw_motion():
    """A helical joint advances pitch metres per radian along its axis while
    rotating about it; pitch=0 degenerates to a plain revolute."""
    ax = np.array([0.36, 0.48, 0.8])
    t = one_joint_tree(HELICAL, axis=tuple(ax), pitch=0.25)
    for th in (-2.0, 0.7, 3.5):
        R, p = t.joint_calc(0, jnp.asarray([th]))
        Rr, _ = one_joint_tree(REVOLUTE, axis=tuple(ax)).joint_calc(
            0, jnp.asarray([th]))
        np.testing.assert_allclose(np.asarray(R), np.asarray(Rr), atol=1e-12)
        np.testing.assert_allclose(np.asarray(p), 0.25 * th * ax, atol=1e-12)
    t0 = one_joint_tree(HELICAL, axis=tuple(ax), pitch=0.0)
    S = np.asarray(t0.joint_S(0))
    np.testing.assert_allclose(S[:3, 0], 0.0, atol=1e-15)
    np.testing.assert_allclose(S[3:, 0], ax, atol=1e-12)


def test_composite_expands_to_equivalent_chain():
    """A COMPOSITE joint (stacked sub-joints at one mount, pinocchio
    JointModelComposite) must build the same tree as the hand-written
    sub-joint chain: same FK, same solve."""
    from loik_tpu.model.tree import COMPOSITE

    sub = [dict(name="rz", type=REVOLUTE, axis=(0, 0, 1)),
           dict(name="px", type=PRISMATIC, axis=(1, 0, 0),
                xyz=(0.1, 0, 0))]
    tc = make_tree(
        [dict(name="base", parent=-1, type=COMPOSITE, sub=sub,
              xyz=(0.2, 0.0, 0.5), rpy=(0.3, -0.2, 0.1)),
         dict(name="elbow", parent=0, type=REVOLUTE, axis=(0, 1, 0),
              xyz=(0.3, 0, 0))],
        name="composite",
    )
    tm = make_tree(
        [dict(name="rz", parent=-1, type=REVOLUTE, axis=(0, 0, 1),
              xyz=(0.2, 0.0, 0.5), rpy=(0.3, -0.2, 0.1)),
         dict(name="px", parent=0, type=PRISMATIC, axis=(1, 0, 0),
              xyz=(0.1, 0, 0)),
         dict(name="elbow", parent=1, type=REVOLUTE, axis=(0, 1, 0),
              xyz=(0.3, 0, 0))],
        name="manual",
    )
    assert tc.jtypes == tm.jtypes and tc.parents == tm.parents
    assert tc.joint_names == ("rz", "px", "elbow")  # sub names kept
    q = tm.random_configuration(jax.random.PRNGKey(3))
    for a, m in zip(tc.fwd_kinematics(q), tm.fwd_kinematics(q)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(m), atol=1e-12)
    # the composite's children hang off the LAST sub-joint
    assert tc.parents[2] == 1


def test_spherical_zyx_matches_euler_chain():
    """Spherical-ZYX FK equals the Rz·Ry·Rx revolute chain with identity
    intermediate placements, and its motion subspace maps Euler-angle rates
    to the same body angular velocity as the chain's Jacobian."""
    tz = one_joint_tree(SPHERICAL_ZYX)
    tchain = make_tree(
        [dict(name="rz", parent=-1, type=REVOLUTE, axis=(0, 0, 1)),
         dict(name="ry", parent=0, type=REVOLUTE, axis=(0, 1, 0)),
         dict(name="rx", parent=1, type=REVOLUTE, axis=(1, 0, 0))],
        name="euler_chain",
    )
    q = jnp.asarray([0.7, -0.4, 1.1])
    _, _, oR_z, _ = tz.fwd_kinematics(q)
    _, _, oR_c, _ = tchain.fwd_kinematics(q)
    np.testing.assert_allclose(np.asarray(oR_z[0]), np.asarray(oR_c[2]),
                               atol=1e-14)
    # batched joint_S agrees with per-problem evaluation
    qb = tz.random_configuration(jax.random.PRNGKey(2), (4,))
    Sb = np.asarray(tz.joint_S(0, qb))
    for k in range(4):
        np.testing.assert_allclose(
            Sb[k], np.asarray(tz.joint_S(0, qb[k])), atol=1e-14)


def test_unbounded_matches_bounded_revolute():
    """Same axis, same angle: REVOLUTE(θ) == REVOLUTE_UNBOUNDED(cosθ, sinθ),
    including past ±π where the bounded chart would wrap."""
    ax = (0.6, 0.0, 0.8)
    tb = one_joint_tree(REVOLUTE, axis=ax)
    tu = one_joint_tree(REVOLUTE_UNBOUNDED, axis=ax)
    for th in (-4.0, -0.3, 0.0, 1.2, 7.5):
        Rb, _ = tb.joint_calc(0, jnp.asarray([th]))
        Ru, _ = tu.joint_calc(0, jnp.asarray([np.cos(th), np.sin(th)]))
        np.testing.assert_allclose(np.asarray(Rb), np.asarray(Ru), atol=1e-14)


def test_unbounded_integrate_stays_on_circle():
    tu = one_joint_tree(REVOLUTE_UNBOUNDED)
    q = tu.neutral()
    total = 0.0
    for d in (0.7, 2.5, -1.1, 9.0):  # multi-turn: no wrap, no drift
        q = tu.integrate(q, jnp.asarray([d]))
        total += d
    c, s = float(q[0]), float(q[1])
    assert abs(c * c + s * s - 1.0) < 1e-12
    np.testing.assert_allclose([c, s], [np.cos(total), np.sin(total)],
                               atol=1e-12)


def test_universal_matches_two_revolutes_fk():
    """A universal joint's FK equals two chained revolute joints with an
    identity intermediate placement."""
    a1, a2 = (0, 0, 1), (0.6, 0.8, 0)
    tu = one_joint_tree(UNIVERSAL, axis=a1, axis2=a2)
    t2 = make_tree(
        [dict(name="r1", parent=-1, type=REVOLUTE, axis=a1),
         dict(name="r2", parent=0, type=REVOLUTE, axis=a2)],
        name="two_rev",
    )
    q = jnp.asarray([0.7, -1.2])
    _, _, oR_u, oP_u = tu.fwd_kinematics(q)
    _, _, oR_2, oP_2 = t2.fwd_kinematics(q)
    np.testing.assert_allclose(np.asarray(oR_u[0]), np.asarray(oR_2[1]),
                               atol=1e-14)
    np.testing.assert_allclose(np.asarray(oP_u[0]), np.asarray(oP_2[1]),
                               atol=1e-14)


def test_planar_integrate_se2():
    """Planar step: pure rotation then pure translation compose like SE(2)."""
    tp = one_joint_tree(PLANAR)
    q = tp.neutral()
    q = tp.integrate(q, jnp.asarray([0.0, 0.0, np.pi / 2]))  # rotate 90°
    q = tp.integrate(q, jnp.asarray([1.0, 0.0, 0.0]))        # local +x step
    x, y, c, s = map(float, q)
    # after a 90° yaw, a local +x step moves the base along world +y
    np.testing.assert_allclose([x, y], [0.0, 1.0], atol=1e-12)
    np.testing.assert_allclose([c, s], [0.0, 1.0], atol=1e-12)


def test_random_configuration_manifold_validity():
    rng_key = jax.random.PRNGKey(3)
    tree = robots.mobile_ur5()
    q = np.asarray(tree.random_configuration(rng_key, (64,)))
    iq_pl = tree.idx_q[0]
    cs = q[:, iq_pl + 2] ** 2 + q[:, iq_pl + 3] ** 2
    np.testing.assert_allclose(cs, 1.0, atol=1e-12)
    for i, t in enumerate(tree.jtypes):
        if t == REVOLUTE_UNBOUNDED:
            iq = tree.idx_q[i]
            np.testing.assert_allclose(
                q[:, iq] ** 2 + q[:, iq + 1] ** 2, 1.0, atol=1e-12
            )


# --------------------------------------------------------------------------- #
# URDF mapping
# --------------------------------------------------------------------------- #

URDF_NEW_TYPES = """
<robot name="newtypes">
  <link name="base"/><link name="l1"/><link name="l2"/><link name="l3"/>
  <link name="l4"/>
  <joint name="j_planar" type="planar">
    <parent link="base"/><child link="l1"/>
    <limit velocity="2.0"/>
  </joint>
  <joint name="j_cont" type="continuous">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0.1 0 0.2"/><axis xyz="0 1 0"/>
    <limit velocity="3.0"/>
  </joint>
  <joint name="j_trans" type="translation">
    <parent link="l2"/><child link="l3"/>
    <origin xyz="0 0 0.1"/>
  </joint>
  <joint name="j_univ" type="universal">
    <parent link="l3"/><child link="l4"/>
    <axis xyz="0 0 1"/><axis2 xyz="1 0 0"/>
  </joint>
</robot>
"""


def test_urdf_new_types_python():
    t = load_urdf(URDF_NEW_TYPES)
    assert t.jtypes == (PLANAR, REVOLUTE_UNBOUNDED, TRANSLATION, UNIVERSAL)
    assert t.nq == 4 + 2 + 3 + 2
    assert t.nv == 3 + 1 + 3 + 2
    np.testing.assert_allclose(np.asarray(t.axis2[3]), [1, 0, 0], atol=1e-14)
    # `continuous` gets the Pinocchio nq=2 (cos, sin) chart, and neutral is
    # on the manifold
    q0 = np.asarray(t.neutral())
    _, _, oR, _ = t.fwd_kinematics(t.neutral())
    np.testing.assert_allclose(np.asarray(oR[0]), np.eye(3), atol=1e-14)
    assert q0[t.idx_q[1]] == 1.0  # cos = 1


def test_urdf_new_types_native_parity():
    from loik_tpu.model.native import load_urdf_native, native_available

    if not native_available():
        pytest.skip("native toolchain unavailable")
    t_py = load_urdf(URDF_NEW_TYPES)
    t_cc = load_urdf_native(URDF_NEW_TYPES)
    assert t_cc.jtypes == t_py.jtypes
    assert t_cc.parents == t_py.parents
    np.testing.assert_allclose(np.asarray(t_cc.placement_p),
                               np.asarray(t_py.placement_p), atol=1e-14)
    np.testing.assert_allclose(np.asarray(t_cc.axis),
                               np.asarray(t_py.axis), atol=1e-14)
    np.testing.assert_allclose(np.asarray(t_cc.axis2),
                               np.asarray(t_py.axis2), atol=1e-14)


# --------------------------------------------------------------------------- #
# solver parity on the broadened joint set
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_new_types_parity(seed):
    """Random tree forced to contain PLANAR + TRANSLATION + UNBOUNDED +
    UNIVERSAL + MIMIC_PAIR joints: fast solver (incl. the q-dependent
    S_list path) vs oracle at 1e-9."""
    rng = np.random.default_rng(200 + seed)
    force = (PLANAR, TRANSLATION, REVOLUTE_UNBOUNDED, UNIVERSAL, HELICAL,
             SPHERICAL_ZYX, MIMIC_PAIR)
    tree = random_tree(rng, int(rng.integers(8, 11)), force_types=force)
    assert set(force) <= set(tree.jtypes)
    c_links = (tree.leaf_joints[-1],)
    b = rng.uniform(-0.15, 0.15, size=(1, 6))
    problem = make_problem(
        tree, c_links, b=b,
        lb=-3.0 * np.ones(tree.nv), ub=3.0 * np.ones(tree.nv),
    )
    q = tree.random_configuration(jax.random.PRNGKey(seed))
    res = solve(tree, PARAMS, q, problem)
    orc = OracleSolver(tree, PARAMS).solve(np.asarray(q), problem)
    assert bool(res.converged[0]) == orc.converged
    assert int(res.iterations[0]) == orc.iterations
    np.testing.assert_allclose(np.asarray(res.nu[0]), orc.nu, atol=1e-9)
    np.testing.assert_allclose(np.asarray(res.vis[0]), orc.vis, atol=1e-9)


def test_mobile_ur5_end_to_end():
    """The bench-class broadened-joint model solves a whole-body EE task:
    planar base + continuous wrists + universal head, batched."""
    tree = robots.mobile_ur5()
    ee = tree.joint_names.index("wrist_3_joint")
    b = np.zeros((1, 6))
    b[0, 0] = 0.3  # commanded EE surge; base must cooperate
    vl = np.minimum(np.asarray(tree.velocity_limit), 4.0)
    problem = make_problem(tree, (ee,), b=b, lb=-vl, ub=vl)
    B = 16
    qs = tree.random_configuration(jax.random.PRNGKey(11), (B,))
    res = solve(tree, PARAMS, qs, problem)
    conv = np.asarray(res.converged)
    assert conv.mean() > 0.8, f"conv {conv.mean()}"
    # task actually achieved: A v_ee = b
    vis = np.asarray(res.vis)[conv]
    np.testing.assert_allclose(vis[:, ee, 0], 0.3, atol=5e-6)
    # and the solution uses the base (planar dofs nonzero for most problems)
    nu = np.asarray(res.nu)[conv]
    assert np.mean(np.max(np.abs(nu[:, :3]), axis=1) > 1e-4) > 0.5


def test_mobile_ur5_two_stage_xla_fallback():
    """solve_two_stage on a q-dependent-S tree (universal joints) must
    still certify."""
    from loik_tpu.solver.refine import solve_two_stage

    tree = robots.mobile_ur5()
    ee = tree.joint_names.index("wrist_3_joint")
    b = np.zeros((1, 6))
    b[0, 2] = 0.2
    vl = np.minimum(np.asarray(tree.velocity_limit), 4.0)
    problem = make_problem(tree, (ee,), b=b, lb=-vl, ub=vl)
    qs = tree.random_configuration(jax.random.PRNGKey(5), (8,))
    res = solve_two_stage(tree, PARAMS, qs, problem)
    assert np.asarray(res.converged).mean() > 0.8


def test_helical_f32_matches_oracle():
    """Helical chains are constant-subspace 1-dof trees: the f32 production
    solve agrees with the f64 oracle on flags and solutions."""
    from loik_tpu.oracle import OracleSolver

    jt = [dict(name="h0", parent=-1, type=HELICAL, axis=(0, 0, 1),
               pitch=0.15, velocity_limit=3.0),
          dict(name="r1", parent=0, type=REVOLUTE, axis=(0, 1, 0),
               xyz=(0.3, 0, 0), velocity_limit=3.0),
          dict(name="h2", parent=1, type=HELICAL, axis=(1, 0, 0),
               pitch=0.05, xyz=(0.3, 0, 0), velocity_limit=3.0)]
    tree = make_tree(jt, name="screw_chain", dtype=jnp.float32)
    # 3-D task on a 3-dof chain (a full 6-D task is generically infeasible)
    A = np.zeros((1, 6, 6))
    A[0, :3, :3] = np.eye(3)
    b = np.zeros((1, 6))
    b[0, 2] = 0.05
    problem = make_problem(tree, (2,), A=A, b=b,
                           lb=-3 * np.ones(tree.nv),
                           ub=3 * np.ones(tree.nv), dtype=jnp.float32)
    qs = tree.random_configuration(jax.random.PRNGKey(4), (16,)).astype(
        jnp.float32)
    params = SolverParams(max_iter=60, tol_abs=1e-4, tol_rel=1e-4)
    res = solve(tree, params, qs, problem)
    assert res.nu.dtype == jnp.float32
    conv = np.asarray(res.converged)
    assert conv.mean() > 0.5
    tree64 = tree.astype(jnp.float64)
    prob64 = problem.replace(**{k: np.asarray(getattr(problem, k), np.float64)
                                for k in ("H_ref", "v_ref", "A", "b", "lb",
                                          "ub")})
    for i in range(4):
        o = OracleSolver(tree64, params).solve(np.asarray(qs[i], np.float64),
                                               prob64)
        assert o.converged == bool(conv[i])
        if o.converged:
            np.testing.assert_allclose(np.asarray(res.nu[i]), o.nu,
                                       atol=1e-3)


def test_universal_f32_solve():
    """Configuration-dependent subspaces (universal joints) run in f32 on
    the production loop and agree with the f64 solve."""
    ee_tree = robots.mobile_ur5("float32")
    ee = ee_tree.joint_names.index("wrist_3_joint")
    b = np.zeros((1, 6))
    b[0, 2] = 0.2
    vl = np.minimum(np.asarray(ee_tree.velocity_limit), 4.0)
    qs = ee_tree.random_configuration(jax.random.PRNGKey(0), (8,))
    params = SolverParams(max_iter=200, tol_abs=1e-4, tol_rel=1e-4)
    r32 = solve(ee_tree, params, qs.astype(jnp.float32),
                make_problem(ee_tree, (ee,), b=b, lb=-vl, ub=vl,
                             dtype=jnp.float32))
    tree64 = robots.mobile_ur5("float64")
    r64 = solve(tree64, params, qs.astype(jnp.float64),
                make_problem(tree64, (ee,), b=b, lb=-vl, ub=vl))
    assert r32.nu.dtype == jnp.float32
    both = np.asarray(r32.converged) & np.asarray(r64.converged)
    assert both.mean() > 0.5
    np.testing.assert_allclose(np.asarray(r32.nu)[both],
                               np.asarray(r64.nu)[both], atol=2e-3)
