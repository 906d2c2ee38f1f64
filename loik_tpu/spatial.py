"""Batched spatial algebra on SE(3), motions (twists) and forces (wrenches).

Batched JAX replacement for the Eigen/Pinocchio spatial-algebra substrate the
reference builds on (cf. /root/reference/include/loik/loik-loid-data.hpp:10-28,
which imports pinocchio SE3Tpl / MotionTpl / ForceTpl).  Everything here is a
pure function on jnp arrays with arbitrary leading batch dims:

  - SE(3) transform:  pair ``(R, p)`` with ``R (..., 3, 3)`` rotation and
    ``p (..., 3)`` translation, mapping frame B -> frame A ("aMb").
  - Motion (twist):   ``(..., 6)`` ordered ``[linear(3); angular(3)]`` —
    the Pinocchio ``Motion::toVector()`` convention (LINEAR=0, ANGULAR=3).
  - Force (wrench):   ``(..., 6)`` ordered ``[force(3); torque(3)]``.

Conventions match Pinocchio so that solver recursions mirror the reference
math exactly (e.g. ``liMi.toDualActionMatrix()`` in loik-loid.hxx:106 is
`se3_dual_action_matrix` here).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

LIN = slice(0, 3)
ANG = slice(3, 6)


def skew(v):
    """Skew-symmetric matrix [v]x, shape (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], axis=-1),
            jnp.stack([z, o, -x], axis=-1),
            jnp.stack([-y, x, o], axis=-1),
        ],
        axis=-2,
    )


def rotation_about_axis(axis, angle):
    """Rodrigues rotation about a (unit) axis. axis (..., 3), angle (...)."""
    c = jnp.cos(angle)[..., None, None]
    s = jnp.sin(angle)[..., None, None]
    K = skew(axis)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=axis.dtype), K.shape)
    aaT = axis[..., :, None] * axis[..., None, :]
    return c * eye + s * K + (1.0 - c) * aaT


def rotation_about_axis_cs(axis, c, s):
    """Rodrigues rotation about a (unit) axis with the angle given as a
    (cos, sin) pair — the Pinocchio nq=2 unbounded-revolute convention
    (JointModelRevoluteUnbounded): no trig evaluation, works for any winding.
    axis (..., 3), c/s (...)."""
    c = c[..., None, None]
    s = s[..., None, None]
    K = skew(axis)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=axis.dtype), K.shape)
    aaT = axis[..., :, None] * axis[..., None, :]
    return c * eye + s * K + (1.0 - c) * aaT


def se2_exp(dx, dy, dth):
    """SE(2) exponential: planar tangent (dx, dy, dθ) -> (cos, sin, tx, ty).

    t = V(dθ) @ (dx, dy) with V the planar left-Jacobian
    [[sinθ/θ, -(1-cosθ)/θ], [(1-cosθ)/θ, sinθ/θ]]; Taylor-guarded at θ = 0
    with the dtype-aware cutoff (`_small_angle_cutoff` on θ²)."""
    th2 = dth * dth
    small = th2 < jnp.asarray(_small_angle_cutoff(dth.dtype), dth.dtype)
    safe = jnp.where(small, jnp.ones_like(dth), dth)
    c, s = jnp.cos(dth), jnp.sin(dth)
    a = jnp.where(small, 1.0 - th2 / 6.0, s / safe)           # sinθ/θ
    b = jnp.where(small, 0.5 * dth - th2 * dth / 24.0, (1.0 - c) / safe)
    tx = a * dx - b * dy
    ty = b * dx + a * dy
    return c, s, tx, ty


def quat_to_rotmat(q):
    """Quaternion (x, y, z, w) — Pinocchio/Eigen coeff order — to rotation matrix.

    q (..., 4), not necessarily normalized (normalized internally).
    """
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rpy_to_rotmat(rpy):
    """URDF roll-pitch-yaw (fixed XYZ axes) to rotation: R = Rz(y) Ry(p) Rx(r)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    r00 = cy * cp
    r01 = cy * sp * sr - sy * cr
    r02 = cy * sp * cr + sy * sr
    r10 = sy * cp
    r11 = sy * sp * sr + cy * cr
    r12 = sy * sp * cr - cy * sr
    r20 = -sp
    r21 = cp * sr
    r22 = cp * cr
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


# ---------------------------------------------------------------------------
# SE(3) group ops.  A transform is the pair (R, p) for aMb.
# ---------------------------------------------------------------------------

def se3_identity(dtype=jnp.float64):
    return jnp.eye(3, dtype=dtype), jnp.zeros((3,), dtype=dtype)


def se3_compose(Ra, pa, Rb, pb):
    """(aMb) * (bMc) -> aMc."""
    R = Ra @ Rb
    p = pa + jnp.einsum("...ij,...j->...i", Ra, pb)
    return R, p


def se3_inverse(R, p):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, p)


# ---------------------------------------------------------------------------
# Actions on motions and forces.
# ---------------------------------------------------------------------------

def act_motion(R, p, v):
    """aMb acting on a motion expressed in B -> expressed in A (SE3::act)."""
    ang = jnp.einsum("...ij,...j->...i", R, v[..., ANG])
    lin = jnp.einsum("...ij,...j->...i", R, v[..., LIN]) + jnp.cross(p, ang)
    return jnp.concatenate([lin, ang], axis=-1)


def act_inv_motion(R, p, v):
    """aMb^-1 acting on a motion expressed in A -> expressed in B (SE3::actInv)."""
    lin = jnp.einsum("...ji,...j->...i", R, v[..., LIN] - jnp.cross(p, v[..., ANG]))
    ang = jnp.einsum("...ji,...j->...i", R, v[..., ANG])
    return jnp.concatenate([lin, ang], axis=-1)


def act_force(R, p, f):
    """aMb acting on a force expressed in B -> expressed in A (SE3::act on Force)."""
    lin = jnp.einsum("...ij,...j->...i", R, f[..., LIN])
    ang = jnp.einsum("...ij,...j->...i", R, f[..., ANG]) + jnp.cross(p, lin)
    return jnp.concatenate([lin, ang], axis=-1)


def act_inv_force(R, p, f):
    """aMb^-1 acting on a force expressed in A -> expressed in B."""
    lin = jnp.einsum("...ji,...j->...i", R, f[..., LIN])
    ang = jnp.einsum("...ji,...j->...i", R, f[..., ANG] - jnp.cross(p, f[..., LIN]))
    return jnp.concatenate([lin, ang], axis=-1)


def se3_action_matrix(R, p):
    """6x6 motion action matrix X with X v = act_motion(R, p, v).

    X = [[R, [p]x R], [0, R]] in [linear; angular] ordering
    (pinocchio SE3::toActionMatrix, used in ik-id-description.hpp:458).
    """
    pxR = skew(p) @ R
    z = jnp.zeros_like(R)
    top = jnp.concatenate([R, pxR], axis=-1)
    bot = jnp.concatenate([z, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def se3_dual_action_matrix(R, p):
    """6x6 force action matrix X* with X* f = act_force(R, p, f).

    X* = [[R, 0], [[p]x R, R]] (pinocchio SE3::toDualActionMatrix,
    used in the backward Riccati sweep, loik-loid.hxx:106-107).
    """
    pxR = skew(p) @ R
    z = jnp.zeros_like(R)
    top = jnp.concatenate([R, z], axis=-1)
    bot = jnp.concatenate([pxR, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def se3_act_on_sym6(R, p, H):
    """Congruence transform of a symmetric 6x6 onto the parent frame.

    Returns X* H X^-1 where X is the motion action of (R, p); this is what
    `pinocchio::impl::internal::SE3actOn` computes for the ABA articulated
    inertia update (loik-loid-optimized.hxx:66).  For symmetric H this equals
    Xd @ H @ Xd^T with Xd the dual action matrix, since X^-1 = Xd^T... note
    X^{-T} = Xd  =>  X^-1 = Xd^T.
    """
    Xd = se3_dual_action_matrix(R, p)
    return Xd @ H @ jnp.swapaxes(Xd, -1, -2)


def _small_angle_cutoff(dtype):
    """theta^2 below which the Taylor branch beats the closed form.  The
    closed-form coefficients (1-cos t)/t^2 and (t-sin t)/t^3 cancel
    catastrophically with relative error ~eps/t^2, while the two-term Taylor
    truncates at ~t^4/e2e1; the crossover is t^2 ~ sqrt(eps) — dtype-
    DEPENDENT (1.7e-3 in f32, 7e-8 in f64; a fixed f64-tuned 1e-8 cutoff
    leaves f32 100% wrong for per-tick integration steps ~1e-4..1e-3 rad)."""
    return 5.0 * float(np.sqrt(np.finfo(np.dtype(dtype)).eps))


def exp3_quat(w):
    """SO(3) exponential: rotation vector (..., 3) -> unit quaternion
    (x, y, z, w) in Pinocchio/Eigen coeff order.  Taylor-guarded near 0 with
    a dtype-aware cutoff; grad-safe at w = 0 (the sqrt argument is masked
    before the sqrt, so no NaN leaks through the untaken branch)."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < jnp.asarray(_small_angle_cutoff(w.dtype), w.dtype)
    theta = jnp.sqrt(jnp.where(small, jnp.ones_like(theta2), theta2))
    # sin(theta/2)/theta -> 1/2 - theta^2/48 + O(theta^4)
    s = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(0.5 * theta) / theta)
    # cos(theta/2) -> 1 - theta^2/8 + theta^4/384
    c = jnp.where(
        small,
        1.0 - theta2 / 8.0 + theta2 * theta2 / 384.0,
        jnp.cos(0.5 * theta),
    )
    return jnp.concatenate([s[..., None] * w, c[..., None]], axis=-1)


def quat_mul(q1, q2):
    """Hamilton product of (x, y, z, w) quaternions; composes rotations as
    R(q1 * q2) = R(q1) @ R(q2)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def _so3_coeffs(w):
    """(a, b, d, K, KK) with a = sin t/t, b = (1-cos t)/t^2,
    d = (t-sin t)/t^3 for t = |w| — dtype-aware Taylor cutoff (see
    `_small_angle_cutoff`), grad-safe at w = 0."""
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < jnp.asarray(_small_angle_cutoff(w.dtype), w.dtype)
    safe2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(safe2)
    c, s = jnp.cos(theta), jnp.sin(theta)
    a = jnp.where(small, 1.0 - theta2 / 6.0, s / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - c) / safe2)
    d = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - s) / (safe2 * theta))
    K = skew(w)
    return a, b, d, K, K @ K


def se3_exp_translation(v):
    """Translation part of the SE(3) exponential: p = V(w) @ u with V the
    left-Jacobian of SO(3) (rotation available separately as exp3_quat —
    callers integrating quaternion state need only this half)."""
    u, w = v[..., LIN], v[..., ANG]
    _, b, d, K, KK = _so3_coeffs(w)
    V = (
        jnp.broadcast_to(jnp.eye(3, dtype=v.dtype), K.shape)
        + b[..., None, None] * K
        + d[..., None, None] * KK
    )
    return jnp.einsum("...ij,...j->...i", V, u)


def se3_exp(v):
    """SE(3) exponential of a twist (..., 6) [linear; angular] -> (R, p).

    R = exp3(w); p = V(w) @ u with V the left-Jacobian of SO(3), both
    Taylor-guarded at w = 0 (pure translation) with a dtype-aware cutoff."""
    u, w = v[..., LIN], v[..., ANG]
    a, b, d, K, KK = _so3_coeffs(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=v.dtype), K.shape)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + d[..., None, None] * KK
    p = jnp.einsum("...ij,...j->...i", V, u)
    return R, p


def so3_log(R):
    """SO(3) logarithm: rotation matrix (..., 3, 3) -> rotation vector
    (..., 3) with |w| in [0, pi].  Inverse of the rotation half of `se3_exp`.

    Three guarded regimes: Taylor near theta = 0 (the usual per-tick pose
    errors), the closed form theta/(2 sin theta) * vee(R - R^T) in the bulk,
    and an axis-from-diagonal branch near theta = pi where vee(R - R^T) ~
    2 sin(theta) n underflows (sign of the axis recovered from the symmetric
    part's largest column, overall sign tied to vee so the branch is
    continuous across its threshold; at exactly pi both signs are valid)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(c)
    theta2 = theta * theta
    vee = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    small = theta2 < jnp.asarray(_small_angle_cutoff(R.dtype), R.dtype)
    # theta / (2 sin theta): series 1/2 + theta^2/12 + 7 theta^4/720
    sin_t = jnp.sin(theta)
    safe_sin = jnp.where(small, jnp.ones_like(sin_t), sin_t)
    coef = jnp.where(
        small,
        0.5 + theta2 / 12.0 + 7.0 * theta2 * theta2 / 720.0,
        theta / (2.0 * safe_sin),
    )
    w_bulk = coef[..., None] * vee
    # near-pi branch: n_i = sqrt((R_ii - c) / (1 - c)), signs from the
    # symmetric part S = (R + R^T)/2 relative to the largest |n| component
    near_pi = c < -0.99
    one_minus_c = jnp.where(near_pi, 1.0 - c, jnp.ones_like(c))
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    n_abs = jnp.sqrt(
        jnp.clip((diag - c[..., None]) / one_minus_c[..., None], 0.0, None)
    )
    S = 0.5 * (R + jnp.swapaxes(R, -1, -2))
    k = jnp.argmax(n_abs, axis=-1)  # reference component
    # sign_i = sign(S[k, i]) for i != k; sign_k = +1; then align with vee
    Sk = jnp.take_along_axis(S, k[..., None, None].repeat(3, -1), axis=-2)[
        ..., 0, :
    ]  # (..., 3) row k of S;  S[k,i] = (1-c) n_k n_i for i != k
    onehot_k = jnp.arange(3) == k[..., None]
    # component k is the convention-positive reference (S[k,k] = c +
    # (1-c) n_k^2 can itself be negative, so it must NOT supply the sign)
    sgn = jnp.where(onehot_k, 1.0, jnp.where(Sk >= 0.0, 1.0, -1.0))
    n = sgn * n_abs
    # overall sign: match vee where it is nonzero (continuity across the
    # branch threshold); at exactly pi either sign is a valid log
    flip = jnp.sum(n * vee, axis=-1) < 0.0
    n = jnp.where(flip[..., None], -n, n)
    w_pi = theta[..., None] * n
    return jnp.where(near_pi[..., None], w_pi, w_bulk)


def se3_log(R, p):
    """SE(3) logarithm: placement (R, p) -> twist (..., 6) [linear; angular].
    Inverse of `se3_exp`: u = V(w)^-1 p with V the left-Jacobian of SO(3),
    Taylor-guarded near w = 0 with the dtype-aware cutoff."""
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < jnp.asarray(_small_angle_cutoff(R.dtype), R.dtype)
    safe2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(safe2)
    half = 0.5 * theta
    # g = 1/theta^2 - cos(theta/2) / (2 theta sin(theta/2));
    # series 1/12 + theta^2/720 + theta^4/30240
    sin_h = jnp.sin(half)
    safe_sin = jnp.where(small, jnp.ones_like(sin_h), sin_h)
    g = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe2 - jnp.cos(half) / (2.0 * theta * safe_sin),
    )
    K = skew(w)
    Vinv = (
        jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), K.shape)
        - 0.5 * K
        + g[..., None, None] * (K @ K)
    )
    u = jnp.einsum("...ij,...j->...i", Vinv, p)
    return jnp.concatenate([u, w], axis=-1)


def motion_cross(v1, v2):
    """Motion cross product v1 x v2 (spatial velocity bracket), [lin; ang]."""
    w1, u1 = v1[..., ANG], v1[..., LIN]
    w2, u2 = v2[..., ANG], v2[..., LIN]
    ang = jnp.cross(w1, w2)
    lin = jnp.cross(w1, u2) + jnp.cross(u1, w2)
    return jnp.concatenate([lin, ang], axis=-1)


def inf_norm(x, axis=None):
    return jnp.max(jnp.abs(x), axis=axis)
