"""Spatial algebra specialized for the fast solver's trailing-batch layout.

Every array carries the problem batch as its LAST axis, so each elementwise
op runs contiguously across the whole batch while the tiny spatial dims
(3/6) are unrolled at trace time.  This layout is the single most important
deviation from a naive port of the reference's per-joint Eigen ops
(SURVEY.md §7 hard part 1).

Shapes: R (..., 3, 3, B), p (..., 3, B), motions/forces (..., 6, B),
6x6 operators (..., 6, 6, B).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

LIN = slice(0, 3)
ANG = slice(3, 6)


# All contractions are SLICE-ACCUMULATE chains of elementwise FMAs over the
# tiny spatial dims (3/6): no dot_general (XLA transposes around
# trailing-batch dots, and a dot would also be subject to reduced matmul
# precision), no axis reductions (each jnp.sum breaks XLA elementwise fusion
# and writes the intermediate out to device memory), and no mid-axis integer
# indexing (a gather).  Static slices keep singleton axes; squeezes are
# explicit reshapes of singletons.


def _sq(x, axis):
    return jnp.squeeze(x, axis)


def mv(M, v):
    """Matrix @ vector over trailing batch: (..., i, j, B), (..., j, B) -> (..., i, B).

    `v` may also be broadcastable, e.g. (..., j, 1) for a shared vector."""
    k = M.shape[-2]
    acc = M[..., :, 0:1, :] * jnp.expand_dims(v[..., 0:1, :], -3)
    for j in range(1, k):
        acc = acc + M[..., :, j : j + 1, :] * jnp.expand_dims(v[..., j : j + 1, :], -3)
    return _sq(acc, -2)


def mtv(M, v):
    """Matrix^T @ vector: (..., j, i, B), (..., j, B) -> (..., i, B)."""
    n = M.shape[-3]
    acc = M[..., 0:1, :, :] * jnp.expand_dims(v[..., 0:1, :], -2)
    for j in range(1, n):
        acc = acc + M[..., j : j + 1, :, :] * jnp.expand_dims(v[..., j : j + 1, :], -2)
    return _sq(acc, -3)


def mm(A, B):
    """(..., i, j, B) @ (..., j, k, B) -> (..., i, k, B) as a sum of outer
    products of A columns with B rows (slices only, no reductions)."""
    n = A.shape[-2]
    acc = A[..., :, 0:1, :] * B[..., 0:1, :, :]
    for j in range(1, n):
        acc = acc + A[..., :, j : j + 1, :] * B[..., j : j + 1, :, :]
    return acc


def mtm(A, B):
    """A^T @ B: (..., j, i, B), (..., j, k, B) -> (..., i, k, B)."""
    n = A.shape[-3]
    acc = jnp.swapaxes(A[..., 0:1, :, :], -3, -2) * B[..., 0:1, :, :]
    for j in range(1, n):
        acc = acc + jnp.swapaxes(A[..., j : j + 1, :, :], -3, -2) * B[..., j : j + 1, :, :]
    return acc


def mmt(A, B):
    """A @ B^T: (..., i, j, B), (..., k, j, B) -> (..., i, k, B)."""
    n = A.shape[-2]
    acc = A[..., :, 0:1, :] * jnp.swapaxes(B[..., :, 0:1, :], -3, -2)
    for j in range(1, n):
        acc = acc + A[..., :, j : j + 1, :] * jnp.swapaxes(B[..., :, j : j + 1, :], -3, -2)
    return acc


def cross(a, b):
    """Cross product on (..., 3, B) arrays."""
    ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-2
    )


def act_motion(R, p, v):
    """aMb acting on motion in B-frame -> A-frame; [linear; angular] rows."""
    ang = mv(R, v[..., ANG, :])
    lin = mv(R, v[..., LIN, :]) + cross(p, ang)
    return jnp.concatenate([lin, ang], axis=-2)


def act_inv_motion(R, p, v):
    lin = mtv(R, v[..., LIN, :] - cross(p, v[..., ANG, :]))
    ang = mtv(R, v[..., ANG, :])
    return jnp.concatenate([lin, ang], axis=-2)


def act_force(R, p, f):
    lin = mv(R, f[..., LIN, :])
    ang = mv(R, f[..., ANG, :]) + cross(p, lin)
    return jnp.concatenate([lin, ang], axis=-2)


def skew(v):
    """(..., 3, B) -> (..., 3, 3, B)."""
    x, y, z = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], axis=-2),
            jnp.stack([z, o, -x], axis=-2),
            jnp.stack([-y, x, o], axis=-2),
        ],
        axis=-3,
    )


def dual_action_matrix(R, p):
    """X* = [[R, 0], [[p]x R, R]]: (..., 3, 3, B),(..., 3, B) -> (..., 6, 6, B)."""
    pxR = mm(skew(p), R)
    z = jnp.zeros_like(R)
    top = jnp.concatenate([R, z], axis=-2)
    bot = jnp.concatenate([pxR, R], axis=-2)
    return jnp.concatenate([top, bot], axis=-3)


def skew_mm(p, M):
    """P(p) @ M for 3x3 M without materializing the skew matrix:
    row_i(PM) is a cross-product combination — 6 multiplies instead of 27."""
    a, b, c = p[..., 0:1, :], p[..., 1:2, :], p[..., 2:3, :]
    M0 = M[..., 0, :, :]
    M1 = M[..., 1, :, :]
    M2 = M[..., 2, :, :]
    return jnp.stack([b * M2 - c * M1, c * M0 - a * M2, a * M1 - b * M0],
                     axis=-3)


def mm_skew(M, p):
    """M @ P(p) for 3x3 M: columns of MP are cross-product combinations."""
    a, b, c = p[..., 0:1, :], p[..., 1:2, :], p[..., 2:3, :]
    C0 = M[..., :, 0, :]
    C1 = M[..., :, 1, :]
    C2 = M[..., :, 2, :]
    return jnp.stack([c * C1 - b * C2, a * C2 - c * C0, b * C0 - a * C1],
                     axis=-2)


def act_sym6(R, p, H):
    """X* H X*^T — congruence transform of a symmetric 6x6 recursion operator
    to the parent frame (`SE3actOn`, loik-loid-optimized.hxx:66).

    Two implementations with identical math:

    - f32: two dense 6x6 products — the fewest, largest elementwise ops.
    - f64 (the refinement stage): block form exploiting
      X* = [[R,0],[[p]x R, R]] and the symmetry of H — six 3x3 rotations
      + three skew products, ~2.1x fewer multiplies, and the bottom-left
      block is the mirrored top-right (SE3actOn's own symmetric-triangle
      trick, loik-loid-optimized.hxx:66).
    """
    if H.dtype != jnp.float64:
        Xd = dual_action_matrix(R, p)
        return mmt(mm(Xd, H), Xd)
    A = H[..., LIN, LIN, :]
    Bl = H[..., ANG, LIN, :]
    C = H[..., ANG, ANG, :]
    A1 = mmt(mm(R, A), R)      # R A R^T
    B1 = mmt(mm(R, Bl), R)     # R B R^T
    C1 = mmt(mm(R, C), R)      # R C R^T
    BL = skew_mm(p, A1) + B1                    # P A' + B'
    TR = jnp.swapaxes(BL, -3, -2)               # = (P A' + B')^T
    BR = skew_mm(p, TR) - mm_skew(B1, p) + C1   # P A' P^T + P B'^T + B' P^T + C'
    top = jnp.concatenate([A1, TR], axis=-2)
    bot = jnp.concatenate([BL, BR], axis=-2)
    return jnp.concatenate([top, bot], axis=-3)


def inf_norm_b(x):
    """Inf-norm over all axes except the trailing batch -> (B,)."""
    return jnp.max(jnp.abs(x), axis=tuple(range(x.ndim - 1)))


def spd_inv(D):
    """Inverse of a small SPD matrix (..., k, k, B) by fully unrolled
    Cholesky + triangular inverse: every op is elementwise over the trailing
    batch axis, which avoids the batch transposes around LAPACK-shaped
    kernels that jnp.linalg.inv would bring.  k is static
    and tiny (joint dof: 1/3/6); D = S'HS + mu*I is SPD by construction."""
    k = D.shape[-2]
    if k == 1:
        return 1.0 / D

    def pick(i, j):
        return _sq(_sq(D[..., i : i + 1, j : j + 1, :], -2), -2)

    d = [[pick(i, j) for j in range(k)] for i in range(k)]
    # Cholesky: D = L L^T, L lower with positive diagonal
    L = [[None] * k for _ in range(k)]
    Ldi = [None] * k  # 1 / L[j][j]
    for j in range(k):
        s = d[j][j]
        for p in range(j):
            s = s - L[j][p] * L[j][p]
        Ldi[j] = jax.lax.rsqrt(s)
        L[j][j] = s * Ldi[j]  # sqrt(s)
        for i in range(j + 1, k):
            s = d[i][j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            L[i][j] = s * Ldi[j]
    # M = L^{-1} (lower): M[i][i] = 1/L[i][i];
    # M[i][j] = -(sum_{p=j}^{i-1} L[i][p] M[p][j]) / L[i][i]
    M = [[None] * k for _ in range(k)]
    for i in range(k):
        M[i][i] = Ldi[i]
        for j in range(i):
            s = L[i][j] * M[j][j]
            for p in range(j + 1, i):
                s = s + L[i][p] * M[p][j]
            M[i][j] = -s * Ldi[i]
    # D^{-1} = M^T M; entry (i,j) sums over p >= max(i,j)
    rows = []
    for i in range(k):
        cols = []
        for j in range(k):
            lo = max(i, j)
            s = M[lo][i] * M[lo][j]
            for p in range(lo + 1, k):
                s = s + M[p][i] * M[p][j]
            cols.append(s)
        rows.append(jnp.stack(cols, axis=-2))
    return jnp.stack(rows, axis=-3)
