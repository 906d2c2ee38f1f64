"""KinematicTree: the batched JAX replacement for `pinocchio::ModelTpl`.

The reference keys every workspace array by joint index into a
heterogeneous `pinocchio::Model` (loik-loid-data-optimized.hxx:40-104).  Here
the tree is a frozen JAX pytree whose *topology is static metadata* (hashable
aux-data: parents, joint types, dof indexing) while *geometry is array leaves*
(joint placements, axes).  Consequences:

  - jit specializes per topology: tree sweeps unroll at trace time with
    static indices — no dynamic gather/scatter inside the hot loop (the
    analog of the reference's allocate-once / malloc-free-hot-loop contract,
    macros.hpp:7-15).
  - placements/axes can change without recompilation (tool changes, model
    perturbations) since they are ordinary traced leaves.

Joint model: each *moving* joint i (0-based; the universe is NOT stored,
unlike pinocchio where joint 0 is the universe) has
  parent[i] in {-1} U [0, i)   (-1 = attached to the world)
  a constant motion subspace S[i] (6 x nv_max) in the local joint frame
  a configuration map M(q_i) computed per joint type.

Supported joint types mirror the pinocchio joints the reference dispatches
over via `jmodel.calc_aba` visitors (loik-loid-optimized.hxx:60): revolute
(arbitrary axis), prismatic, free-flyer, spherical, unbounded revolute
(nq=2 cos/sin, the Pinocchio convention for URDF `continuous`), translation
(3-dof), planar (x, y, θ with nq=4 x/y/cos/sin), and universal (two
sequential rotations; its motion subspace is CONFIGURATION-dependent —
S's second column is fixed, the first is the first axis pulled back through
the second rotation — so trees containing it use the q-aware `joint_S(i, q)`
and the solver precomputes per-problem subspaces at solve time).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import spatial

# Joint type codes (static python ints)
REVOLUTE = 0
PRISMATIC = 1
FREE_FLYER = 2
SPHERICAL = 3
REVOLUTE_UNBOUNDED = 4   # nq = (cos, sin): pinocchio JointModelRevoluteUnbounded
TRANSLATION = 5          # 3-dof translation: pinocchio JointModelTranslation
PLANAR = 6               # x, y, θ; nq = (x, y, cos, sin): pinocchio JointModelPlanar
UNIVERSAL = 7            # two sequential rotations: pinocchio JointModelUniversal
HELICAL = 8              # screw: rotation + pitch-coupled translation along
                         # one axis (pinocchio JointModelHelical); the pitch
                         # is STATIC metadata (tuple in aux data, not a
                         # traced leaf — it parameterizes the motion
                         # subspace, which the solver derives from
                         # trace-time constants; changing pitch recompiles)
SPHERICAL_ZYX = 9        # ball joint on the Euler Z-Y-X chart (pinocchio
                         # JointModelSphericalZYX): nq = nv = 3 Euler-angle
                         # RATES, vector-space integration, configuration-
                         # dependent motion subspace (like UNIVERSAL)
MIMIC_PAIR = 10          # a serial master->mimic pair (URDF <mimic>:
                         # q_mimic = mult*q_master + offset) merged into ONE
                         # 1-dof joint: FK composes master transform, inner
                         # placement, and mimic transform; the motion
                         # subspace S(q) = Ad^-1_{X2 M2(q2)} S_master +
                         # mult*S_mimic is configuration-dependent (like
                         # UNIVERSAL).  (master_type, mimic_type, mult,
                         # offset) live in the static `mimic` aux tuple; the
                         # inner placement is the placement2_R/p leaves.
                         # This is the reduction path for adjacent-mimic
                         # chains (coupled finger phalanges etc.); non-serial
                         # mimics stay rejected by the loaders.

JOINT_NV = {REVOLUTE: 1, PRISMATIC: 1, FREE_FLYER: 6, SPHERICAL: 3,
            REVOLUTE_UNBOUNDED: 1, TRANSLATION: 3, PLANAR: 3, UNIVERSAL: 2,
            HELICAL: 1, SPHERICAL_ZYX: 3, MIMIC_PAIR: 1}
JOINT_NQ = {REVOLUTE: 1, PRISMATIC: 1, FREE_FLYER: 7, SPHERICAL: 4,
            REVOLUTE_UNBOUNDED: 2, TRANSLATION: 3, PLANAR: 4, UNIVERSAL: 2,
            HELICAL: 1, SPHERICAL_ZYX: 3, MIMIC_PAIR: 1}


def _calc_1dof(t, axis, ang, dtype):
    """(R, p) displacement of a 1-dof revolute/prismatic joint at angle/
    offset ``ang`` (leading batch dims supported)."""
    if t == REVOLUTE:
        R = spatial.rotation_about_axis(
            jnp.broadcast_to(axis, ang.shape + (3,)), ang
        )
        return R, jnp.zeros(ang.shape + (3,), dtype)
    if t == PRISMATIC:
        R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), ang.shape + (3, 3))
        return R, ang[..., None] * axis
    raise ValueError(f"mimic pairs support revolute/prismatic members; got {t}")


def _twist_1dof(t, axis, dtype):
    """(linear, angular) parts of a 1-dof joint's unit twist."""
    zero = jnp.zeros((3,), dtype)
    if t == REVOLUTE:
        return zero, jnp.asarray(axis, dtype)
    if t == PRISMATIC:
        return jnp.asarray(axis, dtype), zero
    raise ValueError(f"mimic pairs support revolute/prismatic members; got {t}")


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class KinematicTree:
    """Frozen kinematic tree. Topology static, geometry traced."""

    # --- array leaves (traced) ---
    placement_R: jnp.ndarray  # (N, 3, 3) fixed joint placement rotation (parent frame)
    placement_p: jnp.ndarray  # (N, 3) fixed joint placement translation
    axis: jnp.ndarray         # (N, 3) motion axis (revolute/prismatic); unused otherwise
    velocity_limit: jnp.ndarray  # (nv,) default box bound magnitude per dof

    # --- static metadata (hashable aux data) ---
    parents: Tuple[int, ...]      # (N,) parent joint index, -1 = world
    jtypes: Tuple[int, ...]       # (N,) joint type codes
    idx_v: Tuple[int, ...]        # (N,) first dof index of each joint
    idx_q: Tuple[int, ...]        # (N,) first config index of each joint
    joint_names: Tuple[str, ...]  # (N,)
    name: str = "robot"
    # second rotation axis (universal joints only; None when no joint uses it)
    axis2: object = None          # (N, 3) array leaf or None
    # helical pitch per joint (STATIC — see HELICAL above); None = all zero
    pitches: object = None        # Tuple[float, ...] or None
    # mimic-pair metadata (STATIC, like pitches): per-joint None or
    # (master_type, mimic_type, multiplier, offset); None = no mimic pairs
    mimic: object = None          # Tuple[Optional[Tuple], ...] or None
    # inner placement between a mimic pair's master and mimic joints
    # (array leaves; None when no joint uses them)
    placement2_R: object = None   # (N, 3, 3) or None
    placement2_p: object = None   # (N, 3) or None

    # ------------------------------------------------------------------ #
    # pytree plumbing
    # ------------------------------------------------------------------ #
    def tree_flatten(self):
        leaves = (self.placement_R, self.placement_p, self.axis,
                  self.velocity_limit, self.axis2,
                  self.placement2_R, self.placement2_p)
        aux = (self.parents, self.jtypes, self.idx_v, self.idx_q,
               self.joint_names, self.name, self.pitches, self.mimic)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        pR, pp, ax, vl, ax2, p2R, p2p = leaves
        return cls(pR, pp, ax, vl, *aux[:-2], axis2=ax2, pitches=aux[-2],
                   mimic=aux[-1], placement2_R=p2R, placement2_p=p2p)

    # ------------------------------------------------------------------ #
    # static derived properties
    # ------------------------------------------------------------------ #
    @property
    def njoints(self) -> int:
        """Number of moving joints (= pinocchio njoints - 1, the universe dropped)."""
        return len(self.parents)

    @property
    def nv(self) -> int:
        return sum(JOINT_NV[t] for t in self.jtypes)

    @property
    def nq(self) -> int:
        return sum(JOINT_NQ[t] for t in self.jtypes)

    @property
    def nvs(self) -> Tuple[int, ...]:
        return tuple(JOINT_NV[t] for t in self.jtypes)

    @property
    def nv_max(self) -> int:
        return max(self.nvs)

    @property
    def depth(self) -> int:
        """Longest root-to-leaf chain length."""
        d = {}
        for i, p in enumerate(self.parents):
            d[i] = 1 if p < 0 else d[p] + 1
        return max(d.values())

    @property
    def dtype(self):
        return self.placement_R.dtype

    def children(self, i: int) -> Tuple[int, ...]:
        return tuple(j for j, p in enumerate(self.parents) if p == i)

    @property
    def leaf_joints(self) -> Tuple[int, ...]:
        has_child = set(p for p in self.parents if p >= 0)
        return tuple(i for i in range(self.njoints) if i not in has_child)

    # dof <-> (joint, slot) maps for padded layouts -------------------- #
    @property
    def dof_joint(self) -> Tuple[int, ...]:
        """(nv,) joint index owning each dof."""
        out = []
        for i, nvi in enumerate(self.nvs):
            out.extend([i] * nvi)
        return tuple(out)

    @property
    def padded_to_flat(self) -> Tuple[int, ...]:
        """(nv,) index into a flattened (N*nv_max,) padded dof array."""
        out = []
        for i, nvi in enumerate(self.nvs):
            out.extend(i * self.nv_max + k for k in range(nvi))
        return tuple(out)

    # ------------------------------------------------------------------ #
    # motion subspaces
    # ------------------------------------------------------------------ #
    @property
    def has_q_dependent_S(self) -> bool:
        """True when any joint's motion subspace depends on the configuration
        (universal / spherical-ZYX / mimic-pair joints) — the solver then
        computes per-problem subspaces at solve time instead of
        trace-constant ones."""
        return any(
            t in (UNIVERSAL, SPHERICAL_ZYX, MIMIC_PAIR) for t in self.jtypes
        )

    def joint_S(self, i: int, q: jnp.ndarray = None) -> jnp.ndarray:
        """Motion subspace of joint i, shape (6, nv_i), [linear; angular] rows.

        With per-problem batched geometry leaves (axis of shape (N, B, 3),
        used by the mixed-topology super-batch path) the 1-dof subspaces gain
        a LEADING batch dim: (B, 6, 1).  Universal joints are configuration-
        dependent: pass ``q`` (shape (..., nq)) and batch dims of ``q`` lead
        the result."""
        t = self.jtypes[i]
        dt = self.dtype
        if t in (REVOLUTE, REVOLUTE_UNBOUNDED):
            ax = self.axis[i]
            if ax.ndim == 1:
                return jnp.concatenate([jnp.zeros((3, 1), dt), ax[:, None]], axis=0)
            return jnp.concatenate([jnp.zeros_like(ax), ax], axis=-1)[..., None]
        if t == PRISMATIC:
            ax = self.axis[i]
            if ax.ndim == 1:
                return jnp.concatenate([ax[:, None], jnp.zeros((3, 1), dt)], axis=0)
            return jnp.concatenate([ax, jnp.zeros_like(ax)], axis=-1)[..., None]
        if t == HELICAL:
            # screw twist [pitch*a; a]: pitch is the translation per RADIAN
            # of rotation (pinocchio JointModelHelical convention, v = h*w)
            ax = self.axis[i]
            h = float(self.pitches[i]) if self.pitches is not None else 0.0
            if ax.ndim == 1:
                return jnp.concatenate([h * ax[:, None], ax[:, None]], axis=0)
            return jnp.concatenate([h * ax, ax], axis=-1)[..., None]
        if t == FREE_FLYER:
            return jnp.eye(6, dtype=dt)
        if t == SPHERICAL:
            return jnp.concatenate([jnp.zeros((3, 3), dt), jnp.eye(3, dtype=dt)], axis=0)
        if t == TRANSLATION:
            return jnp.concatenate([jnp.eye(3, dtype=dt), jnp.zeros((3, 3), dt)], axis=0)
        if t == PLANAR:
            # local-frame planar twist: v = (vx, vy, 0; 0, 0, ω) — constant S
            # (pinocchio MotionPlanar; integration handles the manifold)
            S = np.zeros((6, 3))
            S[0, 0] = S[1, 1] = S[5, 2] = 1.0
            return jnp.asarray(S, dt)
        if t == SPHERICAL_ZYX:
            # body-frame angular velocity of R = Rz(a) Ry(b) Rx(c) in terms
            # of Euler-angle rates (the joint's velocity coordinates):
            #   ω = ȧ · Rx(c)^T Ry(b)^T ez + ḃ · Rx(c)^T ey + ċ · ex
            # (pinocchio JointModelSphericalZYX) — depends on (b, c)
            if q is None:
                raise ValueError(
                    f"joint {i} is spherical-ZYX: its motion subspace "
                    "depends on the configuration; call joint_S(i, q)"
                )
            iq = self.idx_q[i]
            b_, c_ = q[..., iq + 1], q[..., iq + 2]
            cb, sb = jnp.cos(b_), jnp.sin(b_)
            cc, sc = jnp.cos(c_), jnp.sin(c_)
            z = jnp.zeros_like(cb)
            o = jnp.ones_like(cb)
            col0 = jnp.stack([-sb, sc * cb, cc * cb], axis=-1)
            col1 = jnp.stack([z, cc, -sc], axis=-1)
            col2 = jnp.stack([o, z, z], axis=-1)
            ang = jnp.stack([col0, col1, col2], axis=-1)      # (..., 3, 3)
            zeros = jnp.zeros(cb.shape + (3, 3), dt)
            return jnp.concatenate([zeros, ang], axis=-2)
        if t == MIMIC_PAIR:
            # merged serial pair: v_C = [Ad^-1_{X2 M2(q2)} S_m + k S_j] q̇1
            # with q2 = k q1 + o (see MIMIC_PAIR above; the coupling makes
            # the column configuration-dependent through M2)
            if q is None:
                raise ValueError(
                    f"joint {i} is a mimic pair: its motion subspace depends "
                    "on the configuration; call joint_S(i, q)"
                )
            mt, jt, k_, o_ = self.mimic[i]
            iq = self.idx_q[i]
            q1 = q[..., iq]
            q2 = k_ * q1 + o_
            a1, a2 = self.axis[i], self.axis2[i]
            R2, p2 = _calc_1dof(jt, a2, q2, dt)
            R2p, p2p = self.placement2_R[i], self.placement2_p[i]
            Rc = R2p @ R2                                     # (...,3,3)
            pc = p2p + jnp.einsum("ij,...j->...i", R2p, p2)
            v1, w1 = _twist_1dof(mt, a1, dt)
            v1 = jnp.broadcast_to(v1, q1.shape + (3,))
            w1 = jnp.broadcast_to(w1, q1.shape + (3,))
            vp = jnp.einsum("...ji,...j->...i", Rc,
                            v1 - jnp.cross(pc, w1))
            wp = jnp.einsum("...ji,...j->...i", Rc, w1)
            v2, w2 = _twist_1dof(jt, a2, dt)
            col = jnp.concatenate([vp + k_ * v2, wp + k_ * w2], axis=-1)
            return col[..., None]                             # (...,6,1)
        if t == UNIVERSAL:
            # body-frame angular velocity of M = R1(q1) R2(q2):
            #   ω = q̇1 · R2(q2)^T a1  +  q̇2 · a2
            # (M^T Ṁ expansion) — depends on q2, so S is solve-time data
            if q is None:
                raise ValueError(
                    f"joint {i} is universal: its motion subspace depends on "
                    "the configuration; call joint_S(i, q)"
                )
            iq = self.idx_q[i]
            a1 = self.axis[i]
            a2 = self.axis2[i]
            q2 = q[..., iq + 1]
            R2 = spatial.rotation_about_axis(
                jnp.broadcast_to(a2, q2.shape + (3,)), q2
            )
            col1 = jnp.einsum("...ji,...j->...i", R2, jnp.broadcast_to(a1, q2.shape + (3,)))
            col2 = jnp.broadcast_to(a2, q2.shape + (3,))
            zeros = jnp.zeros(q2.shape + (3, 2), dt)
            ang = jnp.stack([col1, col2], axis=-1)
            return jnp.concatenate([zeros, ang], axis=-2)
        raise ValueError(f"unknown joint type {t}")

    def joint_S_padded(self, q: jnp.ndarray = None) -> jnp.ndarray:
        """All subspaces zero-padded to (N, 6, nv_max); pass ``q`` (unbatched)
        when the tree contains universal joints."""
        nvm = self.nv_max
        mats = []
        for i in range(self.njoints):
            S = self.joint_S(i, q)
            mats.append(jnp.pad(S, ((0, 0), (0, nvm - S.shape[1]))))
        return jnp.stack(mats)

    def dof_mask_padded(self) -> jnp.ndarray:
        """(N, nv_max) 1.0 where the padded dof slot is real."""
        m = np.zeros((self.njoints, self.nv_max))
        for i, nvi in enumerate(self.nvs):
            m[i, :nvi] = 1.0
        return jnp.asarray(m, dtype=self.dtype)

    # ------------------------------------------------------------------ #
    # configuration-dependent joint transforms
    # ------------------------------------------------------------------ #
    def joint_calc(self, i: int, q: jnp.ndarray):
        """M(q_i): joint displacement (R, p) in the joint's local frame.

        q has shape (..., nq); batching over leading dims is supported.
        Mirrors `jmodel.calc(jdata, q)` in FwdPassInit
        (loik-loid-optimized.hxx:263).
        """
        t = self.jtypes[i]
        iq = self.idx_q[i]
        if t == REVOLUTE:
            ang = q[..., iq]
            R = spatial.rotation_about_axis(jnp.broadcast_to(self.axis[i], ang.shape + (3,)), ang)
            p = jnp.zeros(ang.shape + (3,), self.dtype)
            return R, p
        if t == PRISMATIC:
            d = q[..., iq]
            R = jnp.broadcast_to(jnp.eye(3, dtype=self.dtype), d.shape + (3, 3))
            p = d[..., None] * self.axis[i]
            return R, p
        if t == HELICAL:
            ang = q[..., iq]
            R = spatial.rotation_about_axis(
                jnp.broadcast_to(self.axis[i], ang.shape + (3,)), ang
            )
            h = float(self.pitches[i]) if self.pitches is not None else 0.0
            p = (h * ang)[..., None] * self.axis[i]
            return R, p
        if t == FREE_FLYER:
            p = q[..., iq : iq + 3]
            R = spatial.quat_to_rotmat(q[..., iq + 3 : iq + 7])
            return R, p
        if t == SPHERICAL:
            R = spatial.quat_to_rotmat(q[..., iq : iq + 4])
            p = jnp.zeros(R.shape[:-2] + (3,), self.dtype)
            return R, p
        if t == REVOLUTE_UNBOUNDED:
            # nq = (cos, sin), normalized like pinocchio (robust to drift)
            c, s = q[..., iq], q[..., iq + 1]
            n = jnp.sqrt(c * c + s * s)
            c, s = c / n, s / n
            R = spatial.rotation_about_axis_cs(
                jnp.broadcast_to(self.axis[i], c.shape + (3,)), c, s
            )
            return R, jnp.zeros(c.shape + (3,), self.dtype)
        if t == TRANSLATION:
            p = q[..., iq : iq + 3]
            R = jnp.broadcast_to(jnp.eye(3, dtype=self.dtype), p.shape[:-1] + (3, 3))
            return R, p
        if t == PLANAR:
            x, y = q[..., iq], q[..., iq + 1]
            c, s = q[..., iq + 2], q[..., iq + 3]
            n = jnp.sqrt(c * c + s * s)
            c, s = c / n, s / n
            o = jnp.zeros_like(c)
            l = jnp.ones_like(c)
            R = jnp.stack(
                [
                    jnp.stack([c, -s, o], axis=-1),
                    jnp.stack([s, c, o], axis=-1),
                    jnp.stack([o, o, l], axis=-1),
                ],
                axis=-2,
            )
            p = jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)
            return R, p
        if t == SPHERICAL_ZYX:
            # R = Rz(a) Ry(b) Rx(c) == rpy_to_rotmat((c, b, a))
            a_, b_, c_ = q[..., iq], q[..., iq + 1], q[..., iq + 2]
            rpy = jnp.stack([c_, b_, a_], axis=-1)
            R = spatial.rpy_to_rotmat(rpy)
            return R, jnp.zeros(a_.shape + (3,), self.dtype)
        if t == UNIVERSAL:
            q1, q2 = q[..., iq], q[..., iq + 1]
            R1 = spatial.rotation_about_axis(
                jnp.broadcast_to(self.axis[i], q1.shape + (3,)), q1
            )
            R2 = spatial.rotation_about_axis(
                jnp.broadcast_to(self.axis2[i], q2.shape + (3,)), q2
            )
            return R1 @ R2, jnp.zeros(q1.shape + (3,), self.dtype)
        if t == MIMIC_PAIR:
            # M = M_master(q1) * X2 * M_mimic(k q1 + o)
            mt, jt, k_, o_ = self.mimic[i]
            q1 = q[..., iq]
            q2 = k_ * q1 + o_
            R1, p1 = _calc_1dof(mt, self.axis[i], q1, self.dtype)
            R2, p2 = _calc_1dof(jt, self.axis2[i], q2, self.dtype)
            R2p, p2p = self.placement2_R[i], self.placement2_p[i]
            Rc = R2p @ R2
            pc = p2p + jnp.einsum("ij,...j->...i", R2p, p2)
            R = R1 @ Rc
            p = p1 + jnp.einsum("...ij,...j->...i", R1, pc)
            return R, p
        raise ValueError(f"unknown joint type {t}")

    def neutral(self) -> jnp.ndarray:
        """Neutral configuration (identity transforms), like pinocchio::neutral."""
        q = np.zeros((self.nq,))
        for i, t in enumerate(self.jtypes):
            if t == FREE_FLYER:
                q[self.idx_q[i] + 6] = 1.0  # unit quaternion w
            elif t == SPHERICAL:
                q[self.idx_q[i] + 3] = 1.0
            elif t == REVOLUTE_UNBOUNDED:
                q[self.idx_q[i]] = 1.0      # cos = 1
            elif t == PLANAR:
                q[self.idx_q[i] + 2] = 1.0  # cos = 1
        return jnp.asarray(q, dtype=self.dtype)

    def random_configuration(self, key, batch_shape=()) -> jnp.ndarray:
        """Random configuration; angles in [-pi, pi], quats uniform, xyz in [-1, 1]."""
        q = jax.random.uniform(
            key, batch_shape + (self.nq,), dtype=self.dtype, minval=-np.pi, maxval=np.pi
        )
        # normalize quaternion / (cos, sin) blocks; translations to [-1, 1]
        for i, t in enumerate(self.jtypes):
            iq = self.idx_q[i]
            if t in (FREE_FLYER, SPHERICAL):
                iqq = iq + (3 if t == FREE_FLYER else 0)
                quat = q[..., iqq : iqq + 4]
                quat = quat / jnp.linalg.norm(quat, axis=-1, keepdims=True)
                q = q.at[..., iqq : iqq + 4].set(quat)
            if t == FREE_FLYER:
                q = q.at[..., iq : iq + 3].set(q[..., iq : iq + 3] / np.pi)  # xyz in [-1, 1]
            elif t == TRANSLATION:
                q = q.at[..., iq : iq + 3].set(q[..., iq : iq + 3] / np.pi)
            elif t == REVOLUTE_UNBOUNDED:
                ang = q[..., iq]  # uniform angle -> (cos, sin) on the circle
                q = q.at[..., iq].set(jnp.cos(ang))
                q = q.at[..., iq + 1].set(jnp.sin(ang))
            elif t == PLANAR:
                q = q.at[..., iq : iq + 2].set(q[..., iq : iq + 2] / np.pi)
                ang = q[..., iq + 2]
                q = q.at[..., iq + 2].set(jnp.cos(ang))
                q = q.at[..., iq + 3].set(jnp.sin(ang))
        return q

    def integrate(self, q: jnp.ndarray, dq: jnp.ndarray) -> jnp.ndarray:
        """Configuration-manifold integration q ⊕ dq, Pinocchio convention
        (`pinocchio::integrate`): dq (..., nv) is a tangent step expressed in
        the joint's LOCAL frame.  Needed to close the tracking loop
        (q_next = integrate(q, dt * nu)); the reference defers this to
        Pinocchio, a standalone framework provides it itself.

        Revolute/prismatic add; spherical right-multiplies the quaternion by
        exp3(dw); free-flyer right-multiplies the SE(3) pose by exp6(dv)."""
        out = jnp.asarray(q)
        dq = jnp.asarray(dq)
        for i, t in enumerate(self.jtypes):
            iq, iv = self.idx_q[i], self.idx_v[i]
            if t in (REVOLUTE, PRISMATIC, HELICAL, MIMIC_PAIR):
                out = out.at[..., iq].set(out[..., iq] + dq[..., iv])
            elif t in (TRANSLATION, UNIVERSAL, SPHERICAL_ZYX):
                # vector-space joints: plain addition (pinocchio convention;
                # a translation joint's local frame never rotates, the
                # universal joint's config space is two bounded angles, and
                # spherical-ZYX velocities ARE the Euler-angle rates)
                k = JOINT_NV[t]
                out = out.at[..., iq : iq + k].set(
                    out[..., iq : iq + k] + dq[..., iv : iv + k]
                )
            elif t == REVOLUTE_UNBOUNDED:
                c, s = out[..., iq], out[..., iq + 1]
                dth = dq[..., iv]
                dc, ds = jnp.cos(dth), jnp.sin(dth)
                out = out.at[..., iq].set(c * dc - s * ds)
                out = out.at[..., iq + 1].set(s * dc + c * ds)
            elif t == PLANAR:
                # SE(2) manifold step: M_new = M(q) * exp2(dq), local tangent
                c, s = out[..., iq + 2], out[..., iq + 3]
                dc, ds, tx, ty = spatial.se2_exp(
                    dq[..., iv], dq[..., iv + 1], dq[..., iv + 2]
                )
                out = out.at[..., iq].set(out[..., iq] + c * tx - s * ty)
                out = out.at[..., iq + 1].set(out[..., iq + 1] + s * tx + c * ty)
                out = out.at[..., iq + 2].set(c * dc - s * ds)
                out = out.at[..., iq + 3].set(s * dc + c * ds)
            elif t == SPHERICAL:
                quat = out[..., iq : iq + 4]
                dquat = spatial.exp3_quat(dq[..., iv : iv + 3])
                out = out.at[..., iq : iq + 4].set(spatial.quat_mul(quat, dquat))
            elif t == FREE_FLYER:
                p = out[..., iq : iq + 3]
                quat = out[..., iq + 3 : iq + 7]
                R = spatial.quat_to_rotmat(quat)
                dp = spatial.se3_exp_translation(dq[..., iv : iv + 6])
                p_new = p + jnp.einsum("...ij,...j->...i", R, dp)
                # rotation updates in quaternion space (no rotmat->quat)
                dquat = spatial.exp3_quat(dq[..., iv + 3 : iv + 6])
                out = out.at[..., iq : iq + 3].set(p_new)
                out = out.at[..., iq + 3 : iq + 7].set(
                    spatial.quat_mul(quat, dquat)
                )
            else:  # pragma: no cover
                raise ValueError(f"unknown joint type {t}")
        return out

    # ------------------------------------------------------------------ #
    # forward kinematics
    # ------------------------------------------------------------------ #
    def fwd_kinematics(self, q: jnp.ndarray):
        """liMi and oMi for all joints.

        Returns ``(liMi_R, liMi_p, oMi_R, oMi_p)`` each with leading batch
        dims of ``q`` and a joint axis of size N.  ``liMi = placement * M(q)``
        and ``oMi = oMi[parent] * liMi`` exactly as FwdPassInit
        (loik-loid-optimized.hxx:264-265).
        """
        liMi_R, liMi_p, oMi_R, oMi_p = [], [], [], []
        for i in range(self.njoints):
            Rj, pj = self.joint_calc(i, q)
            R, p = spatial.se3_compose(self.placement_R[i], self.placement_p[i], Rj, pj)
            liMi_R.append(R)
            liMi_p.append(p)
            par = self.parents[i]
            if par < 0:
                oMi_R.append(R)
                oMi_p.append(p)
            else:
                Ro, po = spatial.se3_compose(oMi_R[par], oMi_p[par], R, p)
                oMi_R.append(Ro)
                oMi_p.append(po)
        # place the N joint axis right before the trailing matrix/vector dims
        liMi_R = jnp.stack(liMi_R, axis=-3)
        liMi_p = jnp.stack(liMi_p, axis=-2)
        oMi_R = jnp.stack(oMi_R, axis=-3)
        oMi_p = jnp.stack(oMi_p, axis=-2)
        return liMi_R, liMi_p, oMi_R, oMi_p

    def astype(self, dtype) -> "KinematicTree":
        return dataclasses.replace(
            self,
            placement_R=self.placement_R.astype(dtype),
            placement_p=self.placement_p.astype(dtype),
            axis=self.axis.astype(dtype),
            velocity_limit=self.velocity_limit.astype(dtype),
            axis2=None if self.axis2 is None else self.axis2.astype(dtype),
            placement2_R=(None if self.placement2_R is None
                          else self.placement2_R.astype(dtype)),
            placement2_p=(None if self.placement2_p is None
                          else self.placement2_p.astype(dtype)),
        )


COMPOSITE = "composite"  # make_tree-level sugar, expanded before building


def _mount_R_p(j):
    """A joint dict's own placement as (R, p) numpy matrices."""
    if "R" in j:
        R = np.asarray(j["R"], np.float64)
    else:
        R = np.asarray(
            spatial.rpy_to_rotmat(
                jnp.asarray(j.get("rpy", (0.0, 0.0, 0.0)), jnp.float64)))
    p = np.asarray(j.get("xyz", (0.0, 0.0, 0.0)), np.float64)
    return R, p


def _compose_mount(mount, target):
    """Fold `mount`'s placement into `target`'s (target <- mount * target)."""
    Rm, pm = _mount_R_p(mount)
    Rs, ps = _mount_R_p(target)
    for key in ("R", "rpy", "xyz"):
        target.pop(key, None)
    target["R"] = Rm @ Rs
    target["xyz"] = tuple(pm + Rm @ ps)


def _composite_subs(j):
    """Recursively flatten a composite's `sub` list into plain joint dicts
    (nested composites expand in place, their mount placements composed into
    their own first sub)."""
    subs = []
    for k, sj in enumerate(j["sub"]):
        sj = dict(sj)
        sj.setdefault("name", f"{j['name']}/{k}")
        if sj.get("type") == COMPOSITE:
            if not sj.get("sub"):
                raise ValueError(
                    f"composite joint '{sj['name']}' has no subs")
            inner = _composite_subs(sj)
            _compose_mount(sj, inner[0])
            subs.extend(inner)
        else:
            subs.append(sj)
    return subs


def expand_composites(joints):
    """Expand `type=COMPOSITE` joint dicts into their sub-joint chains.

    A composite joint (pinocchio `JointModelComposite`) stacks sub-joints at
    one mount point: kinematically identical to a serial chain of the subs
    with identity placements between them, which is exactly how it expands
    here (the composite's own placement composes with the first sub's).
    Nested composites expand recursively.  Children indices of later joints
    are remapped to the LAST sub-joint."""
    out = []
    last = {}  # original index -> expanded index of its last sub-joint
    for old_i, j in enumerate(joints):
        par = j["parent"]
        par_new = -1 if par < 0 else last[par]
        if j.get("type") == COMPOSITE:
            if not j.get("sub"):
                raise ValueError(f"composite joint '{j['name']}' has no subs")
            subs = _composite_subs(j)
            _compose_mount(j, subs[0])
            for k, sj in enumerate(subs):
                sj["parent"] = par_new if k == 0 else len(out) - 1
                out.append(sj)
            last[old_i] = len(out) - 1
        else:
            j2 = dict(j)
            j2["parent"] = par_new
            out.append(j2)
            last[old_i] = len(out) - 1
    return out


def make_tree(joints, name="robot", dtype=jnp.float64) -> KinematicTree:
    """Build a KinematicTree from a list of joint dicts.

    Each dict: {name, parent (int, -1=world), type, axis (3,) optional,
    axis2 (3,) optional (universal joints' second rotation axis),
    pitch (helical, m/rad) optional, xyz (3,) optional, rpy (3,) optional,
    R (3,3) optional (overrides rpy)}.
    `type=COMPOSITE` dicts carry a `sub` list of joint dicts (stacked at one
    mount point, pinocchio JointModelComposite) and are expanded into their
    equivalent serial chain.
    Joints must be listed in topological order (parent before child).
    """
    joints = expand_composites(joints)
    parents, jtypes, names, pitches = [], [], [], []
    pR, pp, axes, axes2 = [], [], [], []
    mimics, p2R, p2p = [], [], []
    idx_v, idx_q = [], []
    nv = nq = 0
    for j in joints:
        par = j["parent"]
        if par >= len(parents):
            raise ValueError("joints must be topologically ordered")
        parents.append(par)
        t = j["type"]
        jtypes.append(t)
        names.append(j["name"])
        xyz = np.asarray(j.get("xyz", (0.0, 0.0, 0.0)), dtype=np.float64)
        if "R" in j:
            R = np.asarray(j["R"], dtype=np.float64)
        else:
            rpy = np.asarray(j.get("rpy", (0.0, 0.0, 0.0)), dtype=np.float64)
            R = np.asarray(spatial.rpy_to_rotmat(jnp.asarray(rpy)))
        ax = np.asarray(j.get("axis", (0.0, 0.0, 1.0)), dtype=np.float64)
        n = np.linalg.norm(ax)
        if n > 0:
            ax = ax / n
        ax2 = np.asarray(j.get("axis2", (0.0, 1.0, 0.0)), dtype=np.float64)
        n2 = np.linalg.norm(ax2)
        if n2 > 0:
            ax2 = ax2 / n2
        pR.append(R)
        pp.append(xyz)
        axes.append(ax)
        axes2.append(ax2)
        pitches.append(float(j.get("pitch", 0.0)))
        # mimic-pair extras: static coupling meta + inner placement
        if t == MIMIC_PAIR:
            m = j["mimic"]  # (master_type, mimic_type, multiplier, offset)
            mimics.append((int(m[0]), int(m[1]), float(m[2]), float(m[3])))
            if "R2" in j:
                R2 = np.asarray(j["R2"], dtype=np.float64)
            else:
                rpy2 = np.asarray(j.get("rpy2", (0.0, 0.0, 0.0)),
                                  dtype=np.float64)
                R2 = np.asarray(spatial.rpy_to_rotmat(jnp.asarray(rpy2)))
            p2R.append(R2)
            p2p.append(np.asarray(j.get("xyz2", (0.0, 0.0, 0.0)),
                                  dtype=np.float64))
        else:
            mimics.append(None)
            p2R.append(np.eye(3))
            p2p.append(np.zeros(3))
        idx_v.append(nv)
        idx_q.append(nq)
        nv += JOINT_NV[t]
        nq += JOINT_NQ[t]
    vel_lim = np.full((nv,), np.inf)
    for j, iv, t in zip(joints, idx_v, jtypes):
        if "velocity_limit" in j:
            vel_lim[iv : iv + JOINT_NV[t]] = j["velocity_limit"]
    has_mimic = any(t == MIMIC_PAIR for t in jtypes)
    return KinematicTree(
        placement_R=jnp.asarray(np.stack(pR), dtype=dtype),
        placement_p=jnp.asarray(np.stack(pp), dtype=dtype),
        axis=jnp.asarray(np.stack(axes), dtype=dtype),
        velocity_limit=jnp.asarray(vel_lim, dtype=dtype),
        parents=tuple(parents),
        jtypes=tuple(jtypes),
        idx_v=tuple(idx_v),
        idx_q=tuple(idx_q),
        joint_names=tuple(names),
        name=name,
        axis2=(jnp.asarray(np.stack(axes2), dtype=dtype)
               if any(t in (UNIVERSAL, MIMIC_PAIR) for t in jtypes)
               else None),
        pitches=(tuple(pitches)
                 if any(t == HELICAL for t in jtypes) else None),
        mimic=tuple(mimics) if has_mimic else None,
        placement2_R=(jnp.asarray(np.stack(p2R), dtype=dtype)
                      if has_mimic else None),
        placement2_p=(jnp.asarray(np.stack(p2p), dtype=dtype)
                      if has_mimic else None),
    )
