"""SolverState / PreparedProblem / SolveResult pytrees for the fast solver.

The batched replacement of `IkIdDataTypeOptimizedTpl`
(loik-loid-data-optimized.hpp:62): the per-joint Eigen workspace becomes flat
structure-of-arrays tensors with the problem batch as the TRAILING axis (see
batched_spatial.py for why).  The reference's 15 incrementally-maintained inf
norms (loik-loid-data-optimized.hpp:259-329) are not stored — they are
cheap `max` reductions recomputed per iteration from these arrays.

Shape legend: N = moving joints, K = nv_max, NC = constraints, B = batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls) if not f.metadata.get("static")]
    static = [f.name for f in dataclasses.fields(cls) if f.metadata.get("static")]

    def flatten(obj):
        return tuple(getattr(obj, n) for n in fields), tuple(getattr(obj, n) for n in static)

    def unflatten(aux, leaves):
        return cls(**dict(zip(fields, leaves)), **dict(zip(static, aux)))

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


def static_field(**kw):
    return dataclasses.field(metadata={"static": True}, **kw)


@_register
@dataclasses.dataclass(frozen=True)
class PreparedProblem:
    """Problem quantities precomputed once per solve_init — the analog of
    `IkProblemFormulationOptimized`'s cached AtA/Atb/Hv and norms
    (ik-id-description-optimized.hpp:78-171)."""

    H_ref: jnp.ndarray   # (N, 6, 6, B)
    Hv: jnp.ndarray      # (N, 6, B)   = H_ref^T v_ref
    A: jnp.ndarray       # (NC, 6, 6, B)
    b: jnp.ndarray       # (NC, 6, B)
    AtA: jnp.ndarray     # (NC, 6, 6, B)
    Atb: jnp.ndarray     # (NC, 6, B)
    lb: jnp.ndarray      # (N, K, B) padded with 0
    ub: jnp.ndarray      # (N, K, B) padded with 0
    b_inf: jnp.ndarray   # (B,)
    Hv_inf: jnp.ndarray  # (B,)
    constraint_links: Tuple[int, ...] = static_field(default=())
    # optional (B,) floors folded into the OSQP adaptive tolerances — used by
    # the delta-form refinement to certify the SHIFTED problem against the
    # ORIGINAL problem's scales (delta-space magnitudes are ~0, which would
    # otherwise make the adaptive tolerance stricter than the reference's
    # CheckConvergence semantics, loik-loid-optimized.hxx:540-565)
    tol_scale_primal: object = None
    tol_scale_dual: object = None
    # optional precomputed motion subspaces (N, 6, K, B), K uniform across
    # joints — per-problem geometry (mixed super-batches, batched axis
    # leaves) built once per solve (`solve.with_S_all`).  S is
    # iteration-constant, so it is data, not computation.
    S_all: object = None
    # optional per-joint tuple of exact-size (6, nv_i, B) subspaces for trees
    # whose S depends on the configuration (universal joints): computed once
    # per solve from q, iteration-constant thereafter.  XLA path only.
    S_list: object = None
    # optional (N, K, B) additive linear term on the nu-block (c'nu in the
    # QP objective; zero in the original formulation).  The delta-duals
    # refinement sets it to the nu-block of the stage-1 KKT residual
    # d0 = P x_hat + q + A' y_hat so the correction QP's duals start at zero
    # and every in-loop quantity is O(stage-1 error) — the pure-f32
    # certification scheme (ROADMAP delta-form refinement study).  It enters
    # FwdPass1's r AND the dual-residual nu-block (S^T f + w + c).
    r_offset: object = None


@_register
@dataclasses.dataclass(frozen=True)
class SolverState:
    """Full per-problem ADMM state; a pytree so it is trivially
    checkpointable (orbax / np.save) and warm-startable by passing it back
    into solve — the rebuild's answer to `Reset(warm_start)`
    (loik-loid-data-optimized.hxx:114-127, SURVEY.md §5 checkpoint/resume)."""

    # kinematics (frozen during iterations; set by solve_init)
    liMi_R: jnp.ndarray  # (N, 3, 3, B)
    liMi_p: jnp.ndarray  # (N, 3, B)

    # primal / dual variables
    vis: jnp.ndarray     # (N, 6, B) link spatial velocities (local frames)
    fis: jnp.ndarray     # (N, 6, B) kinematics-constraint duals ("forces")
    nu: jnp.ndarray      # (N, K, B) joint velocities, padded per-joint layout
    z: jnp.ndarray       # (N, K, B) box-projected slack
    w: jnp.ndarray       # (N, K, B) box-constraint duals
    yis: jnp.ndarray     # (NC, 6, B) task-constraint duals
    Aty: jnp.ndarray     # (NC, 6, B) cached A^T y

    # residual recursion caches (previous iteration values, for deltas)
    fdpa: jnp.ndarray    # (N, 6, B) fis_diff_plus_Aty = A^T y|_v-block
    stfw: jnp.ndarray    # (N, K, B) S^T f + w       = A^T y|_nu-block

    # per-problem scalars
    mu: jnp.ndarray              # (B,)
    mu_eq: jnp.ndarray           # (B,)
    mu_ineq: jnp.ndarray         # (B,)
    iterations: jnp.ndarray      # (B,) i32: iteration at which the problem stopped
    tail_iterations: jnp.ndarray # (B,) i32
    converged: jnp.ndarray       # (B,) bool
    primal_infeasible: jnp.ndarray  # (B,) bool
    dual_infeasible: jnp.ndarray    # (B,) bool
    in_tail: jnp.ndarray         # (B,) bool: in infeasibility tail solve
    running: jnp.ndarray         # (B,) bool
    primal_residual: jnp.ndarray # (B,)
    dual_residual: jnp.ndarray   # (B,)
    delta_x_inf: jnp.ndarray     # (B,) max(|dvis|, |dnu|) for tail-solve check
    delta_z_inf: jnp.ndarray     # (B,)

    it: jnp.ndarray              # () i32 global iteration counter

    # optional per-iteration logs (allocated only when params.logging) — the
    # batched analog of LoikSolverInfo's per-iteration lists
    # (loik-loid.hpp:40-121); NaN marks iterations a problem did not run.
    # Tail-solve lists are recovered by masking with log_in_tail (the
    # batched equivalent of the reference's separate tail_solve_*_list_
    # vectors).  primal_residual_kinematics is identically zero here by
    # construction and is not materialized.
    log_rp: Optional[jnp.ndarray] = None        # (max_iter, B)
    log_rd: Optional[jnp.ndarray] = None        # (max_iter, B)
    log_mu: Optional[jnp.ndarray] = None        # (max_iter, B)
    log_rp_task: Optional[jnp.ndarray] = None   # (max_iter, B)
    log_rp_slack: Optional[jnp.ndarray] = None  # (max_iter, B)
    log_rd_v: Optional[jnp.ndarray] = None      # (max_iter, B)
    log_rd_nu: Optional[jnp.ndarray] = None     # (max_iter, B)
    log_mu_eq: Optional[jnp.ndarray] = None     # (max_iter, B)
    log_mu_ineq: Optional[jnp.ndarray] = None   # (max_iter, B)
    log_in_tail: Optional[jnp.ndarray] = None   # (max_iter, B) 1.0 = tail iter
    log_dx: Optional[jnp.ndarray] = None        # (max_iter, B) |delta x|_inf
    log_dz: Optional[jnp.ndarray] = None        # (max_iter, B) |delta z|_inf


LOG_FIELDS = (
    "log_rp", "log_rd", "log_mu", "log_rp_task", "log_rp_slack",
    "log_rd_v", "log_rd_nu", "log_mu_eq", "log_mu_ineq", "log_in_tail",
    "log_dx", "log_dz",
)


def init_state(tree, B: int, num_constraints: int, dtype, max_iter: int = 0,
               logging: bool = False) -> SolverState:
    N, K = tree.njoints, tree.nv_max
    NC = num_constraints
    z6 = jnp.zeros((N, 6, B), dtype)
    zK = jnp.zeros((N, K, B), dtype)
    zB = jnp.zeros((B,), dtype)
    zbool = jnp.zeros((B,), bool)
    zi = jnp.zeros((B,), jnp.int32)
    return SolverState(
        liMi_R=jnp.zeros((N, 3, 3, B), dtype),
        liMi_p=jnp.zeros((N, 3, B), dtype),
        vis=z6, fis=z6, nu=zK, z=zK, w=zK,
        yis=jnp.zeros((NC, 6, B), dtype),
        Aty=jnp.zeros((NC, 6, B), dtype),
        fdpa=z6, stfw=zK,
        mu=zB, mu_eq=zB, mu_ineq=zB,
        iterations=zi, tail_iterations=zi,
        converged=zbool, primal_infeasible=zbool, dual_infeasible=zbool,
        in_tail=zbool, running=zbool,
        primal_residual=jnp.full((B,), jnp.inf, dtype),
        dual_residual=jnp.full((B,), jnp.inf, dtype),
        delta_x_inf=zB, delta_z_inf=zB,
        it=jnp.zeros((), jnp.int32),
        **(
            {name: jnp.full((max_iter, B), jnp.nan, dtype) for name in LOG_FIELDS}
            if logging else {}
        ),
    )


@_register
@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Batch-leading user-facing result (converted from internal layout)."""

    nu: jnp.ndarray                 # (B, nv) joint velocities
    z: jnp.ndarray                  # (B, nv) box-projected joint velocities
    vis: jnp.ndarray                # (B, N, 6) link spatial velocities
    converged: jnp.ndarray          # (B,) bool
    primal_infeasible: jnp.ndarray  # (B,) bool
    dual_infeasible: jnp.ndarray    # (B,) bool
    iterations: jnp.ndarray         # (B,) i32
    tail_iterations: jnp.ndarray    # (B,) i32
    primal_residual: jnp.ndarray    # (B,)
    dual_residual: jnp.ndarray      # (B,)
    state: SolverState              # full final state (warm start / inspection)
    log_rp: Optional[jnp.ndarray] = None  # (max_iter, B) when logging
    log_rd: Optional[jnp.ndarray] = None
    log_mu: Optional[jnp.ndarray] = None
    log_rp_task: Optional[jnp.ndarray] = None
    log_rp_slack: Optional[jnp.ndarray] = None
    log_rd_v: Optional[jnp.ndarray] = None
    log_rd_nu: Optional[jnp.ndarray] = None
    log_mu_eq: Optional[jnp.ndarray] = None
    log_mu_ineq: Optional[jnp.ndarray] = None
    log_in_tail: Optional[jnp.ndarray] = None
    log_dx: Optional[jnp.ndarray] = None
    log_dz: Optional[jnp.ndarray] = None
