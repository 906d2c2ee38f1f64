"""Two-stage mixed-precision solve: f32 bulk + f64 warm refinement.

Single precision cannot certify tol 1e-6 on this problem class: the
augmented-Lagrangian penalty mu_eq (default 1e4 * mu) amplifies the Riccati
operands to ||H|| ~ 1e2, so the computed iterates stall at ~eps_f32 * ||H||
~ 1e-5 absolute — measured: only ~70% of the f64-convergent problems pass
tol 1e-6 in pure f32, and the stalled ones burn max_iter (SURVEY.md §7 hard
part 3 anticipated this).

The fix exploits ADMM's warm-startability (the same property the reference
uses across control ticks): run the solver in f32 at a tolerance safely
above the f32 floor, then continue the unconverged-at-1e-6 problems in f64
from the f32 state for a handful of iterations.  Stage 2 pays the f64 cost
only on the short tail, not the bulk of the work.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..params import SolverParams
from ..problem import IkProblem
from .solve import (_flat_nu, _reset_state, _solve_impl, _solve_loop,
                    kkt_residual, prepare_problem, solve, with_S_all)
from .state import SolveResult, SolverState


@functools.partial(jax.jit, static_argnums=(1,))
def _solve_jit_delta(tree, params, q, problem, warm_state, tol_scales):
    return _solve_impl(tree, params, q, problem, warm_state,
                       tol_scales=tol_scales)


def _cast_state(st: SolverState, dtype) -> SolverState:
    def cast(x):
        if x is None:
            return None
        if jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x
    return jax.tree_util.tree_map(cast, st)


def _cast_problem(p: IkProblem, dtype) -> IkProblem:
    return IkProblem(
        H_ref=jnp.asarray(p.H_ref, dtype),
        v_ref=jnp.asarray(p.v_ref, dtype),
        A=jnp.asarray(p.A, dtype),
        b=jnp.asarray(p.b, dtype),
        lb=jnp.asarray(p.lb, dtype),
        ub=jnp.asarray(p.ub, dtype),
        constraint_links=p.constraint_links,
    )


def solve_delta_refined(
    tree,
    params: SolverParams,
    q,
    problem: IkProblem,
    stage1_tol: float = 2e-5,
    stage2_max_iter: Optional[int] = None,
) -> SolveResult:
    """Pure-f32 tight-tolerance solve via delta-form refinement.

    Stage 1 solves normally in f32 down to the f32 floor.  Stage 2 re-solves
    for the CORRECTION dx = x - x_hat: substituting v = v_hat + dv shifts the
    QP to   min 1/2 dx' P dx + (q + P x_hat)' dx
            s.t. A_c dv = b - A v_hat,  lb - nu_hat <= dnu <= ub - nu_hat,
    which is the SAME solver on a shifted problem (v_ref -> v_ref - v_hat,
    b -> b - A v_hat, bounds -> bounds - nu_hat), warm-started at dx = 0 with
    the stage-1 duals (the delta problem's optimal duals equal the original
    ones).  In delta space the residual-critical quantities are O(1e-5), so
    the mu_eq-amplified operators multiply SMALL vectors and absolute
    rounding errors fall to ~eps_f32 * O(1) ~ 1e-7 — below tol 1e-6 —
    without any f64.

    Returns results in the ORIGINAL problem space (nu = nu_hat + dnu, true
    residuals — the delta-space task residual A dv - b_delta IS the original
    A v - b, computed accurately in the small-number space).
    """
    f32 = jnp.float32
    tree32 = tree.astype(f32)
    q32 = jnp.asarray(q, f32)
    prob32 = _cast_problem(problem, f32)
    tol1 = max(stage1_tol, params.tol_abs)
    p1 = params.replace(tol_abs=tol1, tol_rel=max(stage1_tol, params.tol_rel))
    res1 = solve(tree32, p1, q32, prob32)
    st1 = res1.state

    # ---- build the shifted (delta) problem ------------------------------
    # v_hat per link in trailing layout lives in st1.vis (N,6,B);
    # problem leaves are (core..., ) or (B, core...) — shift in batch-leading
    # layout for clarity.
    v_hat = jnp.moveaxis(st1.vis, -1, 0)            # (B,N,6)
    nu_hat = res1.nu                                 # (B,nv)
    B = v_hat.shape[0]

    def lead(x, core_ndim):
        x = jnp.asarray(x, f32)
        if x.ndim == core_ndim:
            return jnp.broadcast_to(x, (B,) + x.shape)
        return x

    v_ref_d = lead(prob32.v_ref, 2) - v_hat
    A_l = lead(prob32.A, 3)                          # (B,NC,6,6)
    cl = problem.constraint_links
    Av_hat = jnp.einsum("bcij,bcj->bci", A_l, v_hat[:, jnp.asarray(cl), :])
    b_d = lead(prob32.b, 2) - Av_hat
    lb_d = lead(prob32.lb, 1) - nu_hat
    ub_d = lead(prob32.ub, 1) - nu_hat
    prob_d = IkProblem(
        H_ref=lead(prob32.H_ref, 3), v_ref=v_ref_d, A=A_l, b=b_d,
        lb=lb_d, ub=ub_d, constraint_links=cl,
    )

    # ---- warm-start state at dx = 0 with stage-1 duals ------------------
    z_d = st1.z - st1.nu        # padded layouts subtract cleanly
    warm = dataclasses.replace(
        st1,
        vis=jnp.zeros_like(st1.vis),
        nu=jnp.zeros_like(st1.nu),
        z=z_d,
        # duals carry over: yis, Aty, w, fis, fdpa, stfw as-is
    )
    p2 = params.replace(
        warm_start=True,
        keep_mu_on_warm_start=True,
        check_feasibility=False,          # certificates are degenerate in
                                          # delta space (b_d ~ 0 makes the
                                          # bound term of cond2 vanish)
        freeze_infeasible_on_warm_start=True,
        max_iter=stage2_max_iter or max(60, params.max_iter // 2),
    )
    # certify the delta problem against the ORIGINAL problem's adaptive-
    # tolerance scales (CheckConvergence semantics, loik-loid-optimized.hxx:
    # 540-565): at x = x_hat + dx the residuals are the original residuals,
    # but delta-space magnitudes are ~0 and would shrink tol to tol_abs
    Av_hat_inf = jnp.max(jnp.abs(Av_hat), axis=(1, 2))            # (B,)
    nu_hat_inf = jnp.max(jnp.abs(nu_hat), axis=1)
    b_inf0 = jnp.max(jnp.abs(lead(prob32.b, 2)), axis=(1, 2))
    Href_vhat = jnp.einsum("bnij,bnj->bni", lead(prob32.H_ref, 3), v_hat)
    Hv_inf0 = jnp.max(
        jnp.abs(jnp.einsum("bnji,bnj->bni", lead(prob32.H_ref, 3),
                           lead(prob32.v_ref, 2))), axis=(1, 2))
    fdpa_inf0 = jnp.max(jnp.abs(st1.fdpa), axis=(0, 1))
    stfw_inf0 = jnp.max(jnp.abs(st1.stfw), axis=(0, 1))
    scale_p = jnp.maximum(jnp.maximum(Av_hat_inf, nu_hat_inf), b_inf0)
    scale_d = jnp.maximum(
        jnp.maximum(jnp.max(jnp.abs(Href_vhat), axis=(1, 2)), Hv_inf0),
        jnp.maximum(fdpa_inf0, stfw_inf0),
    )
    res2 = _solve_jit_delta(tree32, p2, q32, prob_d, warm,
                            (scale_p, scale_d))

    # ---- recombine ------------------------------------------------------
    st2 = res2.state
    vis_full = jnp.moveaxis(st2.vis, -1, 0) + v_hat
    return dataclasses.replace(
        res2,
        nu=res2.nu + nu_hat,
        z=res2.z + nu_hat,
        vis=vis_full,
        iterations=res1.iterations + res2.iterations,
    )


def solve_delta_duals(
    tree,
    params: SolverParams,
    q,
    problem: IkProblem,
    stage1_tol: float = 2e-5,
    stage1_max_iter: int = 32,
    stage2_max_iter: int = 24,
    stage2_mu: float = 1e-2,
    stage2_mu_eq_scale: float = 1e5,
    warm_state: Optional[SolverState] = None,
) -> SolveResult:
    """Tight-tolerance solve with NO f64 loop: f32 stage 1 + f32 delta-duals
    correction stage.  The successor of `solve_two_stage`'s emulated-f64 tail
    (ROADMAP "delta-form refinement study", executed).

    Substituting x = x_hat + dx, y = y_hat + dy into the QP's KKT system
    turns the refinement into the SAME solver run on a shifted problem whose
    linear terms are the stage-1 KKT residuals, with duals starting at ZERO:

      - nu-block linear term  c = d0_nu = (S'f + w)|_hat   (r_offset)
      - v-block linear term       d0_v  = (H_ref v - Hv + fdpa)|_hat
        (folded in as Hv := -d0_v)
      - task rhs   b_delta  = b - A v_hat
      - box bounds shifted by nu_hat; z warm-started at z_hat - nu_hat

    d0 is computed ONCE in f64 (one dual-residual evaluation — the O(1)
    cancellations between mu_eq-amplified quantities happen there, outside
    the loop); every in-loop quantity is then O(stage-1 error) ~ 1e-5, so
    f32 absolute rounding is ~1e-12 and tol 1e-6 certifies honestly against
    the ORIGINAL problem's adaptive-tolerance scales (tol_scale floors, same
    mechanism as `solve_delta_refined`).  Convergence checks in delta space
    evaluate d0 + P dx + A' dy = the original problem's true residuals.

    Infeasibility certificates stay with stage 1 (degenerate in delta space,
    check_feasibility=False + freeze_infeasible_on_warm_start).

    Constant-subspace trees only (universal joints -> use solve_two_stage)."""
    if tree.has_q_dependent_S:
        raise ValueError(
            "solve_delta_duals supports constant motion subspaces only; "
            "use solve_two_stage for trees with universal joints"
        )
    f32, f64 = jnp.float32, jnp.float64
    q = jnp.asarray(q)
    if q.ndim == 1:
        q = q[None]
    tol1 = max(stage1_tol, params.tol_abs)
    p1 = params.replace(
        tol_abs=tol1, tol_rel=max(stage1_tol, params.tol_rel),
        max_iter=min(params.max_iter, stage1_max_iter),
    )
    p2 = params.replace(
        warm_start=True,
        max_iter=stage2_max_iter,
        mu=stage2_mu,
        mu_equality_scale_factor=stage2_mu_eq_scale,
        check_feasibility=False,
        freeze_infeasible_on_warm_start=True,
    )
    return _delta_duals_jit(
        tree.astype(f32), tree.astype(f64), p1, p2, q,
        _cast_problem(problem, f32), _cast_problem(problem, f64),
        _cast_state(warm_state, f32) if warm_state is not None else None,
    )


@functools.partial(jax.jit, static_argnums=(2, 3))
def _delta_duals_jit(tree32, tree64, p1, p2, q, prob32, prob64, warm_state):
    f32, f64 = jnp.float32, jnp.float64
    B = q.shape[0]

    # ---- stage 1: plain f32 solve at the f32-floor tolerance -------------
    res1 = _solve_impl(tree32, p1, q.astype(f32), prob32, warm_state)
    st1 = res1.state

    # ---- one f64 KKT-residual evaluation at the stage-1 point ------------
    st64 = _cast_state(st1, f64)
    pp64 = prepare_problem(tree64, prob64, B, f64)
    d0_v, d0_nu, fdpa_hat = kkt_residual(tree64, pp64, st64)

    Av_hat = jnp.stack(
        [_mv64(pp64.A[k], st64.vis[c])
         for k, c in enumerate(prob64.constraint_links)]
    )                                                     # (NC,6,B)
    b_d = pp64.b - Av_hat
    lb_d = pp64.lb - st64.nu                              # padded slots: 0-0
    ub_d = pp64.ub - st64.nu

    # original-problem adaptive-tolerance scales (CheckConvergence,
    # loik-loid-optimized.hxx:540-565) as (B,) floors for the delta stage
    from . import batched_spatial as bsp

    Href_vhat = bsp.mv(pp64.H_ref, st64.vis)
    scale_p = jnp.maximum(
        jnp.maximum(bsp.inf_norm_b(Av_hat), bsp.inf_norm_b(st64.nu)),
        pp64.b_inf,
    )
    scale_d = jnp.maximum(
        jnp.maximum(bsp.inf_norm_b(Href_vhat), pp64.Hv_inf),
        jnp.maximum(bsp.inf_norm_b(fdpa_hat), bsp.inf_norm_b(d0_nu)),
    )

    # ---- the f32 delta problem ------------------------------------------
    pp32 = prepare_problem(tree32, prob32, B, f32)
    if tree32.axis.ndim == 3:
        # batched geometry (mixed super-batch): precompute per-problem
        # subspaces once; the loop consumes them as data
        pp32 = with_S_all(tree32, pp32, f32)
    prob_d = dataclasses.replace(
        pp32,
        Hv=(-d0_v).astype(f32),
        Hv_inf=bsp.inf_norm_b(d0_v).astype(f32),
        b=b_d.astype(f32),
        Atb=bsp.mtv(pp64.A, b_d).astype(f32),
        b_inf=bsp.inf_norm_b(b_d).astype(f32),
        lb=lb_d.astype(f32),
        ub=ub_d.astype(f32),
        r_offset=d0_nu.astype(f32),
        tol_scale_primal=scale_p.astype(f32),
        tol_scale_dual=scale_d.astype(f32),
    )

    # ---- delta state: dx = 0, duals dy = 0, z = z_hat - nu_hat -----------
    st_d = dataclasses.replace(
        st1,
        vis=jnp.zeros_like(st1.vis),
        fis=jnp.zeros_like(st1.fis),
        nu=jnp.zeros_like(st1.nu),
        z=st1.z - st1.nu,
        w=jnp.zeros_like(st1.w),
        yis=jnp.zeros_like(st1.yis),
        Aty=jnp.zeros_like(st1.Aty),
        fdpa=jnp.zeros_like(st1.fdpa),
        stfw=jnp.zeros_like(st1.stfw),
    )
    st_d = _reset_state(tree32, p2, st_d, f32)

    with jax.default_matmul_precision("highest"):
        st2 = _solve_loop(tree32, prob_d, p2, st_d)

    # ---- recombine in the original space --------------------------------
    nu_hat = _flat_nu(tree32, st1.nu)
    vis_hat = jnp.moveaxis(st1.vis, -1, 0)
    # the returned state is FULL-space (x = x_hat + dx, duals y_hat + dy),
    # so warm-starting the next solve from it is meaningful — a delta-space
    # state would restart every consumer near zero (st2.stfw is already the
    # full-space value: the delta iteration adds r_offset = (S'f + w)|_hat;
    # fdpa needs the stage-boundary f64 evaluation added back)
    st_full = dataclasses.replace(
        st2,
        vis=st2.vis + st1.vis,
        fis=st2.fis + st1.fis,
        nu=st2.nu + st1.nu,
        z=st2.z + st1.nu,
        w=st1.w + st2.w,
        yis=st1.yis + st2.yis,
        Aty=st1.Aty + st2.Aty,
        fdpa=st2.fdpa + fdpa_hat.astype(f32),
    )
    return SolveResult(
        nu=_flat_nu(tree32, st2.nu) + nu_hat,
        z=_flat_nu(tree32, st2.z) + nu_hat,
        vis=jnp.moveaxis(st2.vis, -1, 0) + vis_hat,
        converged=st2.converged,
        primal_infeasible=st2.primal_infeasible,
        dual_infeasible=st2.dual_infeasible,
        iterations=res1.iterations + st2.iterations,
        tail_iterations=st2.tail_iterations,
        primal_residual=st2.primal_residual,
        dual_residual=st2.dual_residual,
        state=st_full,
    )


def _mv64(M, v):
    from . import batched_spatial as bsp

    return bsp.mv(M, v)


def solve_two_stage(
    tree,
    params: SolverParams,
    q,
    problem: IkProblem,
    stage1_tol: float = 2e-5,
    stage1_max_iter: int = 48,
    stage2_max_iter: Optional[int] = None,
    stage2_mu: float = 1e-3,
    stage2_mu_eq_scale: float = 1e6,
    warm_state: Optional[SolverState] = None,
) -> SolveResult:
    """Solve at params.tol_abs/tol_rel accuracy using f32 for the bulk and a
    warm f64 tail.  `tree`/`q`/`problem` may be f32 or f64; outputs are f64.

    Stage 2 uses its own penalty settings: with near-optimal warm duals a
    LARGE equality penalty (mu_eq ~ 1e3) closes the constraint residual in
    1-3 iterations while a small mu_ineq keeps the box duals stable —
    measured max ~6 stage-2 iterations vs ~20 with the stage-1 penalties,
    which matters because the masked batch runs until its slowest member.

    Requires jax x64 to be enabled for stage 2."""
    tol1 = max(stage1_tol, params.tol_abs)
    p1 = params.replace(
        tol_abs=tol1,
        tol_rel=max(stage1_tol, params.tol_rel),
        # cap stage 1: past ~4x the p99 iteration count the stragglers are
        # problems stage 2 must refine or re-certify anyway, and the masked
        # while_loop makes the WHOLE batch pay for its slowest member
        # (measured: mi 200 -> 32 leaves converged fraction unchanged)
        max_iter=min(params.max_iter, stage1_max_iter),
    )
    # stage 2: continue EVERY problem in f64 from the f32 state at the target
    # tolerance (already-converged ones terminate in one or two cheap
    # iterations; stalled ones refine; infeasible ones re-certify).
    p2 = params.replace(
        warm_start=True,
        max_iter=stage2_max_iter or max(20, params.max_iter // 4),
        mu=stage2_mu,
        mu_equality_scale_factor=stage2_mu_eq_scale,
        # problems certified primal-infeasible in stage 1 keep that verdict
        # and skip stage 2 — re-deriving the certificate from a cold dual
        # trajectory in f64 takes ~max_iter and dominated the masked batch
        freeze_infeasible_on_warm_start=True,
    )
    q = jnp.asarray(q)
    single = q.ndim == 1
    if single:
        q = q[None]
    # both stages under ONE jit: XLA dead-code-eliminates the stage-1 result
    # assembly and keeps the intermediate state on-device with no host sync
    # between stages
    return _two_stage_jit(
        tree.astype(jnp.float32), tree.astype(jnp.float64), p1, p2, q,
        _cast_problem(problem, jnp.float32), _cast_problem(problem, jnp.float64),
        _cast_state(warm_state, jnp.float32) if warm_state is not None else None,
    )


@functools.partial(jax.jit, static_argnums=(2, 3))
def _two_stage_jit(tree32, tree64, p1, p2, q, prob32, prob64, warm_state):
    res1 = _solve_impl(tree32, p1, q.astype(jnp.float32), prob32, warm_state)
    res2 = _solve_impl(
        tree64, p2, q.astype(jnp.float64), prob64,
        _cast_state(res1.state, jnp.float64),
    )
    # report combined iteration counts
    return dataclasses.replace(res2, iterations=res1.iterations + res2.iterations)
