"""The production batched ADMM solver.

Batched re-design of `FirstOrderLoikOptimizedTpl`
(loik-loid-optimized.hpp:22-808): one jit-compiled `lax.while_loop` whose
body is a full ADMM iteration over a BATCH of independent problems —

  FwdPass1 -> BwdPass (Riccati, leaf->root) -> FwdPass2 (root->leaf)
  -> BoxProj -> DualUpdate -> residual recursion (BwdPass2) -> convergence
  / infeasibility checks -> per-problem mu update

with these deliberate departures from the reference's structure:

- Tree sweeps unroll at TRACE time over the static topology: each per-joint
  step is pure SSA on (6,B)/(6,6,B) values (no dynamic indexing, no
  scatter); the batch axis is trailing, so every elementwise op runs
  across the whole batch.
- Per-joint D blocks use the joint's EXACT dof count (static): revolute
  joints get scalar reciprocals, free-flyers get 6x6 batched inverses —
  the branchless analog of pinocchio's `calc_aba` per-joint-type dispatch
  (loik-loid-optimized.hxx:60).
- Early exit is MASKED: problems that converge / finish their infeasibility
  tail solve freeze (jnp.where merge) while the rest keep iterating; the
  loop ends when every problem is done (SURVEY.md §7 translation table).
- The 15 incrementally-tracked inf-norms of the optimized reference
  (loik-loid-data-optimized.hpp:259-329) become direct max-reductions.
- Per-problem mu: the scalar penalty adaptation (loik-loid-optimized.hxx:
  613-641) vectorizes to a (B,) mu vector.
- Dual infeasibility is NOT detected, matching the optimized reference
  whose CheckFeasibility never sets dual_infeasible_
  (loik-loid-optimized.hxx:572-606); the oracle detects both.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..params import SolverParams
from ..problem import IkProblem
from . import batched_spatial as bsp
from .state import PreparedProblem, SolverState, SolveResult, init_state

# --------------------------------------------------------------------------- #
# problem preparation (SolveInit phase)
# --------------------------------------------------------------------------- #


def _to_trailing(x, batch: int, core_ndim: int):
    """Broadcast a possibly-unbatched leaf to (core..., B) trailing layout."""
    x = jnp.asarray(x)
    if x.ndim == core_ndim:  # unbatched: share across batch
        return jnp.broadcast_to(x[..., None], x.shape + (batch,))
    # leading batch -> trailing
    return jnp.moveaxis(x, 0, -1)


def prepare_problem(tree, problem: IkProblem, B: int, dtype) -> PreparedProblem:
    """Precompute Hv, AtA, Atb and norms once per solve — the analog of
    `IkProblemFormulationOptimized::UpdateReference/UpdateEqConstraints`
    (ik-id-description-optimized.hpp:78-171)."""
    N, K, nv = tree.njoints, tree.nv_max, tree.nv
    H_ref = _to_trailing(problem.H_ref, B, 3).astype(dtype)   # (N,6,6,B)
    v_ref = _to_trailing(problem.v_ref, B, 2).astype(dtype)   # (N,6,B)
    A = _to_trailing(problem.A, B, 3).astype(dtype)           # (NC,6,6,B)
    b = _to_trailing(problem.b, B, 2).astype(dtype)           # (NC,6,B)
    lb = _to_trailing(problem.lb, B, 1).astype(dtype)         # (nv,B)
    ub = _to_trailing(problem.ub, B, 1).astype(dtype)

    Hv = bsp.mtv(H_ref, v_ref)                                # H_ref^T v_ref
    AtA = bsp.mtm(A, A)
    Atb = bsp.mtv(A, b)

    # scatter flat (nv,B) bounds into padded (N,K,B); padding slots stay 0
    def pad_dofs(flat):
        out = jnp.zeros((N, K, B), dtype)
        for i in range(N):
            iv, k = tree.idx_v[i], tree.nvs[i]
            out = out.at[i, :k].set(flat[iv : iv + k])
        return out

    return PreparedProblem(
        H_ref=H_ref,
        Hv=Hv,
        A=A,
        b=b,
        AtA=AtA,
        Atb=Atb,
        lb=pad_dofs(lb),
        ub=pad_dofs(ub),
        b_inf=bsp.inf_norm_b(b),
        Hv_inf=bsp.inf_norm_b(Hv),
        constraint_links=problem.constraint_links,
    )


def with_S_all(tree, prob: PreparedProblem, dtype) -> PreparedProblem:
    """Attach precomputed per-problem motion subspaces for batched-geometry
    trees (axis (N, B, 3), the mixed super-batch path): S becomes DATA,
    (N, 6, K, B) built once per solve, instead of being rebuilt from the
    axis leaf inside the loop."""
    K = tree.nv_max
    if any(k != K for k in tree.nvs):
        raise ValueError(
            "batched geometry needs uniform joint dof counts (serial 1-dof "
            "chains)"
        )
    S_all = jnp.stack(
        [jnp.moveaxis(tree.joint_S(i).astype(dtype), 0, -1)
         for i in range(tree.njoints)]
    )
    return dataclasses.replace(prob, S_all=S_all)


def fwd_pass_init(tree, q):
    """FK: liMi per joint in trailing-batch layout.  q (B, nq).
    (FwdPassInit, loik-loid-optimized.hxx:253-283; oMi is not needed by the
    solver recursions — only liMi enters the sweeps.)"""
    lR, lp, _, _ = tree.fwd_kinematics(q)  # (B,N,3,3), (B,N,3)
    return jnp.moveaxis(lR, 0, -1), jnp.moveaxis(lp, 0, -1)


# --------------------------------------------------------------------------- #
# one full ADMM iteration (all problems, unmasked)
# --------------------------------------------------------------------------- #


def _S_lists(tree, prob: PreparedProblem, B: int, dtype):
    """Per-joint motion-subspace tiles (6, k, B), exact dof sizes.

    S leaves are traced (they derive from the tree's axis leaf), broadcast
    to the full (6, k, B) tile up front; XLA fuses the explicit broadcast
    into consumers.  Per-problem batched subspaces — (B, 6, k) from the
    mixed super-batch path — move their batch dim to the trailing axis
    instead."""
    def _S_tile(i):
        Si = tree.joint_S(i).astype(dtype)
        if Si.ndim == 3:
            return jnp.moveaxis(Si, 0, -1)              # (B,6,k) -> (6,k,B)
        return jnp.broadcast_to(Si[:, :, None], (6, tree.nvs[i], B))

    if prob.S_list is not None:  # per-joint exact-size (6, k, B), q-dependent
        return list(prob.S_list)
    if prob.S_all is not None:   # precomputed (N,6,K,B), uniform K (see state)
        return [prob.S_all[i] for i in range(tree.njoints)]
    return [_S_tile(i) for i in range(tree.njoints)]


def _h_sweep(tree, prob: PreparedProblem, params: SolverParams,
             st: SolverState, S):
    """The mu-dependent half of the backward Riccati sweep: accumulated His,
    U = H S, D^-1 and U D^-1 per joint (calc_aba quantities,
    loik-loid-optimized.hxx:21-83).  Depends only on (mu_eq, mu_ineq) and the
    iteration-constant geometry — not on the duals or p."""
    N = tree.njoints
    dtype = st.vis.dtype
    nvs, parents = tree.nvs, tree.parents
    mu_eq, mu_ineq = st.mu_eq, st.mu_ineq
    rho = jnp.asarray(params.rho, dtype)
    eye6 = jnp.eye(6, dtype=dtype)[:, :, None]

    H = rho * eye6 + prob.H_ref                    # (N,6,6,B)
    H_list = [H[i] for i in range(N)]
    for k, c in enumerate(prob.constraint_links):
        H_list[c] = H_list[c] + mu_eq * prob.AtA[k]

    Dinv = [None] * N
    U = [None] * N
    UDinv = [None] * N
    for i in reversed(range(N)):
        Si = S[i]
        k = nvs[i]
        Hi = H_list[i]       # (6,6,B) accumulated (children already added)
        Ui = bsp.mm(Hi, Si)                                # H S    (6,k,B)
        Di = bsp.mtm(Si, Ui)                               # S^T H S (k,k,B)
        Ri = mu_ineq * jnp.eye(k, dtype=dtype)[:, :, None]
        Di = Di + Ri
        # unrolled SPD Cholesky inverse: elementwise over the batch, free of
        # the batch transposes around LAPACK-shaped kernels
        Dinv_i = bsp.spd_inv(Di)
        Dinv[i], U[i] = Dinv_i, Ui
        par = parents[i]
        if par >= 0:
            UDinv[i] = bsp.mm(Ui, Dinv_i)                      # (6,k,B)
            Ha = Hi - bsp.mmt(UDinv[i], Ui)                    # H - U D^-1 U^T
            H_list[par] = H_list[par] + bsp.act_sym6(
                st.liMi_R[i], st.liMi_p[i], Ha
            )
    return H_list, U, Dinv, UDinv


def _iteration(tree, prob: PreparedProblem, params: SolverParams, st: SolverState,
               debug: bool = False, compute_checks: bool = True,
               h_cache=None):
    """Compute one ADMM iteration for every problem in the batch; returns the
    pieces needed for flag/penalty updates.  Pure function of the state.

    debug=True additionally returns every per-pass intermediate (post-FwdPass1
    H/p, post-BwdPass accumulated H/p/Dinv/r_tot, FwdPass2 outputs, dual-
    update deltas, residual components and adaptive tolerances) in
    ``checks["debug"]`` for the pass-by-pass lockstep test — the rebuild's
    analog of the reference's component-wise oracle comparison
    (tests/loik-loid.cpp:305-556).  Only used outside jit; the extra dict is
    dead code under the default False.

    compute_checks=False runs only the iterate updates (FwdPass1, the Riccati
    sweeps, BoxProj, the dual updates) and returns ``(partial_new, None)``
    with just {vis, fis, nu, z, w, yis, Aty} — the skipped-iteration form of
    ``params.check_interval > 1``: no residual norms, no BwdPass2 dual-
    residual sweep, no tolerances or certificate pieces.

    h_cache: optional precomputed ``(S, _h_sweep(...))`` tuple.  The Riccati
    matrix half depends only on (mu_eq, mu_ineq, liMi, prob) — all constant
    across the micro-iterations of one check_interval body call — so the
    K-unrolled loop body computes it once and shares it (values identical by
    construction; this is a trace-time hoist, not an approximation)."""
    N, K = tree.njoints, tree.nv_max
    dtype = st.vis.dtype
    B = st.vis.shape[-1]
    S = h_cache[0] if h_cache is not None else _S_lists(tree, prob, B, dtype)
    nvs, parents = tree.nvs, tree.parents
    c_links = prob.constraint_links
    mu_eq = st.mu_eq  # (B,)
    mu_ineq = st.mu_ineq

    # dtype-pinned scalar hyper-parameters
    rho = jnp.asarray(params.rho, dtype)
    zero = jnp.asarray(0.0, dtype)
    tol_abs = jnp.asarray(params.tol_abs, dtype)
    tol_rel = jnp.asarray(params.tol_rel, dtype)
    tol_primal_inf = jnp.asarray(params.tol_primal_inf, dtype)

    eye6 = jnp.eye(6, dtype=dtype)[:, :, None]

    # ---------------- FwdPass1 (loik-loid-optimized.hxx:290-338) ----------
    # The H half (His, U, D^-1, U D^-1 — everything touched by the Riccati
    # matrix recursion) lives in `_h_sweep`; the p/r half below runs every
    # iteration.  Constrained joints get their mu_eq terms added on the
    # unstacked values (no scatter — keeps the whole pass SSA).
    r = st.w - mu_ineq * st.z                      # (N,K,B)
    if prob.r_offset is not None:  # delta-duals nu-block linear term
        r = r + prob.r_offset
    p = -rho * st.vis - prob.Hv                    # vis == vis_prev at entry
    p_list = [p[i] for i in range(N)]
    for k, c in enumerate(c_links):
        p_list[c] = p_list[c] + st.Aty[k] - mu_eq * prob.Atb[k]
    lR = [st.liMi_R[i] for i in range(N)]
    lp = [st.liMi_p[i] for i in range(N)]
    dbg = {}
    if debug:  # post-FwdPass1 snapshot (pre-accumulation H rebuilt for the
        # lockstep comparison; arrays are immutable — copy the lists)
        H0 = rho * eye6 + prob.H_ref
        H0_list = [H0[i] for i in range(N)]
        for k, c in enumerate(c_links):
            H0_list[c] = H0_list[c] + mu_eq * prob.AtA[k]
        dbg["H_fwd1"] = H0_list
        dbg["p_fwd1"] = list(p_list)
        dbg["r_fwd1"] = r

    # ---------------- BwdPass: backward Riccati sweep ---------------------
    # (loik-loid.hxx:82-113 semantics via the calc_aba form,
    #  loik-loid-optimized.hxx:21-83).  Matrix recursion in `_h_sweep`; the
    # p/r recursion interleaves with it in the reference — split here, same
    # order/values.
    if h_cache is not None:
        H_list, U, Dinv, UDinv = h_cache[1]
    else:
        H_list, U, Dinv, UDinv = _h_sweep(tree, prob, params, st, S)
    r_tot = [None] * N
    for i in reversed(range(N)):
        k = nvs[i]
        pi = p_list[i]       # (6,B) accumulated (children already added)
        ri = r[i, :k] + bsp.mtv(S[i], pi)                  # r + S^T p  (k,B)
        r_tot[i] = ri
        par = parents[i]
        if par >= 0:
            pa = pi - bsp.mv(UDinv[i], ri)                     # p - U D^-1 r
            p_list[par] = p_list[par] + bsp.act_force(lR[i], lp[i], pa)

    if debug:  # post-BwdPass: accumulated Riccati quantities
        dbg["H_bwd"] = list(H_list)
        dbg["p_bwd"] = list(p_list)
        dbg["Dinv"] = list(Dinv)
        dbg["r_tot"] = list(r_tot)

    # ---------------- FwdPass2 (loik-loid-optimized.hxx:91-165) -----------
    vis_new_list = [None] * N
    fis_new_list = [None] * N
    nu_new_list = [None] * N
    zero6 = jnp.zeros((6, B), dtype)
    for i in range(N):
        par = parents[i]
        v_par = vis_new_list[par] if par >= 0 else zero6
        v_par_loc = bsp.act_inv_motion(lR[i], lp[i], v_par)     # (6,B)
        k = nvs[i]
        rhs = bsp.mtv(U[i], v_par_loc) + r_tot[i]
        nui = -bsp.mv(Dinv[i], rhs)                             # (k,B)
        vi = v_par_loc + bsp.mv(S[i], nui)
        fi = bsp.mv(H_list[i], vi) + p_list[i]
        vis_new_list[i] = vi
        fis_new_list[i] = fi
        nu_new_list[i] = jnp.pad(nui, ((0, K - k), (0, 0)))
    vis_new = jnp.stack(vis_new_list)
    fis_new = jnp.stack(fis_new_list)
    nu_new = jnp.stack(nu_new_list)                             # (N,K,B)

    # ---------------- BoxProj (loik-loid-optimized.hxx:384-397) -----------
    z_new = jnp.clip(nu_new + st.w / mu_ineq, prob.lb, prob.ub)

    # ---------------- DualUpdate (loik-loid-optimized.hxx:404-461) --------
    Av_minus_b = jnp.stack(
        [bsp.mv(prob.A[k], vis_new[c]) - prob.b[k] for k, c in enumerate(c_links)]
    )  # (NC,6,B)
    delta_yis = mu_eq * Av_minus_b
    yis_new = st.yis + delta_yis
    Aty_new = bsp.mtv(prob.A, yis_new)
    delta_w = mu_ineq * (nu_new - z_new)
    w_new = st.w + delta_w

    if not compute_checks:  # skipped iteration of check_interval > 1
        return dict(vis=vis_new, fis=fis_new, nu=nu_new, z=z_new,
                    w=w_new, yis=yis_new, Aty=Aty_new), None

    delta_fis = fis_new - st.fis
    delta_vis_inf = bsp.inf_norm_b(vis_new - st.vis)
    delta_nu_inf = bsp.inf_norm_b(nu_new - st.nu)
    nu_inf = bsp.inf_norm_b(nu_new)
    delta_z_inf = bsp.inf_norm_b(z_new - st.z)
    Av_inf = jnp.max(
        jnp.stack([bsp.inf_norm_b(bsp.mv(prob.A[k], vis_new[c]))
                   for k, c in enumerate(c_links)]),
        axis=0,
    )
    bT_dy_plus = jnp.sum(prob.b * jnp.maximum(delta_yis, zero), axis=(0, 1))
    bT_dy_minus = jnp.sum(prob.b * jnp.minimum(delta_yis, zero), axis=(0, 1))
    ubT_dw_plus = jnp.sum(prob.ub * jnp.maximum(delta_w, zero), axis=(0, 1))
    lbT_dw_minus = jnp.sum(prob.lb * jnp.minimum(delta_w, zero), axis=(0, 1))

    # ---------------- primal residual ------------------------------------
    pr_slack = nu_new - z_new
    primal_residual_task = bsp.inf_norm_b(Av_minus_b)
    primal_residual_slack = bsp.inf_norm_b(pr_slack)
    primal_residual = jnp.maximum(primal_residual_task, primal_residual_slack)

    # ---------------- dual residual: BwdPass2 recursion -------------------
    # fdpa[i] = (A^T y)_i - f_i + sum_children X* f_child ; stfw = S^T f + w
    # (loik-loid-optimized.hxx:173-243 + DualUpdate seeding :435-439)
    fdpa_list = [jnp.zeros((6, B), dtype) for _ in range(N)]
    for k, c in enumerate(c_links):
        fdpa_list[c] = Aty_new[k]
    for i in reversed(range(N)):
        fdpa_list[i] = fdpa_list[i] - fis_new[i]
        par = parents[i]
        if par >= 0:
            fdpa_list[par] = fdpa_list[par] + bsp.act_force(lR[i], lp[i], fis_new[i])
    fdpa_new = jnp.stack(fdpa_list)
    stfw_new_list = []
    for i in range(N):
        k = nvs[i]
        stf = bsp.mtv(S[i], fis_new[i]) + w_new[i, :k]
        if prob.r_offset is not None:
            stf = stf + prob.r_offset[i, :k]
        stfw_new_list.append(jnp.pad(stf, ((0, K - k), (0, 0))))
    stfw_new = jnp.stack(stfw_new_list)

    Href_v = bsp.mv(prob.H_ref, vis_new)                        # (N,6,B)
    dr_v = Href_v - prob.Hv + fdpa_new
    dual_residual_v = bsp.inf_norm_b(dr_v)
    dual_residual_nu = bsp.inf_norm_b(stfw_new)
    dual_residual = jnp.maximum(dual_residual_v, dual_residual_nu)

    # ---------------- adaptive tolerances (loik-loid-optimized.hxx:540-565)
    scale_primal = jnp.maximum(jnp.maximum(Av_inf, nu_inf), prob.b_inf)
    scale_dual = jnp.maximum(
        jnp.maximum(bsp.inf_norm_b(Href_v), prob.Hv_inf),
        jnp.maximum(bsp.inf_norm_b(fdpa_new), bsp.inf_norm_b(stfw_new)),
    )
    if prob.tol_scale_primal is not None:
        # delta-form refinement: certify against the ORIGINAL problem's
        # scales (delta magnitudes are ~0; see PreparedProblem)
        scale_primal = jnp.maximum(scale_primal, prob.tol_scale_primal)
        scale_dual = jnp.maximum(scale_dual, prob.tol_scale_dual)
    tol_primal = tol_abs + tol_rel * scale_primal
    tol_dual = tol_abs + tol_rel * scale_dual

    # ---------------- infeasibility certificate pieces --------------------
    # (loik-loid-optimized.hxx:572-606)
    delta_y_inf = jnp.maximum(
        bsp.inf_norm_b(delta_fis),
        jnp.maximum(bsp.inf_norm_b(delta_yis), bsp.inf_norm_b(delta_w)),
    )
    At_dy_inf = jnp.maximum(
        bsp.inf_norm_b(fdpa_new - st.fdpa), bsp.inf_norm_b(stfw_new - st.stfw)
    )
    pinf_cond1 = At_dy_inf <= tol_primal_inf * delta_y_inf
    pinf_cond2 = (
        bT_dy_plus + ubT_dw_plus + bT_dy_minus + lbT_dw_minus
    ) <= tol_primal_inf * delta_y_inf
    primal_infeasible_now = pinf_cond1 & pinf_cond2

    delta_x_inf = jnp.maximum(delta_vis_inf, delta_nu_inf)

    new = dict(
        vis=vis_new, fis=fis_new, nu=nu_new, z=z_new, w=w_new,
        yis=yis_new, Aty=Aty_new, fdpa=fdpa_new, stfw=stfw_new,
        primal_residual=primal_residual, dual_residual=dual_residual,
        delta_x_inf=delta_x_inf, delta_z_inf=delta_z_inf,
    )
    checks = dict(
        tol_primal=tol_primal, tol_dual=tol_dual,
        primal_infeasible_now=primal_infeasible_now,
        # per-block residual components (LoikSolverInfo parity,
        # loik-loid.hpp:98-104); consumed by the logging block, DCE'd
        # otherwise.  primal_residual_kinematics is identically zero here by
        # construction (v is built from the recursion), hence not logged.
        primal_residual_task=primal_residual_task,
        primal_residual_slack=primal_residual_slack,
        dual_residual_v=dual_residual_v,
        dual_residual_nu=dual_residual_nu,
    )
    if debug:
        dbg.update(
            delta_yis=delta_yis, delta_w=delta_w, Av_minus_b=Av_minus_b,
            primal_residual_task=primal_residual_task,
            primal_residual_slack=primal_residual_slack,
            dual_residual_v=dual_residual_v,
            dual_residual_nu=dual_residual_nu,
            dr_v=dr_v,
            pinf_cond1=pinf_cond1, pinf_cond2=pinf_cond2,
            delta_y_inf=delta_y_inf, At_dy_inf=At_dy_inf,
        )
        checks["debug"] = dbg
    return new, checks


def kkt_residual(tree, prob: PreparedProblem, st: SolverState):
    """Dual-side KKT residual d0 = P x + q + A' y at the state's point,
    per-block: ``(d0_v (N,6,B), d0_nu (N,K,B))`` — the authoritative dense
    dual-residual semantics (loik-loid.hxx:280) evaluated via the recursive
    fdpa/stfw identities (loik-loid-optimized.hxx:173-243).  Run in f64 on a
    cast state, this is the one-shot linear term of the delta-duals
    refinement (the O(1)-magnitude cancellations happen HERE, outside the
    f32 loop)."""
    N, K = tree.njoints, tree.nv_max
    dtype = st.vis.dtype
    B = st.vis.shape[-1]

    def _S(i):
        if prob.S_list is not None:
            return prob.S_list[i]
        if prob.S_all is not None:
            return prob.S_all[i][:, : tree.nvs[i]]
        Si = tree.joint_S(i).astype(dtype)
        if Si.ndim == 3:
            return jnp.moveaxis(Si, 0, -1)
        return jnp.broadcast_to(Si[:, :, None], (6, tree.nvs[i], B))

    fdpa_list = [jnp.zeros((6, B), dtype) for _ in range(N)]
    for k, c in enumerate(prob.constraint_links):
        fdpa_list[c] = st.Aty[k]
    for i in reversed(range(N)):
        fdpa_list[i] = fdpa_list[i] - st.fis[i]
        par = tree.parents[i]
        if par >= 0:
            fdpa_list[par] = fdpa_list[par] + bsp.act_force(
                st.liMi_R[i], st.liMi_p[i], st.fis[i]
            )
    fdpa = jnp.stack(fdpa_list)
    d0_v = bsp.mv(prob.H_ref, st.vis) - prob.Hv + fdpa

    stfw_list = []
    for i in range(N):
        k = tree.nvs[i]
        stf = bsp.mtv(_S(i), st.fis[i]) + st.w[i, :k]
        stfw_list.append(jnp.pad(stf, ((0, K - k), (0, 0))))
    d0_nu = jnp.stack(stfw_list)
    return d0_v, d0_nu, fdpa


# --------------------------------------------------------------------------- #
# masked while-loop driver
# --------------------------------------------------------------------------- #


def _masked_merge(mask, new, old):
    """Per-problem freeze: trailing-batch layout makes (B,) masks broadcast."""
    return jnp.where(mask, new, old)


def loop_cond(st: SolverState):
    """Masked-termination condition: any problem still running."""
    return jnp.any(st.running)


def make_loop_body(tree, prob: PreparedProblem, params: SolverParams):
    """One ADMM iteration + flag/penalty transitions as a pure
    SolverState -> SolverState function.  Every solver loop runs THIS body:
    the masked `lax.while_loop` of `_solve_loop` and the fixed-length
    `lax.scan` of `diff.solve_unrolled`."""

    max_iter = params.max_iter
    K = params.check_interval

    def body(st: SolverState) -> SolverState:
        dtype = st.mu.dtype
        ten = jnp.asarray(10.0, dtype)
        tenth = jnp.asarray(0.1, dtype)
        tol_tail = jnp.asarray(params.tol_tail_solve, dtype)
        eq_scale = jnp.asarray(params.mu_equality_scale_factor, dtype)
        i = st.it + K
        active = st.running                      # (B,)
        # check_interval > 1: K-1 check-free ADMM iterations (trace-time
        # unrolled), then one full iteration with residuals/flags.  Frozen
        # problems advance through the micro-iterations too but are restored
        # wholesale by the single masked merge below (the mask is constant
        # within the body, so merging once at the end equals merging every
        # micro-step).
        cur = st
        if K > 1:
            # hoist the Riccati matrix half: (mu_eq, mu_ineq, liMi) are
            # constant across the K micro-iterations, so S and the H-sweep
            # (the FMA-heavy congruences) are computed once per body call
            # and shared — bit-identical values, and the dedup no longer
            # depends on the compiler's CSE
            S_h = _S_lists(tree, prob, st.vis.shape[-1], st.vis.dtype)
            hc = (S_h, _h_sweep(tree, prob, params, st, S_h))
        else:
            hc = None
        for _ in range(K - 1):
            partial, _ = _iteration(tree, prob, params, cur,
                                    compute_checks=False, h_cache=hc)
            cur = dataclasses.replace(cur, **partial)
        new, checks = _iteration(tree, prob, params, cur, h_cache=hc)

        # --- flag transitions -------------------------------------------
        # normal-mode problems: convergence first, then feasibility (iter>1),
        # then mu update (loik-loid-optimized.hpp:417-452)
        normal = active & ~st.in_tail
        conv_now = (
            normal
            & (new["primal_residual"] < checks["tol_primal"])
            & (new["dual_residual"] < checks["tol_dual"])
        )
        if params.check_feasibility:
            pinf_now = normal & ~conv_now & (i > 1) & checks["primal_infeasible_now"]
        else:
            pinf_now = jnp.zeros_like(normal)
        if params.tail_solve:
            in_tail_next = st.in_tail | pinf_now
        else:
            # freeze certified-infeasible problems at detection instead of
            # running the closest-feasible tail (params.tail_solve doc)
            in_tail_next = st.in_tail

        # tail-mode termination: iterates stopped moving
        # (while-condition of InfeasibilityTailSolve)
        tail_done = (
            active
            & in_tail_next
            & (new["delta_x_inf"] < tol_tail)
            & (new["delta_z_inf"] < tol_tail)
        )

        # mu update only for problems continuing in normal mode
        do_mu = normal & ~conv_now & ~pinf_now
        rp, rd = new["primal_residual"], new["dual_residual"]
        mu_next = jnp.where(
            rp > ten * rd, st.mu * ten, jnp.where(rd > ten * rp, st.mu * tenth, st.mu)
        )
        # clamp: repeated x0.1 under a residual floor underflows f32 to zero
        # (then w / mu_ineq = inf); the reference never hits this in double
        mu_next = jnp.clip(
            mu_next,
            jnp.asarray(1e-12, mu_next.dtype),
            jnp.asarray(1e12, mu_next.dtype),
        )
        mu_next = jnp.where(do_mu, mu_next, st.mu)
        mu_eq_next = jnp.where(do_mu, eq_scale * mu_next, st.mu_eq)
        mu_ineq_next = jnp.where(do_mu, mu_next, st.mu_ineq)

        # iteration budget: main loop runs i <= max_iter-1; tail runs i <= max_iter
        budget_next = (in_tail_next & (i + K <= max_iter)) | (
            ~in_tail_next & (i + K <= max_iter - 1)
        )
        running_next = active & ~conv_now & ~tail_done & budget_next
        if not params.tail_solve:
            running_next = running_next & ~pinf_now

        # --- merge (freeze finished problems) ---------------------------
        merged = {k: _masked_merge(active, v, getattr(st, k)) for k, v in new.items()}
        updates = dict(
            merged,
            mu=mu_next,
            mu_eq=mu_eq_next,
            mu_ineq=mu_ineq_next,
            converged=st.converged | conv_now,
            primal_infeasible=st.primal_infeasible | pinf_now,
            in_tail=in_tail_next,
            running=running_next,
            iterations=jnp.where(active, i, st.iterations),
            # tail iterations count only the passes AFTER detection
            # (InfeasibilityTailSolve increments inside its while loop)
            tail_iterations=jnp.where(
                active & st.in_tail, st.tail_iterations + K, st.tail_iterations
            ),
            it=i,
        )
        if params.logging:
            nan = jnp.nan

            def logset(arr, val):
                return arr.at[i - 1].set(jnp.where(active, val, nan))

            updates["log_rp"] = logset(st.log_rp, new["primal_residual"])
            updates["log_rd"] = logset(st.log_rd, new["dual_residual"])
            updates["log_mu"] = logset(st.log_mu, st.mu)
            # per-block components + penalty split + tail diagnostics
            # (LoikSolverInfo parity, loik-loid.hpp:98-121; the reference's
            # tail_solve_*_list_ vectors are these same logs masked by
            # log_in_tail)
            updates["log_rp_task"] = logset(st.log_rp_task,
                                            checks["primal_residual_task"])
            updates["log_rp_slack"] = logset(st.log_rp_slack,
                                             checks["primal_residual_slack"])
            updates["log_rd_v"] = logset(st.log_rd_v, checks["dual_residual_v"])
            updates["log_rd_nu"] = logset(st.log_rd_nu,
                                          checks["dual_residual_nu"])
            updates["log_mu_eq"] = logset(st.log_mu_eq, st.mu_eq)
            updates["log_mu_ineq"] = logset(st.log_mu_ineq, st.mu_ineq)
            updates["log_in_tail"] = logset(
                st.log_in_tail, st.in_tail.astype(st.mu.dtype)
            )
            updates["log_dx"] = logset(st.log_dx, new["delta_x_inf"])
            updates["log_dz"] = logset(st.log_dz, new["delta_z_inf"])
        if params.verbose:
            # iteration banner (the reference's verbose_ stream prints one
            # per iteration, loik-loid.hpp:501-506; batched -> aggregates).
            # Worst residual over still-active problems; frozen ones excluded.
            zero = jnp.asarray(0.0, dtype)
            jax.debug.print(
                "[loik] iter {i}: primal res {rp:.3e}, dual res {rd:.3e}, "
                "running {n}",
                i=i,
                rp=jnp.max(jnp.where(active, new["primal_residual"], zero)),
                rd=jnp.max(jnp.where(active, new["dual_residual"], zero)),
                n=jnp.sum(running_next.astype(jnp.int32)),
            )
        return dataclasses.replace(st, **updates)

    return body


def _solve_loop(tree, prob: PreparedProblem, params: SolverParams, st: SolverState):
    """Run the ADMM main loop + per-problem infeasibility tail solves with
    masked termination (Solve, loik-loid-optimized.hpp:368-455 +
    InfeasibilityTailSolve :266-319) — one `lax.while_loop` over the shared
    `make_loop_body`."""
    body = make_loop_body(tree, prob, params)
    return jax.lax.while_loop(loop_cond, body, st)


# --------------------------------------------------------------------------- #
# public API
# --------------------------------------------------------------------------- #


def _reset_state(tree, params: SolverParams, st: SolverState, dtype) -> SolverState:
    """ResetSolver + conditional warm-start wipe
    (loik-loid-optimized.hpp:168-186, loik-loid-data-optimized.hxx:114-127)."""
    B = st.mu.shape[0]
    if params.warm_start and params.keep_mu_on_warm_start:
        mu0 = st.mu.astype(dtype)
    else:
        mu0 = jnp.full((B,), params.mu, dtype)
    if params.warm_start and params.freeze_infeasible_on_warm_start:
        keep_pinf = st.primal_infeasible
        running0 = ~st.primal_infeasible
    else:
        keep_pinf = jnp.zeros((B,), bool)
        running0 = jnp.ones((B,), bool)
    upd = dict(
        mu=mu0,
        mu_eq=params.mu_equality_scale_factor * mu0,
        mu_ineq=mu0,
        iterations=jnp.zeros((B,), jnp.int32),
        tail_iterations=jnp.zeros((B,), jnp.int32),
        converged=jnp.zeros((B,), bool),
        primal_infeasible=keep_pinf,
        dual_infeasible=jnp.zeros((B,), bool),
        in_tail=jnp.zeros((B,), bool),
        running=running0,
        primal_residual=jnp.full((B,), jnp.inf, dtype),
        dual_residual=jnp.full((B,), jnp.inf, dtype),
        delta_x_inf=jnp.zeros((B,), dtype),
        delta_z_inf=jnp.zeros((B,), dtype),
        it=jnp.zeros((), jnp.int32),
    )
    if not params.warm_start:
        upd.update(
            vis=jnp.zeros_like(st.vis),
            fis=jnp.zeros_like(st.fis),
            nu=jnp.zeros_like(st.nu),
            z=jnp.zeros_like(st.z),
            w=jnp.zeros_like(st.w),
            yis=jnp.zeros_like(st.yis),
            Aty=jnp.zeros_like(st.Aty),
            fdpa=jnp.zeros_like(st.fdpa),
            stfw=jnp.zeros_like(st.stfw),
        )
    if params.logging:
        from .state import LOG_FIELDS

        upd.update({
            name: jnp.full((params.max_iter, B), jnp.nan, dtype)
            for name in LOG_FIELDS
        })
    return dataclasses.replace(st, **upd)


def _flat_nu(tree, padded):
    """(N,K,B) padded dof array -> (B, nv) flat joint velocities."""
    N, K = padded.shape[0], padded.shape[1]
    flat = padded.reshape(N * K, -1)
    idx = jnp.asarray(tree.padded_to_flat)
    return jnp.moveaxis(flat[idx], -1, 0)


def _solve_impl(tree, params: SolverParams, q, problem: IkProblem,
                warm_state: Optional[SolverState], liMi=None,
                tol_scales=None):
    # Full f32 for every dot on the path (FK included): a reduced-precision
    # product (TF32 on GPUs keeps ~3 digits) would stall the ADMM recursion
    # far above tolerance.
    with jax.default_matmul_precision("highest"):
        return _solve_impl_inner(tree, params, q, problem, warm_state, liMi,
                                 tol_scales)


def _solve_impl_inner(tree, params: SolverParams, q, problem: IkProblem,
                      warm_state: Optional[SolverState], liMi=None,
                      tol_scales=None):
    if liMi is None:
        dtype = q.dtype
        B = q.shape[0]
        liMi_R, liMi_p = fwd_pass_init(tree, q)
    else:
        # FK frozen by the caller (SolveInit/Solve split: the reference's
        # split exists to avoid recomputing FK per re-solve,
        # loik-loid-optimized.hpp:335-361)
        liMi_R, liMi_p = liMi
        dtype = liMi_R.dtype
        B = liMi_R.shape[-1]
    prob = prepare_problem(tree, problem, B, dtype)
    if tree.has_q_dependent_S:
        if q is None:
            raise ValueError(
                "trees with configuration-dependent motion subspaces "
                "(universal joints) need q: the SolveInit/Solve FK-frozen "
                "split cannot reconstruct S from liMi — use solve()"
            )
        # compute the per-problem subspaces once (iteration-constant data,
        # like liMi): exact-size (6, nv_i, B) per joint
        S_list = []
        for i in range(tree.njoints):
            Si = tree.joint_S(i, q).astype(dtype)
            if Si.ndim == 2:  # constant joint: share across the batch
                Si = jnp.broadcast_to(Si[:, :, None], Si.shape + (B,))
            else:             # (B, 6, k) -> (6, k, B)
                Si = jnp.moveaxis(Si, 0, -1)
            S_list.append(Si)
        prob = dataclasses.replace(prob, S_list=tuple(S_list))
    if tol_scales is not None:
        prob = dataclasses.replace(
            prob,
            tol_scale_primal=jnp.asarray(tol_scales[0], dtype),
            tol_scale_dual=jnp.asarray(tol_scales[1], dtype),
        )
    if warm_state is None:
        st = init_state(tree, B, problem.num_constraints, dtype,
                        params.max_iter, params.logging)
    else:
        st = warm_state
    st = _reset_state(tree, params, st, dtype)
    st = dataclasses.replace(st, liMi_R=liMi_R, liMi_p=liMi_p)
    st = _solve_loop(tree, prob, params, st)

    if params.verbose:
        # terminal notices (verbose_ convergence message + warnings,
        # loik-loid.hxx:320 converged / :345 infeasible / :362 max-iter)
        n_conv = jnp.sum(st.converged.astype(jnp.int32))
        n_pinf = jnp.sum(st.primal_infeasible.astype(jnp.int32))
        n_unconv = jnp.sum(
            (~st.converged & ~st.primal_infeasible).astype(jnp.int32)
        )
        jax.debug.print(
            "[loik] solve finished: {c} converged, max iterations {mi}",
            c=n_conv, mi=jnp.max(st.iterations),
        )
        jax.lax.cond(
            n_pinf > 0,
            lambda n: jax.debug.print(
                "[loik] WARNING: {n} problem(s) certified primal infeasible",
                n=n),
            lambda n: None, n_pinf,
        )
        jax.lax.cond(
            n_unconv > 0,
            lambda n: jax.debug.print(
                "[loik] WARNING: {n} problem(s) hit max_iter without "
                "converging", n=n),
            lambda n: None, n_unconv,
        )

    vis_out = jnp.moveaxis(st.vis, -1, 0)  # (B,N,6)
    return SolveResult(
        nu=_flat_nu(tree, st.nu),
        z=_flat_nu(tree, st.z),
        vis=vis_out,
        converged=st.converged,
        primal_infeasible=st.primal_infeasible,
        dual_infeasible=st.dual_infeasible,
        iterations=st.iterations,
        tail_iterations=st.tail_iterations,
        primal_residual=st.primal_residual,
        dual_residual=st.dual_residual,
        state=st,
        **{name: getattr(st, name) for name in
           ("log_rp", "log_rd", "log_mu", "log_rp_task", "log_rp_slack",
            "log_rd_v", "log_rd_nu", "log_mu_eq", "log_mu_ineq",
            "log_in_tail", "log_dx", "log_dz")},
    )


# tree and problem are pytrees whose static topology lives in their treedefs
# (KinematicTree aux data / constraint_links) — jit re-specializes per
# topology while placements and constraint values stay traced.
@functools.partial(jax.jit, static_argnums=(1,))
def _solve_jit(tree, params, q, problem, warm_state):
    return _solve_impl(tree, params, q, problem, warm_state)


@functools.partial(jax.jit, static_argnums=(1,))
def _solve_fk_jit(tree, params, liMi_R, liMi_p, problem, warm_state):
    return _solve_impl(tree, params, None, problem, warm_state,
                       liMi=(liMi_R, liMi_p))


@jax.jit
def fwd_pass_init_jit(tree, q):
    """Jitted FK in the solver's trailing-batch layout; the SolveInit half of
    the split-solve protocol (loik-loid-optimized.hpp:335-361)."""
    return fwd_pass_init(tree, q)


def solve_from_fk(tree, params: SolverParams, liMi_R, liMi_p,
                  problem: IkProblem,
                  warm_state: Optional[SolverState] = None) -> SolveResult:
    """Solve with FK frozen: takes (liMi_R, liMi_p) from `fwd_pass_init_jit`
    instead of q, so repeated re-solves never redo the FK sweep — the
    `SolveInit()` + `Solve()` split of the reference
    (loik-loid-optimized.hpp:335-361)."""
    return _solve_fk_jit(tree, params, liMi_R, liMi_p, problem, warm_state)


def solve(tree, params: SolverParams, q, problem: IkProblem,
          warm_state: Optional[SolverState] = None) -> SolveResult:
    """Solve a batch of constrained differential-IK problems.

    Args:
      tree: KinematicTree (static topology -> one compilation per topology).
      params: SolverParams (static).
      q: (B, nq) or (nq,) joint configurations.
      problem: IkProblem; leaves either unbatched (shared) or leading-batch.
      warm_state: previous SolverState to warm start from (the analog of
        `Reset(warm_start=true)` keeping primal/dual variables across ticks;
        pass `params.replace(warm_start=True)` for reference-exact behavior).

    Returns a SolveResult with leading-batch arrays.
    """
    from ..problem import validate_problem

    validate_problem(tree, problem)
    q = jnp.asarray(q)
    if q.ndim == 1:
        q = q[None]  # results stay batched (callers index [0])
    if q.shape[-1] != tree.nq:
        raise ValueError(
            f"q has {q.shape[-1]} configuration entries; model '{tree.name}' "
            f"has nq={tree.nq}"
        )
    res = _solve_jit(tree, params, q, problem, warm_state)
    return res
