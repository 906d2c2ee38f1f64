"""Oracle solver: the semantic specification of the LOIK ADMM scheme.

A readable, single-problem, float64 NumPy implementation of the mathematics
of `FirstOrderLoikTpl` (loik-loid.hpp:19-661 / loik-loid.hxx), including the
dense OSQP-form QP mirror (`IkProblemStandardQPFormulation`,
ik-id-description.hpp:342-565) whose matrices define the *authoritative*
residual/convergence/feasibility semantics (the reference's recursive dual
residual is overwritten by the dense formula at loik-loid.hxx:280 — the dense
formula is the spec).

Deliberately NOT jitted, NOT batched, NOT fast: it exists so the production
batched solver (loik_tpu.solver) can be validated pass-by-pass against an
obviously-correct program, mirroring how the reference's test suite uses
`FirstOrderLoikTpl` as ground truth for `FirstOrderLoikOptimizedTpl`
(tests/loik-loid.cpp:305-671).

Index conventions: moving joints are 0-based (reference joint `idx` maps to
`idx - 1` here; the universe is dropped).  nb == njoints (every moving joint
has exactly one body).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..params import SolverParams
from ..problem import IkProblem


def _np(x):
    return np.asarray(x, dtype=np.float64)


def _inf_norm(x):
    return float(np.max(np.abs(x))) if np.size(x) else 0.0


@dataclasses.dataclass
class OracleInfo:
    """Per-iteration logs (LoikSolverInfo, loik-loid.hpp:40-121), incl. the
    per-block residual components and penalty split; tail-solve iterations
    are flagged via in_tail (the reference's separate tail_solve_*_list_
    vectors are these logs filtered by that flag)."""

    iters: List[int] = dataclasses.field(default_factory=list)
    primal_residuals: List[float] = dataclasses.field(default_factory=list)
    dual_residuals: List[float] = dataclasses.field(default_factory=list)
    mus: List[float] = dataclasses.field(default_factory=list)
    tail_solve_iters: List[int] = dataclasses.field(default_factory=list)
    primal_residuals_task: List[float] = dataclasses.field(default_factory=list)
    primal_residuals_slack: List[float] = dataclasses.field(default_factory=list)
    dual_residuals_v: List[float] = dataclasses.field(default_factory=list)
    dual_residuals_nu: List[float] = dataclasses.field(default_factory=list)
    mu_eqs: List[float] = dataclasses.field(default_factory=list)
    mu_ineqs: List[float] = dataclasses.field(default_factory=list)
    in_tail: List[bool] = dataclasses.field(default_factory=list)
    delta_x_infs: List[float] = dataclasses.field(default_factory=list)
    delta_z_infs: List[float] = dataclasses.field(default_factory=list)


class OracleSolver:
    """Single-problem dense reference solver (FirstOrderLoikTpl)."""

    def __init__(self, tree, params: SolverParams, verbose: bool = False):
        self.tree = tree
        self.params = params
        self.verbose = verbose
        self.N = tree.njoints
        self.nv = tree.nv
        self.parents = tree.parents
        self.idx_v = tree.idx_v
        self.nvs = tree.nvs
        # exact-size motion subspaces (6, nv_i); constant per joint type
        # except universal joints, whose S is recomputed from q at
        # fwd_pass_init time (configuration-dependent subspace)
        if tree.has_q_dependent_S:
            self.S = [np.zeros((6, k)) for k in self.nvs]  # until FK runs
        else:
            self.S = [_np(tree.joint_S(i)) for i in range(self.N)]
        self.qp_var_dim = 6 * self.N + self.nv
        self.qp_con_dim = 6 * self.N + 6 * self.N + self.nv
        self.reset_state()

    # ------------------------------------------------------------------ #
    # state management (IkIdDataTpl Reset semantics, loik-loid-data.hxx)
    # ------------------------------------------------------------------ #
    def reset_state(self):
        N, nv = self.N, self.nv
        self.liMi_R = np.tile(np.eye(3), (N, 1, 1))
        self.liMi_p = np.zeros((N, 3))
        self.oMi_R = np.tile(np.eye(3), (N, 1, 1))
        self.oMi_p = np.zeros((N, 3))
        self.His = np.zeros((N, 6, 6))
        self.pis = np.zeros((N, 6))
        self.Dinv = [np.zeros((k, k)) for k in self.nvs]
        self.ris = [np.zeros((k,)) for k in self.nvs]
        self.Ris = [np.zeros((k, k)) for k in self.nvs]
        self.vis = np.zeros((N, 6))
        self.vis_prev = np.zeros((N, 6))
        self.fis = np.zeros((N, 6))
        self.yis = np.zeros((N, 6))  # keyed by joint; nonzero only at constraints
        self.nu = np.zeros(nv)
        self.nu_prev = np.zeros(nv)
        self.z = np.zeros(nv)
        self.z_prev = np.zeros(nv)
        self.w = np.zeros(nv)
        # dense QP mirror
        self.A_qp = np.zeros((self.qp_con_dim, self.qp_var_dim))
        self.P_qp = np.zeros((self.qp_var_dim, self.qp_var_dim))
        self.q_qp = np.zeros(self.qp_var_dim)
        self.x_qp = np.zeros(self.qp_var_dim)
        self.y_qp = np.zeros(self.qp_con_dim)
        self.z_qp = np.zeros(self.qp_con_dim)
        self.lb_qp = np.zeros(self.qp_con_dim)
        self.ub_qp = np.zeros(self.qp_con_dim)
        self.x_qp_prev = np.zeros(self.qp_var_dim)
        self.y_qp_prev = np.zeros(self.qp_con_dim)
        self.z_qp_prev = np.zeros(self.qp_con_dim)
        self.delta_x_qp = np.zeros(self.qp_var_dim)
        self.delta_y_qp = np.zeros(self.qp_con_dim)
        self.delta_z_qp = np.zeros(self.qp_con_dim)
        self.primal_residual_vec = np.zeros(6 * self.N + nv)
        self.dual_residual_vec = np.zeros(6 * self.N + nv)

    def reset_solver(self):
        """ResetSolver (loik-loid.hpp:154-183) + Base::Reset."""
        p = self.params
        self.iter = 0
        self.tail_solve_iter = 0
        self.converged = False
        self.primal_infeasible = False
        self.dual_infeasible = False
        self.mu = p.mu
        self.mu_eq = p.mu_equality_scale_factor * self.mu
        self.mu_ineq = self.mu
        self.primal_residual = np.inf
        self.dual_residual = np.inf
        self.tol_primal = 0.0
        self.tol_dual = 0.0
        if not p.warm_start:
            # IkIdData::Reset(warm_start=False) wipes primal/dual variables
            nv = self.nv
            self.nu = np.zeros(nv)
            self.nu_prev = np.zeros(nv)
            self.z = np.zeros(nv)
            self.z_prev = np.zeros(nv)
            self.w = np.zeros(nv)
            self.vis = np.zeros((self.N, 6))
            self.vis_prev = np.zeros((self.N, 6))
            self.fis = np.zeros((self.N, 6))
            self.yis = np.zeros((self.N, 6))
        self.primal_residual_vec = np.zeros(6 * self.N + self.nv)
        self.dual_residual_vec = np.zeros(6 * self.N + self.nv)
        self.info = OracleInfo()

    def update_prev(self):
        """IkIdData::UpdatePrev (loik-loid-data.hxx:212-221)."""
        self.vis_prev = self.vis.copy()
        self.nu_prev = self.nu.copy()
        self.z_prev = self.z.copy()

    # ------------------------------------------------------------------ #
    # kinematics + QP construction (SolveInit phase)
    # ------------------------------------------------------------------ #
    def fwd_pass_init(self, q):
        """FK sweep (FwdPassInit, loik-loid.hxx:16-33)."""
        from .. import spatial
        import jax.numpy as jnp

        q = jnp.asarray(_np(q))
        lR, lp, oR, op = self.tree.fwd_kinematics(q)
        self.liMi_R, self.liMi_p = _np(lR), _np(lp)
        self.oMi_R, self.oMi_p = _np(oR), _np(op)
        if self.tree.has_q_dependent_S:
            self.S = [_np(self.tree.joint_S(i, q)) for i in range(self.N)]
        # child->parent transport of the Riccati recursion (BwdPass): fixed
        # by liMi, so built once per solve instead of once per iteration
        self.Xd = [None] * self.N
        self.Xa_inv = [None] * self.N
        for i in range(self.N):
            if self.parents[i] >= 0:
                self.Xd[i] = self._dual_action_matrix(self.liMi_R[i],
                                                      self.liMi_p[i])
                self.Xa_inv[i] = self._action_matrix(
                    *self._se3_inv(self.liMi_R[i], self.liMi_p[i]))

    def _action_matrix(self, R, p):
        from .. import spatial
        import jax.numpy as jnp

        return _np(spatial.se3_action_matrix(jnp.asarray(R), jnp.asarray(p)))

    def _dual_action_matrix(self, R, p):
        from .. import spatial
        import jax.numpy as jnp

        return _np(spatial.se3_dual_action_matrix(jnp.asarray(R), jnp.asarray(p)))

    def update_qp_init(self, problem: IkProblem):
        """UpdateQPADMMSolveInit (ik-id-description.hpp:411-491).

        x = [v_0..v_{N-1}; nu],  constraint rows = [kinematics(6N);
        task(6N, nonzero only at constrained links); box(nv)].
        """
        N, nv = self.N, self.nv
        H_refs = _np(problem.H_ref)
        v_refs = _np(problem.v_ref)
        self.H_refs, self.v_refs = H_refs, v_refs
        self.c_links = list(problem.constraint_links)
        self.Ais = _np(problem.A)
        self.bis = _np(problem.b)
        self.lb = _np(problem.lb)
        self.ub = _np(problem.ub)

        A = np.zeros((self.qp_con_dim, self.qp_var_dim))
        A[: 6 * N, : 6 * N] = -np.eye(6 * N)
        A[12 * N :, 6 * N :] = np.eye(nv)
        P = np.zeros((self.qp_var_dim, self.qp_var_dim))
        qv = np.zeros(self.qp_var_dim)
        for i in range(N):
            P[6 * i : 6 * i + 6, 6 * i : 6 * i + 6] = H_refs[i]
            qv[6 * i : 6 * i + 6] = -H_refs[i].T @ v_refs[i]
            # S_i block into the joint-velocity columns
            A[6 * i : 6 * i + 6, 6 * N + self.idx_v[i] : 6 * N + self.idx_v[i] + self.nvs[i]] = (
                self.S[i]
            )
            par = self.parents[i]
            if par >= 0:
                # iMo * oMp = liMi^-1 as a motion action matrix
                iMp_R = self.liMi_R[i].T
                iMp_p = -self.liMi_R[i].T @ self.liMi_p[i]
                A[6 * i : 6 * i + 6, 6 * par : 6 * par + 6] = self._action_matrix(iMp_R, iMp_p)
        lb_qp = np.zeros(self.qp_con_dim)
        ub_qp = np.zeros(self.qp_con_dim)
        for k, c in enumerate(self.c_links):
            A[6 * N + 6 * c : 6 * N + 6 * c + 6, 6 * c : 6 * c + 6] = self.Ais[k]
            lb_qp[6 * N + 6 * c : 6 * N + 6 * c + 6] = self.bis[k]
            ub_qp[6 * N + 6 * c : 6 * N + 6 * c + 6] = self.bis[k]
        lb_qp[12 * N :] = self.lb
        ub_qp[12 * N :] = self.ub
        self.A_qp, self.P_qp, self.q_qp = A, P, qv
        self.lb_qp, self.ub_qp = lb_qp, ub_qp
        self.z_qp[6 * N : 12 * N] = ub_qp[6 * N : 12 * N]

    def update_qp_loop(self):
        """UpdateQPADMMSolveLoop (ik-id-description.hpp:499-539)."""
        N, nv = self.N, self.nv
        self.x_qp_prev = self.x_qp.copy()
        self.y_qp_prev = self.y_qp.copy()
        self.z_qp_prev = self.z_qp.copy()
        self.x_qp = np.concatenate([self.vis.reshape(-1), self.nu])
        self.y_qp = np.concatenate([self.fis.reshape(-1), self.yis.reshape(-1), self.w])
        self.z_qp[12 * N :] = self.z
        self.delta_x_qp = self.x_qp - self.x_qp_prev
        self.delta_y_qp = self.y_qp - self.y_qp_prev
        self.delta_z_qp = self.z_qp - self.z_qp_prev

    # ------------------------------------------------------------------ #
    # the five ADMM passes (loik-loid.hxx:39-189)
    # ------------------------------------------------------------------ #
    def fwd_pass1(self):
        """FwdPass1 (loik-loid.hxx:39-76)."""
        for i in range(self.N):
            k = self.nvs[i]
            iv = self.idx_v[i]
            self.Ris[i] = self.mu_ineq * np.eye(k)
            self.ris[i] = self.w[iv : iv + k] - self.mu_ineq * self.z[iv : iv + k]
            self.His[i] = self.params.rho * np.eye(6) + self.H_refs[i]
            self.pis[i] = -self.params.rho * self.vis_prev[i] - self.H_refs[i].T @ self.v_refs[i]
        for kc, c in enumerate(self.c_links):
            Ai, bi = self.Ais[kc], self.bis[kc]
            self.His[c] += self.mu_eq * Ai.T @ Ai
            self.pis[c] += Ai.T @ self.yis[c] - self.mu_eq * Ai.T @ bi

    def bwd_pass(self):
        """BwdPass: the backward Riccati sweep (loik-loid.hxx:82-113)."""
        for i in reversed(range(self.N)):
            Si = self.S[i]
            Hi = self.His[i]
            pi = self.pis[i]
            Ri, ri = self.Ris[i], self.ris[i]
            Di = Ri + Si.T @ Hi @ Si
            Di_inv = np.linalg.inv(Di)
            Pi = np.eye(6) - Hi @ Si @ Di_inv @ Si.T
            self.Dinv[i] = Di_inv
            par = self.parents[i]
            if par >= 0:
                Xd, Xa_inv = self.Xd[i], self.Xa_inv[i]
                self.His[par] += Xd @ (Pi @ Hi) @ Xa_inv
                self.pis[par] += Xd @ (Pi @ pi - Hi @ Si @ Di_inv @ ri)

    @staticmethod
    def _se3_inv(R, p):
        return R.T, -R.T @ p

    def fwd_pass2(self):
        """FwdPass2 (loik-loid.hxx:120-151)."""
        from .. import spatial
        import jax.numpy as jnp

        for i in range(self.N):
            Si = self.S[i]
            Hi = self.His[i]
            pi = self.pis[i]
            Di_inv = self.Dinv[i]
            ri = self.ris[i]
            iv, k = self.idx_v[i], self.nvs[i]
            par = self.parents[i]
            v_par = self.vis[par] if par >= 0 else np.zeros(6)
            vi_parent = _np(
                spatial.act_inv_motion(
                    jnp.asarray(self.liMi_R[i]), jnp.asarray(self.liMi_p[i]), jnp.asarray(v_par)
                )
            )
            nui = -Di_inv @ (Si.T @ (Hi @ vi_parent + pi) + ri)
            self.nu[iv : iv + k] = nui
            self.vis[i] = vi_parent + Si @ nui
            self.fis[i] = Hi @ self.vis[i] + pi

    def box_proj(self):
        """BoxProj (loik-loid.hxx:158-164)."""
        self.z = np.minimum(self.ub, np.maximum(self.lb, self.nu + self.w / self.mu_ineq))

    def dual_update(self):
        """DualUpdate (loik-loid.hxx:171-189)."""
        for kc, c in enumerate(self.c_links):
            self.yis[c] += self.mu_eq * (self.Ais[kc] @ self.vis[c] - self.bis[kc])
        self.w += self.mu_ineq * (self.nu - self.z)

    # ------------------------------------------------------------------ #
    # residuals / convergence / feasibility (dense spec)
    # ------------------------------------------------------------------ #
    def compute_residuals(self):
        """ComputeResiduals (loik-loid.hxx:206-295).

        Primal residual from the recursive quantities; dual residual from the
        authoritative dense formula r_dual = P x + q + A^T y (line 280)."""
        N, nv = self.N, self.nv
        self.primal_residual_vec = np.zeros(6 * N + nv)
        for kc, c in enumerate(self.c_links):
            self.primal_residual_vec[6 * c : 6 * c + 6] = (
                self.Ais[kc] @ self.vis[c] - self.bis[kc]
            )
        self.primal_residual_vec[6 * N :] = self.nu - self.z
        self.primal_residual = _inf_norm(self.primal_residual_vec)
        self.primal_residual_task = _inf_norm(self.primal_residual_vec[: 6 * N])
        self.primal_residual_slack = _inf_norm(self.primal_residual_vec[6 * N :])

        self.dual_residual_vec = self.P_qp @ self.x_qp + self.q_qp + self.A_qp.T @ self.y_qp
        self.dual_residual = _inf_norm(self.dual_residual_vec)
        self.dual_residual_v = _inf_norm(self.dual_residual_vec[: 6 * N])
        self.dual_residual_nu = _inf_norm(self.dual_residual_vec[6 * N :])

    def check_convergence(self):
        """CheckConvergence with OSQP adaptive tolerances (loik-loid.hxx:301-324)."""
        p = self.params
        self.tol_primal = p.tol_abs + p.tol_rel * max(
            _inf_norm(self.A_qp @ self.x_qp), _inf_norm(self.z_qp)
        )
        self.tol_dual = p.tol_abs + p.tol_rel * max(
            _inf_norm(self.P_qp @ self.x_qp),
            _inf_norm(self.A_qp.T @ self.y_qp),
            _inf_norm(self.q_qp),
        )
        if self.primal_residual < self.tol_primal and self.dual_residual < self.tol_dual:
            self.converged = True

    def check_feasibility(self):
        """CheckFeasibility: OSQP infeasibility certificates (loik-loid.hxx:330-367)."""
        p = self.params
        dy = self.delta_y_qp
        dy_inf = _inf_norm(dy)
        cond1 = _inf_norm(self.A_qp.T @ dy) <= p.tol_primal_inf * dy_inf
        cond2 = (
            self.ub_qp @ np.maximum(dy, 0) + self.lb_qp @ np.minimum(dy, 0)
        ) <= p.tol_primal_inf * dy_inf
        if cond1 and cond2:
            self.primal_infeasible = True

        dx = self.delta_x_qp
        dx_inf = _inf_norm(dx)
        d1 = _inf_norm(self.P_qp @ dx) <= p.tol_dual_inf * dx_inf
        d2 = (self.q_qp @ dx) <= p.tol_dual_inf * dx_inf
        if d1 and d2:
            Adx = self.A_qp @ dx
            if np.all(Adx >= -p.tol_dual_inf * dx_inf) and np.all(Adx <= p.tol_dual_inf * dx_inf):
                self.dual_infeasible = True

    def update_mu(self):
        """UpdateMu, DEFAULT strategy (loik-loid.hxx:374-402)."""
        if self.primal_residual > 10 * self.dual_residual:
            self.mu *= 10.0
        elif self.dual_residual > 10 * self.primal_residual:
            self.mu *= 0.1
        else:
            return
        self.mu_eq = self.params.mu_equality_scale_factor * self.mu
        self.mu_ineq = self.mu

    # ------------------------------------------------------------------ #
    # drivers
    # ------------------------------------------------------------------ #
    def _iterate_once(self):
        """One full ADMM iteration (body of Solve, loik-loid.hpp:496-580)."""
        self.update_prev()
        self.fwd_pass1()
        self.bwd_pass()
        self.fwd_pass2()
        self.box_proj()
        self.dual_update()
        self.update_qp_loop()
        self.compute_residuals()
        self.info.iters.append(self.iter)
        self.info.primal_residuals.append(self.primal_residual)
        self.info.dual_residuals.append(self.dual_residual)
        self.info.mus.append(self.mu)
        self.info.primal_residuals_task.append(self.primal_residual_task)
        self.info.primal_residuals_slack.append(self.primal_residual_slack)
        self.info.dual_residuals_v.append(self.dual_residual_v)
        self.info.dual_residuals_nu.append(self.dual_residual_nu)
        self.info.mu_eqs.append(self.mu_eq)
        self.info.mu_ineqs.append(self.mu_ineq)
        self.info.in_tail.append(self.tail_solve_iter > 0)
        self.info.delta_x_infs.append(_inf_norm(self.delta_x_qp))
        self.info.delta_z_infs.append(_inf_norm(self.delta_z_qp))

    def infeasibility_tail_solve(self):
        """InfeasibilityTailSolve (loik-loid.hpp:257-347)."""
        p = self.params
        self.tail_solve_iter = 0
        while (
            _inf_norm(self.delta_x_qp) >= p.tol_tail_solve
            or _inf_norm(self.delta_z_qp) >= p.tol_tail_solve
        ):
            if self.iter >= p.max_iter:
                return
            self.iter += 1
            self.tail_solve_iter += 1
            self.info.tail_solve_iters.append(self.tail_solve_iter)
            self._iterate_once()

    def solve_init(self, q, problem: IkProblem):
        """SolveInit (loik-loid.hpp:364-378)."""
        self.reset_solver()
        self.fwd_pass_init(q)
        self.update_qp_init(problem)

    def solve_main_loop(self):
        """The ADMM main loop (loik-loid.hpp:496-580); note `range(1,
        max_iter)` — at most max_iter - 1 iterations, as in the reference."""
        for i in range(1, self.params.max_iter):
            self.iter = i
            self._iterate_once()
            self.check_convergence()
            if self.iter > 1:
                self.check_feasibility()
            if self.converged:
                break
            if self.primal_infeasible or self.dual_infeasible:
                self.infeasibility_tail_solve()
                break
            self.update_mu()

    def solve(self, q, problem: IkProblem) -> "OracleResult":
        self.solve_init(q, problem)
        self.solve_main_loop()
        return OracleResult(
            nu=self.nu.copy(),
            z=self.z.copy(),
            w=self.w.copy(),
            vis=self.vis.copy(),
            fis=self.fis.copy(),
            yis=self.yis.copy(),
            converged=self.converged,
            primal_infeasible=self.primal_infeasible,
            dual_infeasible=self.dual_infeasible,
            iterations=self.iter,
            tail_solve_iterations=self.tail_solve_iter,
            primal_residual=self.primal_residual,
            dual_residual=self.dual_residual,
            mu=self.mu,
            info=self.info,
        )


@dataclasses.dataclass
class OracleResult:
    nu: np.ndarray
    z: np.ndarray
    w: np.ndarray
    vis: np.ndarray
    fis: np.ndarray
    yis: np.ndarray
    converged: bool
    primal_infeasible: bool
    dual_infeasible: bool
    iterations: int
    tail_solve_iterations: int
    primal_residual: float
    dual_residual: float
    mu: float
    info: Optional[OracleInfo] = None
