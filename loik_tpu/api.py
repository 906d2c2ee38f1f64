"""Object-style solver API mirroring the reference's surface.

`DiffIkSolver` plays the role of `FirstOrderLoikOptimizedTpl`
(loik-loid-optimized.hpp:22): construct once per (model, params, constraint
topology), then call `solve`, the split `solve_init` / `resolve` pair, or
the tailored per-tick `solve_tracking` that updates a single constraint —
the 1 kHz control-loop path (`Solve(q, c_id, Ai, bi)`,
loik-loid-optimized.hpp:596-695).  All methods are batched; jit caching is
keyed by (topology, params, batch shape), the rebuild's analog of the
allocate-once contract (SURVEY.md §7 hard part 6).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from .params import SolverParams
from .problem import IkProblem, make_problem
from .solver import solve
from .solver.solve import _solve_impl
from .solver.state import SolveResult, SolverState


# One device program per tick: the tailored constraint update happens INSIDE
# the jit so a tracking tick costs a single dispatch (+ the small b/A
# transfer) instead of separate scatter dispatches per update.
@functools.partial(jax.jit, static_argnums=(1, 2))
def _tracking_jit(tree, params, slot, q, problem, A, b, warm_state):
    problem = problem.update_constraint(slot, A=A, b=b)
    return _solve_impl(tree, params, q, problem, warm_state), problem


class DiffIkSolver:
    def __init__(self, tree, params: SolverParams,
                 constraint_links: Sequence[int],
                 problem: Optional[IkProblem] = None):
        self.tree = tree
        self.params = params
        self.constraint_links = tuple(int(c) for c in constraint_links)
        self.problem = problem if problem is not None else make_problem(
            tree, self.constraint_links
        )
        self._state: Optional[SolverState] = None
        self._q = None
        self._liMi = None
        self.last_result: Optional[SolveResult] = None

    # ------------------------------------------------------------------ #
    def update_references(self, H_ref=None, v_ref=None):
        """UpdateReference(s) (ik-id-description.hpp:76-100)."""
        if H_ref is not None:
            self.problem = self.problem.replace(H_ref=jnp.asarray(H_ref))
        if v_ref is not None:
            self.problem = self.problem.replace(v_ref=jnp.asarray(v_ref))

    def update_eq_constraints(self, A, b):
        """UpdateEqConstraints — constraint count/links fixed at construction
        (AddEqConstraint/RemoveEqConstraint are deactivated in the reference
        too, ik-id-description.hpp:197-253)."""
        A, b = jnp.asarray(A), jnp.asarray(b)
        if A.shape[-3] != len(self.constraint_links):
            raise ValueError("number of equality constraints cannot change")
        self.problem = self.problem.replace(A=A, b=b)

    def update_eq_constraint(self, link: int, A=None, b=None):
        """Single-constraint update by link id (UpdateEqConstraint,
        ik-id-description-optimized.hpp:178-238)."""
        if link not in self.constraint_links:
            raise ValueError(f"no constraint at link {link}")
        slot = self.constraint_links.index(link)
        self.problem = self.problem.update_constraint(slot, A=A, b=b)

    def update_ineq_constraints(self, lb, ub):
        lb, ub = jnp.asarray(lb), jnp.asarray(ub)
        if lb.shape != ub.shape:
            raise ValueError("lb/ub shape mismatch")
        self.problem = self.problem.replace(lb=lb, ub=ub)

    # ------------------------------------------------------------------ #
    def solve(self, q, problem: Optional[IkProblem] = None) -> SolveResult:
        """Stand-alone solve (cold unless params.warm_start)."""
        if problem is not None:
            self.problem = problem
        res = solve(self.tree, self.params, q, self.problem,
                    self._state if self.params.warm_start else None)
        self._state = res.state
        self._q = q
        self.last_result = res
        return res

    def solve_refined(self, q, problem: Optional[IkProblem] = None,
                      method: str = "delta", **refine_kw) -> SolveResult:
        """Tight-tolerance solve below the ~1e-5 f32 floor.

        method="delta" (default): pure-f32 delta-duals correction with one
        f64 KKT evaluation (`solver.refine.solve_delta_duals`) — no f64
        loop.  method="two-stage": f32 bulk + warm f64 refinement
        (`solve_two_stage`); also the fallback for trees with
        configuration-dependent subspaces (universal joints).  Keyword args
        forward to the chosen backend."""
        from .solver.refine import solve_delta_duals, solve_two_stage

        if problem is not None:
            self.problem = problem
        if method == "delta" and self.tree.has_q_dependent_S:
            method = "two-stage"
        backend = {"delta": solve_delta_duals,
                   "two-stage": solve_two_stage}[method]
        res = backend(
            self.tree, self.params, q, self.problem,
            warm_state=self._state if self.params.warm_start else None,
            **refine_kw,
        )
        self._state = res.state
        self._q = q
        self.last_result = res
        return res

    def solve_init(self, q, problem: Optional[IkProblem] = None):
        """SolveInit/Solve split: freeze FK at q, then `resolve()` re-runs
        only the main loop (timing harness pattern, loik-loid-optimized.hpp:
        335-361; equality with the monolithic overload is test-asserted).
        FK runs ONCE here; `resolve()` reuses the cached liMi — like the
        reference, whose split exists precisely to avoid re-running FK."""
        from .solver.solve import fwd_pass_init_jit

        if problem is not None:
            self.problem = problem
        q = jnp.asarray(q)
        if q.ndim == 1:
            q = q[None]
        self._q = q
        self._liMi = fwd_pass_init_jit(self.tree, q)

    def resolve(self) -> SolveResult:
        """Re-run only the main loop on the FK frozen by `solve_init`.

        Honors `params.warm_start` exactly like the reference's `Solve()`
        after `SolveInit()`, which runs `ik_id_data_.Reset(warm_start_)` —
        duals/primal persist across re-solves when the flag is set
        (loik-loid-optimized.hpp:368-455, loik-loid-data-optimized.hxx:
        114-127) — and threads the result state so later warm calls
        (`solve_tracking`, another `resolve`) start from it."""
        if self._q is None:
            raise RuntimeError("call solve_init first")
        from .solver.solve import solve_from_fk

        res = solve_from_fk(self.tree, self.params, self._liMi[0],
                            self._liMi[1], self.problem,
                            self._state if self.params.warm_start else None)
        self._state = res.state
        self.last_result = res
        return res

    def solve_tracking(self, q, link: int, A=None, b=None) -> SolveResult:
        """Per-tick tracking solve: update ONE constraint target and re-solve,
        warm-starting duals from the previous tick when params.warm_start
        (the 1 kHz path, loik-loid-optimized.hpp:596-695).  The update and
        the solve run as one device program per tick."""
        if link not in self.constraint_links:
            raise ValueError(f"no constraint at link {link}")
        slot = self.constraint_links.index(link)
        q = jnp.asarray(q)
        if q.ndim == 1:
            q = q[None]
        res, self.problem = _tracking_jit(
            self.tree, self.params, slot, q, self.problem,
            None if A is None else jnp.asarray(A),
            None if b is None else jnp.asarray(b),
            self._state if self.params.warm_start else None,
        )
        self._state = res.state
        self.last_result = res
        return res

    def track_scan(self, q, b_seq, link: Optional[int] = None, A_seq=None,
                   refine: Optional[str] = None):
        """Run a horizon of tracking ticks as ONE device program.

        The device-resident form of `solve_tracking`: `b_seq[t]` (and
        optionally `A_seq[t]`) retargets the constraint at `link` each tick
        and the re-solve warm-starts from the previous tick's duals, all
        inside one jitted `lax.scan` — zero host round-trips between ticks
        (the 1 kHz capability; reference tailored overload
        loik-loid-optimized.hpp:596-695).  `q` is (B, nq) held fixed or
        (T, B, nq) per tick.  Returns a `StreamResult` with per-tick
        (T, B, ...) outputs; the final tick's state/targets become the
        solver's warm state and constraint values, so per-tick
        `solve_tracking` calls and further streams continue seamlessly."""
        from .solver.stream import solve_stream

        if link is None:
            if len(self.constraint_links) != 1:
                raise ValueError(
                    "multiple constraints; pass link= explicitly")
            link = self.constraint_links[0]
        if link not in self.constraint_links:
            raise ValueError(f"no constraint at link {link}")
        slot = self.constraint_links.index(link)
        q = jnp.asarray(q)
        if q.ndim == 1:
            q = q[None]
        stream = solve_stream(
            self.tree, self.params, q, self.problem, slot,
            b_seq, A_seq=A_seq,
            warm_state=self._state if self.params.warm_start else None,
            refine=refine,
        )
        self._state = stream.state
        self.problem = self.problem.update_constraint(
            slot,
            A=None if A_seq is None else jnp.asarray(A_seq)[-1],
            b=jnp.asarray(b_seq)[-1],
        )
        return stream

    def reach(self, q0, target_R, target_p, link: Optional[int] = None,
              **kw):
        """Closed-loop position IK to target SE(3) poses (`solve_clik`):
        the reference's tailored tick (loik-loid-optimized.hpp:596-695)
        wrapped in the FK -> pose-error -> solve -> integrate loop as one
        device program.  Uses this solver's problem (weights/bounds) with
        its constraint at `link` retargeted every tick; keyword args
        (dt/steps/gain/max_task_velocity/...) pass through to `solve_clik`.
        Returns a ClikResult; does NOT thread the solver's warm state (the
        loop manages its own per-tick warm starts and self-healing)."""
        from .solver.clik import solve_clik

        if link is None:
            if len(self.constraint_links) != 1:
                raise ValueError(
                    "multiple constraints; pass link= explicitly")
            link = self.constraint_links[0]
        if self.constraint_links != (link,):
            raise ValueError(
                "reach() needs this solver to have exactly one constraint "
                f"at link {link}; got links {self.constraint_links}"
            )
        return solve_clik(self.tree, self.params, q0, target_R, target_p,
                          link, problem=self.problem, **kw)

    # ------------------------------------------------------------------ #
    # getter parity (task-solver-base.hpp:87-141)
    # ------------------------------------------------------------------ #
    @property
    def state(self) -> Optional[SolverState]:
        return self._state

    def get_iter(self):
        return self.last_result.iterations

    def get_primal_residual(self):
        return self.last_result.primal_residual

    def get_dual_residual(self):
        return self.last_result.dual_residual

    def get_convergence_status(self):
        return self.last_result.converged

    def get_primal_infeasibility_status(self):
        return self.last_result.primal_infeasible

    def get_dual_infeasibility_status(self):
        return self.last_result.dual_infeasible

    def reset(self):
        """Drop warm-start state (Reset, task-solver-base.hpp:73-84)."""
        self._state = None
        self.last_result = None
