"""Problem specification pytree.

Batched form of `IkProblemFormulation` (ik-id-description.hpp:16-338):
per-link tracking weights/targets, hard 6-D task equality constraints at a
static set of links, and joint-velocity box bounds.  Constraint *links* are
static metadata (the reference also fixes them per solver instance —
AddEqConstraint/RemoveEqConstraint are deactivated, ik-id-description.hpp:197);
constraint *values* (A, b) are traced leaves, so per-tick target updates (the
1 kHz trajectory-tracking path, loik-loid-optimized.hpp:596) never recompile.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class IkProblem:
    """One constrained diff-IK problem (batch via leading dims on leaves).

    minimize   sum_i 1/2 (v_i - v_ref_i)^T H_ref_i (v_i - v_ref_i)
    over       v_i (link spatial velocities, local frames), nu (joint vel)
    s.t.       v_i = iXp v_parent(i) + S_i nu_i        (kinematics)
               A_c v_{c} = b_c   for c in constraint_links
               lb <= nu <= ub
    """

    H_ref: jnp.ndarray  # (..., N, 6, 6)
    v_ref: jnp.ndarray  # (..., N, 6)
    A: jnp.ndarray      # (..., NC, 6, 6)
    b: jnp.ndarray      # (..., NC, 6)
    lb: jnp.ndarray     # (..., nv)
    ub: jnp.ndarray     # (..., nv)
    constraint_links: Tuple[int, ...]  # static: moving-joint indices (0-based)

    def tree_flatten(self):
        return (self.H_ref, self.v_ref, self.A, self.b, self.lb, self.ub), (
            self.constraint_links,
        )

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)

    @property
    def num_constraints(self) -> int:
        return len(self.constraint_links)

    def replace(self, **kw) -> "IkProblem":
        return dataclasses.replace(self, **kw)

    def update_constraint(self, slot: int, A=None, b=None) -> "IkProblem":
        """Tailored single-constraint update (`UpdateEqConstraint`,
        ik-id-description-optimized.hpp:178-238): new pytree, same shapes."""
        new = self
        if A is not None:
            new = new.replace(
                A=new.A.at[..., slot, :, :].set(jnp.asarray(A, new.A.dtype))
            )
        if b is not None:
            new = new.replace(
                b=new.b.at[..., slot, :].set(jnp.asarray(b, new.b.dtype))
            )
        return new


def validate_problem(tree, problem: IkProblem) -> None:
    """Input validation — the `checkIkIdData` analog
    (loik-loid-data.hpp:244-321): reject out-of-range or duplicate constraint
    links, mis-shaped leaves, and lb > ub with clear errors instead of
    silently mis-solving.  Shape checks always run; the lb<=ub value check
    runs only on concrete (non-tracer) arrays."""
    import numpy as np

    N, nv, nc = tree.njoints, tree.nv, problem.num_constraints
    for c in problem.constraint_links:
        if not (0 <= c < N):
            raise ValueError(
                f"constraint link {c} out of range [0, {N}) for model "
                f"'{tree.name}'"
            )
    if len(set(problem.constraint_links)) != nc:
        raise ValueError(
            f"duplicate constraint links {problem.constraint_links}: each "
            "link may carry at most one 6-D equality constraint (matching "
            "the reference's one-slot-per-link formulation)"
        )

    def chk(name, arr, core):
        shape = tuple(jnp.shape(arr))
        if len(shape) < len(core) or shape[len(shape) - len(core):] != core:
            raise ValueError(
                f"{name} has shape {shape}; expected trailing dims {core} "
                f"(optionally with one leading batch dim)"
            )
        if len(shape) > len(core) + 1:
            raise ValueError(
                f"{name} has shape {shape}: at most one leading batch dim "
                f"over core shape {core}"
            )

    chk("H_ref", problem.H_ref, (N, 6, 6))
    chk("v_ref", problem.v_ref, (N, 6))
    chk("A", problem.A, (nc, 6, 6))
    chk("b", problem.b, (nc, 6))
    chk("lb", problem.lb, (nv,))
    chk("ub", problem.ub, (nv,))
    lb, ub = problem.lb, problem.ub
    if not (isinstance(lb, jax.core.Tracer) or isinstance(ub, jax.core.Tracer)):
        if np.any(np.asarray(lb) > np.asarray(ub)):
            raise ValueError("lb > ub: box bounds are contradictory")


def make_problem(
    tree,
    constraint_links,
    A=None,
    b=None,
    H_ref=None,
    v_ref=None,
    lb=None,
    ub=None,
    dtype=None,
) -> IkProblem:
    """Convenience constructor with the reference test-fixture defaults
    (tests/loik-loid.cpp:121-130): H_ref = I6 on every link, v_ref = 0,
    A = I6, b = 0 per constraint, bounds from the model's velocity limits."""
    N, nv = tree.njoints, tree.nv
    dt = dtype or tree.dtype
    nc = len(constraint_links)
    eye6 = jnp.eye(6, dtype=dt)
    if H_ref is None:
        H_ref = jnp.broadcast_to(eye6, (N, 6, 6))
    if v_ref is None:
        v_ref = jnp.zeros((N, 6), dt)
    if A is None:
        A = jnp.broadcast_to(eye6, (nc, 6, 6))
    if b is None:
        b = jnp.zeros((nc, 6), dt)
    vl = jnp.where(jnp.isfinite(tree.velocity_limit), tree.velocity_limit, 1e3)
    if lb is None:
        lb = -vl.astype(dt)
    if ub is None:
        ub = vl.astype(dt)
    problem = IkProblem(
        H_ref=jnp.asarray(H_ref, dt),
        v_ref=jnp.asarray(v_ref, dt),
        A=jnp.asarray(A, dt),
        b=jnp.asarray(b, dt),
        lb=jnp.asarray(lb, dt),
        ub=jnp.asarray(ub, dt),
        constraint_links=tuple(int(c) for c in constraint_links),
    )
    validate_problem(tree, problem)
    return problem
