"""Multi-start global IK (BASELINE.json configs[4] — 100k random seeds
feeding sampling-based motion planning).

Differential IK is local; global IK restarts it from many random
configurations and takes the best converged solutions.  Here one diff-IK
solve per seed scores how well the commanded end-effector velocity can be
realized from that configuration; downstream planners integrate `q + dt nu`.
The top-k reduction over the sharded seed axis is the only collective."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..params import SolverParams
from ..problem import IkProblem
from ..solver import solve
from .sharding import make_mesh


def task_error(res, problem: IkProblem):
    """Pure task-constraint violation per problem: max_c ||A_c v_c - b_c||_inf
    at the solution — unlike `primal_residual`, which also folds in the box
    slack block and so is not a task-error score."""
    vis = res.vis                                    # (B, N, 6)
    cl = jnp.asarray(problem.constraint_links)
    vc = vis[:, cl, :]                               # (B, NC, 6)
    A = jnp.asarray(problem.A)
    b = jnp.asarray(problem.b)
    if A.ndim == 3:
        A = A[None]
    if b.ndim == 2:
        b = b[None]
    # full f32: a TF32 product (a GPU's default for f32 dots) would put
    # ~1e-4 of rounding into an error that ranks seeds converged to ~1e-6
    with jax.default_matmul_precision("highest"):
        r = jnp.einsum("...cij,bcj->bci", A, vc) - b
    return jnp.max(jnp.abs(r), axis=(1, 2))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MultistartResult:
    """Ranked multi-start outcome (best seed first).

    ``error[i] == inf`` marks a slot NOT backed by a converged seed: either
    fewer than k seeds converged, or — when ``num_converged == 0`` — no seed
    at all.  Always check ``num_converged`` (host-side: ``.found``) before
    consuming ``q``/``nu``; with zero winners they are arbitrary seed data.
    """

    q: jnp.ndarray              # (k, nq) ranked seed configurations
    nu: jnp.ndarray             # (k, nv) corresponding solutions
    error: jnp.ndarray          # (k,) task errors; inf = slot not converged
    num_converged: jnp.ndarray  # () int32, converged seeds in the whole batch
    result: object              # full per-seed SolveResult

    @property
    def found(self) -> bool:
        """Host-side check: did ANY seed converge?"""
        return bool(self.num_converged > 0)


# sampler + solve + task-error scoring + top-k as ONE jitted program, so a
# restart loop costs one dispatch per batch.  solve_fn/sharding are static
# (function identity / hashable NamedSharding); hold them constant across
# reps to reuse the cache.
@functools.partial(jax.jit, static_argnums=(1, 3, 4, 5, 6))
def _multistart_jit(tree, params, problem, num_seeds, k, solve_fn, shard,
                    key):
    qs = tree.random_configuration(key, (num_seeds,))
    if shard is not None:
        qs = jax.lax.with_sharding_constraint(qs, shard)
    run = solve_fn or solve
    res = run(tree, params, qs, problem)
    # task error per seed: max constraint violation at the solution; inf
    # excludes non-converged seeds from the ranking entirely
    err = jnp.where(res.converged, task_error(res, problem), jnp.inf)
    num_converged = jnp.sum(res.converged.astype(jnp.int32))
    neg_top, idx = jax.lax.top_k(-err, k)   # ascending error, ranked
    return MultistartResult(
        q=qs[idx], nu=res.nu[idx], error=-neg_top,
        num_converged=num_converged, result=res,
    )


def solve_multistart(tree, params: SolverParams, problem: IkProblem, key,
                     num_seeds: int, mesh=None, solve_fn=None,
                     k: int = 1) -> MultistartResult:
    """Solve from `num_seeds` random configurations; return the k best seeds.

    solve_fn(tree, params, qs, problem) overrides the solver backend (e.g.
    delta-duals refinement for tol-1e-6 scoring); default is the batched
    solve, sharded over the mesh's batch axis when a mesh is given (or over
    all devices when more than one is visible).

    The entire step — seed sampling, solve, task-error scoring, top-k
    ranking — runs as one compiled program keyed on `key`, so a restart loop
    costs one dispatch per batch of seeds.

    Returns a `MultistartResult` whose arrays are ranked best-first (k=1 by
    default; planners wanting a beam pass k=8 etc.).  Ranking considers ONLY
    converged seeds: slots beyond ``num_converged`` carry ``error == inf``
    and arbitrary q/nu — when no seed converges at all, ``found`` is False
    and the caller should resample rather than consume slot 0."""
    if not 1 <= k <= num_seeds:
        raise ValueError(f"k must be in [1, num_seeds]; got k={k}")
    shard = None
    if solve_fn is None:
        if mesh is None:
            mesh = make_mesh()
        if num_seeds % mesh.devices.size:
            raise ValueError(
                f"num_seeds {num_seeds} not divisible by mesh size "
                f"{mesh.devices.size}"
            )
        shard = NamedSharding(mesh, P(mesh.axis_names[0]))
    return _multistart_jit(tree, params, problem, int(num_seeds), int(k),
                           solve_fn, shard, key)
