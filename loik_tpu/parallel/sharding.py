"""Multi-device scale-out over a 1-D batch mesh.

The reference is single-threaded, single-process (SURVEY.md §2 parallelism
inventory: no NCCL/MPI/threads anywhere); scale in this rebuild comes from
sharding the *problem batch* across devices with `jax.sharding` — XLA
inserts the collectives (the termination check `any(running)` becomes an
all-reduce each iteration, through NCCL on GPUs; metric aggregation uses
psum-style reductions).  Cross-device traffic is inherently tiny: problems
are independent.

Works identically on the GPUs of one host and on the CPU-simulated 8-device
mesh used by the tests (`--xla_force_host_platform_device_count`).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import SolverParams
from ..problem import IkProblem
from ..solver import solve
from ..solver.state import SolveResult


def make_mesh(devices=None, axis_name: str = "batch") -> Mesh:
    """1-D device mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_problem_batch(mesh: Mesh, q, problem: IkProblem, axis_name: str = "batch"):
    """Place q and any leading-batch problem leaves on the mesh, sharded over
    the batch axis; unbatched (shared) leaves are replicated."""
    B = q.shape[0]
    batched = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())
    q = jax.device_put(q, batched)

    def place(leaf, core_ndim):
        leaf = jnp.asarray(leaf)
        if leaf.ndim > core_ndim and leaf.shape[0] == B:
            return jax.device_put(leaf, batched)
        return jax.device_put(leaf, replicated)

    problem = IkProblem(
        H_ref=place(problem.H_ref, 3),
        v_ref=place(problem.v_ref, 2),
        A=place(problem.A, 3),
        b=place(problem.b, 2),
        lb=place(problem.lb, 1),
        ub=place(problem.ub, 1),
        constraint_links=problem.constraint_links,
    )
    return q, problem


def solve_sharded(tree, params: SolverParams, q, problem: IkProblem,
                  mesh: Optional[Mesh] = None,
                  warm_state=None, axis_name: str = "batch") -> SolveResult:
    """Batch-data-parallel solve across a device mesh.

    The batch must be divisible by the mesh size.  The jitted solve is pure
    SPMD over the batch axis; the only cross-device communication is the
    masked-termination all-reduce and any metric reductions the caller does
    on the (B,)-sharded outputs.
    """
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    n = mesh.devices.size
    if q.shape[0] % n:
        raise ValueError(f"batch {q.shape[0]} not divisible by mesh size {n}")
    q, problem = shard_problem_batch(mesh, q, problem, axis_name)
    return solve(tree, params, q, problem, warm_state)


def convergence_metrics(result: SolveResult):
    """Aggregate per-problem outcomes (device-resident reduction; on a mesh
    this is the psum-style collective over the sharded batch)."""
    conv = result.converged
    return {
        "num_converged": jnp.sum(conv),
        "num_primal_infeasible": jnp.sum(result.primal_infeasible),
        "mean_iterations": jnp.mean(result.iterations.astype(jnp.float32)),
        "max_iterations": jnp.max(result.iterations),
        "mean_iterations_converged": jnp.sum(
            jnp.where(conv, result.iterations, 0).astype(jnp.float32)
        ) / jnp.maximum(jnp.sum(conv), 1),
    }
