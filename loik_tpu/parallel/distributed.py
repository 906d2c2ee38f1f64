"""Multi-host scale-out: `jax.distributed` bootstrap + global-batch solves.

The reference is strictly single-process — its CMakeLists.txt:111-117 lists
no communication dependency and SURVEY.md §2's parallelism inventory found no
threads/MPI/NCCL anywhere — so this module is net-new surface (SURVEY.md §5
"Distributed communication backend"): every host contributes its
process-local shard of one global problem batch, the jitted solve runs SPMD
over the global 1-D ``batch`` mesh, and XLA inserts the collectives (on
GPUs the masked-termination ``any(running)`` all-reduce runs through NCCL
every iteration, over NVLink within a host and the network across hosts;
metric aggregation is a psum-style reduction).

Tested without hardware by launching N OS processes with
``--xla_force_host_platform_device_count`` virtual CPU devices each
(tests/test_distributed.py), the standard way to validate multi-host pjit
code (SURVEY.md §4 transfer notes).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import SolverParams
from ..problem import IkProblem
from ..solver import solve
from ..solver.state import SolveResult
from .sharding import convergence_metrics

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None) -> None:
    """Bootstrap multi-process JAX (idempotent).

    On GPU hosts (and for simulated CPU hosts) nothing detects the cluster:
    pass ``coordinator_address`` (``host:port`` of process 0),
    ``num_processes`` and ``process_id`` explicitly on every process.
    """
    global _initialized
    if _initialized:
        return
    # NB: must not touch the backend (jax.devices/process_count) before
    # jax.distributed.initialize; double-init is detected by initialize()
    # itself raising, handled below.
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already initialized" not in str(e).lower():
            raise
    _initialized = True


def shutdown() -> None:
    """Tear down the distributed service (end of program)."""
    global _initialized
    if _initialized:
        jax.distributed.shutdown()
        _initialized = False


def global_mesh(axis_name: str = "batch") -> Mesh:
    """1-D mesh over ALL global devices (every process sees the same mesh)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def from_local_batch(mesh: Mesh, local, axis_name: str = "batch"):
    """Assemble a batch-sharded global array from this process's local shard.

    Every process calls this with its own ``(B_local, ...)`` block; the
    global array has ``B_global = B_local * process_count`` rows laid out in
    process order (the mesh follows ``jax.devices()`` global ordering).
    """
    local = np.asarray(local)
    sharding = NamedSharding(mesh, P(axis_name))
    global_shape = (local.shape[0] * jax.process_count(),) + local.shape[1:]
    return jax.make_array_from_process_local_data(sharding, local, global_shape)


def replicated(mesh: Mesh, arr):
    """A fully-replicated global array from identical per-process host data."""
    arr = np.asarray(arr)
    sharding = NamedSharding(mesh, P())
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def local_shard(garr) -> np.ndarray:
    """This process's rows of a batch-sharded global array (host numpy)."""
    shards = sorted(
        garr.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def solve_global(tree, params: SolverParams, q_local, problem: IkProblem,
                 mesh: Optional[Mesh] = None, warm_state=None,
                 axis_name: str = "batch") -> SolveResult:
    """Solve one GLOBAL batch assembled from per-process local shards.

    Args:
      q_local: this process's ``(B_local, nq)`` configurations.
      problem: leaves either unbatched (replicated to every device) or with
        a leading ``B_local`` batch axis (sharded like ``q_local``).

    Returns a SolveResult of global arrays; use :func:`local_shard` on its
    leaves for this process's rows and :func:`global_metrics` for
    cross-host aggregates.
    """
    if mesh is None:
        mesh = global_mesh(axis_name)
    q_local = np.asarray(q_local)
    B_local = q_local.shape[0]
    if (B_local * jax.process_count()) % mesh.devices.size:
        raise ValueError(
            f"global batch {B_local * jax.process_count()} not divisible by "
            f"mesh size {mesh.devices.size}"
        )
    q = from_local_batch(mesh, q_local, axis_name)

    def place(leaf, core_ndim):
        leaf = np.asarray(leaf)
        if leaf.ndim > core_ndim and leaf.shape[0] == B_local:
            return from_local_batch(mesh, leaf, axis_name)
        return replicated(mesh, leaf)

    problem = IkProblem(
        H_ref=place(problem.H_ref, 3),
        v_ref=place(problem.v_ref, 2),
        A=place(problem.A, 3),
        b=place(problem.b, 2),
        lb=place(problem.lb, 1),
        ub=place(problem.ub, 1),
        constraint_links=problem.constraint_links,
    )
    return solve(tree, params, q, problem, warm_state)


def global_metrics(result: SolveResult):
    """Cross-host aggregate outcomes as host scalars, identical on every
    process (the reductions run as replicated-output collectives)."""
    m = convergence_metrics(result)
    return {k: np.asarray(v).item() for k, v in m.items()}
