"""Scale-out: sharded batch solve + multi-start global IK.

Runs on whatever devices are visible — the GPUs of one host, or, with
JAX_PLATFORMS=cpu, a CPU-simulated 8-device mesh (the standard way to
exercise pjit code without hardware, SURVEY.md §4).  The problem batch shards over a 1-D mesh;
XLA inserts the collectives (the loop-termination check is the only
per-iteration all-reduce).

Run:  python examples/03_multichip_multistart.py
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax
import numpy as np

from loik_tpu import SolverParams, make_problem
from loik_tpu.model import robots
from loik_tpu.parallel import (convergence_metrics, make_mesh,
                               solve_multistart, solve_sharded)

tree = robots.panda_arm("float32")
params = SolverParams(max_iter=100, tol_abs=1e-4, tol_rel=1e-4)
b = np.zeros((1, 6)); b[0, 2] = 0.2
problem = make_problem(tree, (6,), b=b,
                       lb=-4 * np.ones(7), ub=4 * np.ones(7))

mesh = make_mesh()
n = len(mesh.devices.ravel())
print(f"mesh: {n} x {mesh.devices.ravel()[0].platform}")

# ---- sharded batch solve -------------------------------------------------
B = 128 * n
qs = tree.random_configuration(jax.random.PRNGKey(0), (B,))
res = solve_sharded(tree, params, qs, problem, mesh)
m = convergence_metrics(res)                      # device-resident psum-style
print(f"sharded solve: B={B} over {n} devices; "
      f"converged={int(m['num_converged'])} "
      f"mean_iters={float(m['mean_iterations']):.1f} "
      f"shards={len(res.nu.sharding.device_set)}")

# ---- multi-start global IK ----------------------------------------------
ms = solve_multistart(
    tree, params, problem, jax.random.PRNGKey(1), num_seeds=B, mesh=mesh, k=4)
assert ms.found, "no seed converged — resample"
print(f"multistart: best task error {float(ms.error[0]):.2e} "
      f"({int(ms.num_converged)}/{B} seeds converged); "
      f"q* = {np.asarray(ms.q[0]).round(3)}")
