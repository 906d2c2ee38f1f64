"""Heterogeneous robot fleet in ONE compiled program.

A UR5 cell and a Panda cell each stream differential-IK problems; the padded
super-batch path (parallel/mixed.py) embeds both serial chains into one
common padded chain and solves the combined batch in a single program,
whichever robot each problem belongs to.

Run: python examples/04_mixed_fleet.py   (CPU or GPU)
"""

import jax
import numpy as np

from loik_tpu.model import robots
from loik_tpu.params import SolverParams
from loik_tpu.parallel import prepare_mixed_padded
from loik_tpu.problem import make_problem


def group(robot, seed, B, vz):
    tree = robots.get(robot, "float32")
    b = np.zeros((1, 6))
    b[0, 2] = vz
    vl = np.minimum(np.asarray(tree.velocity_limit), 4.0)
    problem = make_problem(tree, (tree.njoints - 1,), b=b, lb=-vl, ub=vl)
    q = tree.random_configuration(jax.random.PRNGKey(seed), (B,))
    return tree, q, problem


def main():
    params = SolverParams(max_iter=150, tol_abs=1e-4, tol_rel=1e-4,
                          mu=0.1, mu_equality_scale_factor=1e5)
    groups = [group("ur5", 0, 256, 0.15), group("panda_arm", 1, 256, 0.10)]
    # assemble the super-batch once; a control loop would then pay only the
    # per-tick q packing + solve (solve_mixed_padded wraps both for one-offs)
    fleet = prepare_mixed_padded([(t, 256, p) for t, _, p in groups])
    for tick in range(2):
        results = fleet.solve(params, [q for _, q, _ in groups])
    for (tree, _, _), res in zip(groups, results):
        conv = np.asarray(res.converged)
        it = np.asarray(res.iterations)
        print(f"{tree.name:10s} B={conv.size}  converged={conv.mean():.2f}  "
              f"iters mean={it.mean():.1f}  nu shape={res.nu.shape}")


if __name__ == "__main__":
    main()
