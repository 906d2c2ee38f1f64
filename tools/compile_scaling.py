"""Measure trace+compile time vs joint count (VERDICT r1 'compile-time
scaling guard'): the solver unrolls 3 tree sweeps per iteration at trace
time, so tracing scales with njoints.  This tool records the curve so the
cost stays measured, not assumed.  Runs on the CPU (tracing is host work;
XLA CPU compile times show how compilation grows with the tree).

Usage: python tools/compile_scaling.py [--sizes 7 18 34 64 100] [--b 256]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def chain(n, dtype_str="float32"):
    import jax.numpy as jnp

    from loik_tpu.model.tree import REVOLUTE, make_tree

    axes = [((1, 0, 0), (0, 1, 0), (0, 0, 1))[i % 3] for i in range(n)]
    J = [
        dict(name=f"j{i}", parent=i - 1, type=REVOLUTE, xyz=(0.05, 0.0, 0.1),
             axis=axes[i], velocity_limit=4.0)
        for i in range(n)
    ]
    return make_tree(J, name=f"chain{n}", dtype=jnp.dtype(dtype_str))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[7, 18, 34, 64, 100])
    ap.add_argument("--b", type=int, default=256)
    args = ap.parse_args()

    import jax.numpy as jnp

    from loik_tpu.params import SolverParams
    from loik_tpu.problem import make_problem
    from loik_tpu.solver.solve import _solve_impl

    params = SolverParams(max_iter=32, tol_abs=1e-4, tol_rel=1e-4)
    print(f"# XLA path, B={args.b}, f32, max_iter=32 (trace/compile/first-run"
          " seconds)")
    for n in args.sizes:
        tree = chain(n)
        b = np.zeros((1, 6), np.float32)
        b[0, 2] = 0.1
        prob = make_problem(tree, (n - 1,), b=b,
                            lb=-4 * np.ones(n), ub=4 * np.ones(n))
        q = tree.random_configuration(jax.random.PRNGKey(0), (args.b,))

        fn = jax.jit(lambda q: _solve_impl(tree, params, q, prob, None).nu)
        t0 = time.perf_counter()
        lowered = fn.lower(q)
        t_trace = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = lowered.compile()
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled(q).block_until_ready()
        t_run = time.perf_counter() - t0
        print(f"njoints={n:4d}  trace={t_trace:7.2f}s  "
              f"compile={t_compile:7.2f}s  run={t_run:6.3f}s", flush=True)


if __name__ == "__main__":
    main()
