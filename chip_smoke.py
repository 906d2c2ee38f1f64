"""Chip smoke test: drive the diff-IK main path once on one GPU, at the real
sizes of the six deployments `bench.py` defines, and check sampled problems
of every phase against the dense f64 oracle (`loik_tpu.oracle`).

Phases (same robots, batches and solver parameters as bench.py):

  flagship    panda_arm, B=16384, tol 1e-6   DiffIkSolver.solve_refined
  solo12      18 dof, B=10240, tol 1e-6      (delta-duals, bench default)
  talos       38 dof, B=4096, tol 1e-6
  mixed       UR5 + panda super-batch, B=1024, tol 1e-6   prepare_mixed_padded
  multistart  2 batches x 16384 seeds, tol 1e-6           solve_multistart
  tracking    warm ticks, B=256 and 16384, T=100, tol 1e-4 DiffIkSolver.track_scan

Each phase prints one line: compile and run seconds, converged fraction,
mean/max iterations, the process's peak device memory so far, and the oracle
comparison.  The last line is the JSON result, printed only when every phase
passed; otherwise the script exits 1.  Without a GPU it exits 2 at once.

  python chip_smoke.py            one GPU, all six phases
  python chip_smoke.py --cards 4  only the batch-sharded path on four GPUs,
                                  against single-card solves on card 0
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import types

import numpy as np

# ---- tolerances of the oracle comparison ----------------------------------
# Converged production solves claim a primal residual below
# tol_abs + tol_rel * scale (scale <= ~4 for these problems).  Re-evaluated in
# f64 from the returned f32 `nu` (f64 kinematics, f64 A and b), the task
# residual |A v - b|_inf must stay within that claim plus f32 rounding of nu
# (~1e-6).  A float32 dot run in TF32 (~1e-3 relative) anywhere on the path
# (FK, task products) leaves residuals of order 1e-4..1e-3 and fails.
RES_TOL = {1e-6: 2e-5, 1e-4: 6e-4}
# `nu` of a production solve against the oracle's, both certified at the same
# tolerance: two tol-approximate solutions of the same strictly convex QP
# differ by O(tol * condition); the bound leaves room for the worst-
# conditioned sampled configurations.
NU_TOL = {1e-6: 2e-3, 1e-4: 5e-2}
# Flags: >= 99% of the sampled problems must be flag-consistent with the
# oracle: every flag the production sets is confirmed (a production
# `primal_infeasible` needs the oracle's certificate; a production `converged`
# needs the oracle's convergence or, where the oracle's OSQP certificate fired
# instead, the f64 residual check below), and every problem the oracle
# converges the production converges too.  A production problem that used up
# its iteration budget undecided contradicts neither oracle verdict.  The
# exact (converged, infeasible) match rate is reported beside it: the bench's
# check_interval>1 schedule, the delta path's stage budgets and the oracle's
# early certificates under mu_eq = 1e4 keep it below 1 (PERF.md).
FLAG_AGREE = 0.99
# multistart: the reported top-seed task error against its f64 re-evaluation
TOP_ERR_TOL = 1e-5

CHECK_INTERVAL = dict(flagship=8, mixed=4, solo12=4, talos=1, multistart=8)


def _params(tol, check_interval, max_iter=200):
    from loik_tpu.params import SolverParams

    return SolverParams(max_iter=max_iter, tol_abs=tol, tol_rel=tol, mu=0.1,
                        mu_equality_scale_factor=1e5, tail_solve=False,
                        check_interval=check_interval)


def _delta(tree, params, q, problem):
    """The bench's tol-1e-6 backend (`bench.py --mode delta`)."""
    from loik_tpu.solver.refine import solve_delta_duals

    return solve_delta_duals(tree, params, q, problem, stage1_max_iter=32)


def _bench_config(name, B):
    """(tree, problem, sampler) of a bench deployment, in f32."""
    import jax.numpy as jnp

    import bench
    from loik_tpu.model import robots
    from loik_tpu.problem import make_problem

    args = types.SimpleNamespace(robot="panda_arm", dtype="float32", b3=0.2,
                                 batch=B)
    tree, problem, sampler, _, _ = bench.build_config(
        name, args, jnp, robots, make_problem, jnp.float32)
    return tree, problem, sampler


# --------------------------------------------------------------------------- #
# measurement helpers
# --------------------------------------------------------------------------- #

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


class CompileClock:
    """Sums JAX's tracing, lowering and compile durations inside a block."""

    def __enter__(self):
        from jax import monitoring

        self.seconds = 0.0
        self.count = 0

        def listener(name, duration, **kw):
            if name in _COMPILE_EVENTS:
                self.seconds += duration
                self.count += name.endswith("backend_compile_duration")

        self._listener = listener
        monitoring.register_event_duration_secs_listener(listener)
        return self

    def __exit__(self, *exc):
        from jax import monitoring

        monitoring.unregister_event_duration_listener(self._listener)


def timed(fn):
    """(result, wall seconds, compile seconds, compilations) of one call,
    waited for on the device."""
    import jax

    with CompileClock() as clock:
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
    return out, dt, clock.seconds, clock.count


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def _summary(converged, iterations):
    conv = np.asarray(converged)
    it = np.asarray(iterations)
    return {"converged_frac": float(conv.mean()),
            "iters_mean": float(it.mean()), "iters_max": int(it.max())}


def _sample(B, n, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(B, size=min(n, B), replace=False))


@contextlib.contextmanager
def _on_cpu():
    """Run the oracle on the CPU device when the CPU backend is up."""
    import jax

    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        yield
        return
    with jax.default_device(cpu):
        yield


# --------------------------------------------------------------------------- #
# the f64 oracle comparison
# --------------------------------------------------------------------------- #

def _np_problem(problem, i):
    """Problem i of an IkProblem with shared or leading-batch leaves, f64."""
    from loik_tpu.problem import IkProblem

    def leaf(x, core_ndim):
        x = np.asarray(x, np.float64)
        return x[i] if x.ndim > core_ndim else x

    return IkProblem(H_ref=leaf(problem.H_ref, 3), v_ref=leaf(problem.v_ref, 2),
                     A=leaf(problem.A, 3), b=leaf(problem.b, 2),
                     lb=leaf(problem.lb, 1), ub=leaf(problem.ub, 1),
                     constraint_links=problem.constraint_links)


def task_residual_f64(orc, nu, problem):
    """|A v - b|_inf of joint velocities `nu`, with v rebuilt in f64 from the
    kinematics the oracle holds (after `solve_init`/`solve` at the same q)."""
    nu = np.asarray(nu, np.float64)
    v = np.zeros((orc.N, 6))
    for i in range(orc.N):
        par = orc.parents[i]
        vp = v[par] if par >= 0 else np.zeros(6)
        R, p = orc.liMi_R[i], orc.liMi_p[i]
        lin = R.T @ (vp[:3] - np.cross(p, vp[3:]))
        ang = R.T @ vp[3:]
        iv, k = orc.idx_v[i], orc.nvs[i]
        v[i] = np.concatenate([lin, ang]) + orc.S[i] @ nu[iv:iv + k]
    A = np.asarray(problem.A, np.float64)
    b = np.asarray(problem.b, np.float64)
    return max(float(np.max(np.abs(A[k] @ v[c] - b[k])))
               for k, c in enumerate(problem.constraint_links))


def check_against_oracle(tree, params, problem, q, nu, converged,
                         primal_infeasible, idx):
    """Solve problems `idx` with the f64 OracleSolver on the CPU and compare.

    `problem` has shared or leading-batch leaves; q/nu/flags are the
    production batch's (B, ...) arrays.  Returns the comparison record, with
    "pass"."""
    from loik_tpu.oracle import OracleSolver

    tol = params.tol_abs
    tree64 = tree.astype(np.float64)
    oparams = params.replace(check_interval=1)
    q = np.asarray(q, np.float64)
    nu = np.asarray(nu, np.float64)
    conv = np.asarray(converged)
    pinf = np.asarray(primal_infeasible)
    exact, consistent, both, dnu, res = 0, 0, 0, 0.0, 0.0
    with _on_cpu():
        for i in idx:
            prob_i = _np_problem(problem, i)
            orc = OracleSolver(tree64, oparams)
            o = orc.solve(q[i], prob_i)
            c, p = bool(conv[i]), bool(pinf[i])
            exact += (c, p) == (o.converged, o.primal_infeasible)
            r_i = task_residual_f64(orc, nu[i], prob_i) if c else 0.0
            res = max(res, r_i)
            consistent += ((c or not o.converged)
                           and (o.primal_infeasible or not p)
                           and (not c or o.converged or r_i <= RES_TOL[tol]))
            if c and o.converged:
                both += 1
                dnu = max(dnu, float(np.max(np.abs(nu[i] - o.nu))))
    n = len(idx)
    rec = {"sampled": n, "flags_consistent": consistent / n,
           "flags_exact": exact / n, "both_converged": both,
           "nu_max_diff": dnu, "nu_tol": NU_TOL[tol],
           "task_res_f64_max": res, "task_res_tol": RES_TOL[tol]}
    rec["pass"] = bool(consistent / n >= FLAG_AGREE and both > 0
                       and dnu <= NU_TOL[tol] and res <= RES_TOL[tol])
    return rec


# --------------------------------------------------------------------------- #
# phases (sizes are arguments so the CPU tests can run them at toy sizes)
# --------------------------------------------------------------------------- #

def phase_standard(name, B, n_check=64, seed=0):
    """flagship / solo12 / talos: one cold batch through
    `DiffIkSolver.solve_refined` (delta-duals), twice: compile, then run."""
    import jax

    from loik_tpu.api import DiffIkSolver

    tree, problem, sampler = _bench_config(name, B)
    params = _params(1e-6, CHECK_INTERVAL[name])
    solver = DiffIkSolver(tree, params, problem.constraint_links, problem)
    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    _, _, compile_s, _ = timed(lambda: solver.solve_refined(sampler(k0)).nu)
    q = sampler(k1)
    jax.block_until_ready(q)
    res, run_s, _, recompiles = timed(lambda: solver.solve_refined(q))
    rec = {"phase": name, "B": B, "compile_s": compile_s, "run_s": run_s,
           "recompiles_in_run": recompiles,
           **_summary(res.converged, res.iterations)}
    rec["peak_bytes_in_use"] = peak_bytes()
    rec["oracle"] = check_against_oracle(
        tree, params, problem, q, res.nu, res.converged,
        res.primal_infeasible, _sample(B, n_check, seed))
    rec["pass"] = rec["oracle"]["pass"]
    return rec


def _mixed_setup(B):
    import jax.numpy as jnp

    from loik_tpu.model import robots
    from loik_tpu.parallel.mixed import prepare_mixed_padded
    from loik_tpu.problem import make_problem

    groups = []
    for robot in ("ur5", "panda_arm"):
        tree = robots.get(robot, "float32")
        b = np.zeros((1, 6))
        b[0, 2] = 0.2
        vl = np.minimum(np.asarray(tree.velocity_limit), 4.0)
        groups.append((tree, make_problem(tree, (tree.njoints - 1,), b=b,
                                          lb=-vl, ub=vl, dtype=jnp.float32)))
    mp = prepare_mixed_padded([(t, B // 2, p) for t, p in groups],
                              dtype=jnp.float32)
    return groups, mp


def phase_mixed(B, n_check=64, seed=0):
    """UR5 + panda_arm padded super-batch (`prepare_mixed_padded`)."""
    import jax
    import jax.numpy as jnp

    groups, mp = _mixed_setup(B)
    params = _params(1e-6, CHECK_INTERVAL["mixed"])
    Bg = B // 2

    def draw(key):
        return [t.random_configuration(k, (Bg,)).astype(jnp.float32)
                for (t, _), k in zip(groups, jax.random.split(key))]

    k0, k1 = jax.random.split(jax.random.PRNGKey(seed))
    _, _, compile_s, _ = timed(
        lambda: mp.solve_packed(params, draw(k0), solve_fn=_delta).nu)
    qs = draw(k1)
    jax.block_until_ready(qs)
    res, run_s, _, recompiles = timed(
        lambda: mp.solve_packed(params, qs, solve_fn=_delta))
    rec = {"phase": "mixed", "B": B, "compile_s": compile_s, "run_s": run_s,
           "recompiles_in_run": recompiles,
           **_summary(res.converged, res.iterations)}
    rec["peak_bytes_in_use"] = peak_bytes()
    per_group = mp.unpack(res)
    checks = []
    for g, ((tree, problem), r, qg) in enumerate(zip(groups, per_group, qs)):
        checks.append(check_against_oracle(
            tree, params, problem, qg, r.nu, r.converged,
            r.primal_infeasible, _sample(Bg, n_check // 2, seed + g)))
    rec["oracle"] = {tree.name: c for (tree, _), c in zip(groups, checks)}
    rec["pass"] = all(c["pass"] for c in checks)
    return rec


def _flagship_problem():
    import jax.numpy as jnp

    from loik_tpu.model import robots
    from loik_tpu.problem import make_problem

    tree = robots.get("panda_arm", "float32")
    b = np.zeros((1, 6))
    b[0, 2] = 0.2
    problem = make_problem(tree, (tree.njoints - 1,), b=b,
                           lb=-4.0 * np.ones(tree.nv), ub=4.0 * np.ones(tree.nv),
                           dtype=jnp.float32)
    return tree, problem


def phase_multistart(B, batches=2, n_check=64, seed=0):
    """`solve_multistart` over `batches` batches of B random seeds."""
    import jax

    from loik_tpu.oracle import OracleSolver
    from loik_tpu.parallel.multistart import solve_multistart

    tree, problem = _flagship_problem()
    params = _params(1e-6, CHECK_INTERVAL["multistart"])
    # host copies: slicing a device array of keys would compile inside the
    # timed run
    keys = list(np.asarray(jax.random.split(jax.random.PRNGKey(seed),
                                            batches + 1)))

    def run(key):
        return solve_multistart(tree, params, problem, key, B, solve_fn=_delta)

    _, _, compile_s, _ = timed(lambda: run(keys[-1]).error)
    results, run_s, _, recompiles = timed(
        lambda: [run(k) for k in keys[:batches]])
    ms = results[-1]
    conv = np.concatenate([np.asarray(m.result.converged) for m in results])
    iters = np.concatenate([np.asarray(m.result.iterations) for m in results])
    rec = {"phase": "multistart", "seeds": B * batches, "compile_s": compile_s,
           "run_s": run_s, "recompiles_in_run": recompiles,
           **_summary(conv, iters)}
    rec["peak_bytes_in_use"] = peak_bytes()
    # the seeds of the last batch, drawn exactly as inside solve_multistart
    qs = jax.jit(lambda k: tree.random_configuration(k, (B,)))(
        keys[batches - 1])
    r = ms.result
    rec["oracle"] = check_against_oracle(
        tree, params, problem, qs, r.nu, r.converged, r.primal_infeasible,
        _sample(B, n_check, seed))
    # the top seed's task error, re-evaluated in f64
    top_err = float(ms.error[0])
    prob0 = _np_problem(problem, 0)
    with _on_cpu():
        orc = OracleSolver(tree.astype(np.float64), params)
        orc.solve_init(np.asarray(ms.q[0], np.float64), prob0)
        err64 = task_residual_f64(orc, ms.nu[0], prob0)
    rec["top_seed"] = {"error": top_err, "error_f64": err64,
                       "tol": TOP_ERR_TOL}
    top_ok = bool(ms.found and abs(top_err - err64) <= TOP_ERR_TOL
                  and err64 <= RES_TOL[1e-6])
    rec["pass"] = rec["oracle"]["pass"] and top_ok
    return rec


def phase_tracking(batches=(256, 16384), T=100, n_check=64, seed=0):
    """Warm-started tracking ticks: settle with `DiffIkSolver.solve_tracking`,
    then T ticks as one `track_scan` (compile), then T more (run)."""
    import jax
    import jax.numpy as jnp

    from loik_tpu.api import DiffIkSolver

    tree, problem = _flagship_problem()
    params = _params(1e-4, 1).replace(warm_start=True)
    ee = tree.njoints - 1
    b_seq = np.zeros((T, 6), np.float32)
    b_seq[:, 2] = 0.2 * np.cos(2 * np.pi * np.arange(T) / T)
    b_seq = jnp.asarray(b_seq)
    rec = {"phase": "tracking", "T": T, "pass": True}
    for B in batches:
        solver = DiffIkSolver(tree, params, (ee,), problem=problem)
        q = tree.random_configuration(jax.random.PRNGKey(seed), (B,))
        for _ in range(3):
            solver.solve_tracking(q, ee, b=b_seq[0])
        _, _, compile_s, _ = timed(lambda: solver.track_scan(q, b_seq).nu)
        stream, run_s, _, recompiles = timed(
            lambda: solver.track_scan(q, b_seq))
        sub = {"B": B, "compile_s": compile_s, "run_s": run_s,
               "ms_per_tick": run_s / T * 1e3, "recompiles_in_run": recompiles,
               **_summary(stream.converged, stream.iterations)}
        # the last tick's warm solutions against cold oracle solves of the
        # same final problem
        final = problem.update_constraint(0, b=b_seq[-1])
        sub["oracle"] = check_against_oracle(
            tree, params.replace(warm_start=False), final, q, stream.nu[-1],
            stream.converged[-1], stream.state.primal_infeasible,
            _sample(B, n_check, seed))
        rec[f"B{B}"] = sub
        rec["pass"] = rec["pass"] and sub["oracle"]["pass"]
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


def phase_cards(devices, B_per=16384, n_seeds_per=16384, seed=0):
    """The batch-sharded path on `devices`: flagship `solve_sharded` at
    B = len(devices) * B_per against single-device solves of the same shards
    on devices[0], and `solve_multistart` over the mesh against its
    single-device result.  Parity rules: nu within atol 2e-5 (+ rtol 2e-5),
    converged-flag differences at most B/100, no iteration count off by more
    than 1."""
    import jax

    from loik_tpu.parallel import make_mesh, solve_multistart, solve_sharded
    from loik_tpu.solver import solve

    n = len(devices)
    mesh = make_mesh(devices)
    one = make_mesh(devices[:1])
    tree, problem = _flagship_problem()
    params = _params(1e-6, CHECK_INTERVAL["flagship"])
    B = n * B_per
    q = tree.random_configuration(jax.random.PRNGKey(seed), (B,))
    _, _, c_n, _ = timed(lambda: solve_sharded(tree, params, q, problem,
                                               mesh).nu)
    res, t_n, _, _ = timed(lambda: solve_sharded(tree, params, q, problem,
                                                 mesh))
    shards = [jax.device_put(q[i * B_per:(i + 1) * B_per], devices[0])
              for i in range(n)]
    _, _, c_1, _ = timed(lambda: solve(tree, params, shards[0], problem).nu)
    t_1, iters_1, ref = 0.0, 0, []
    for s in shards:
        r, dt, _, _ = timed(lambda: solve(tree, params, s, problem))
        t_1 += dt
        iters_1 += int(np.asarray(r.iterations).max())
        ref.append(r)

    def cat(name):
        return np.concatenate([np.asarray(getattr(r, name)) for r in ref])

    def parity(nu, conv, it, nu_ref, conv_ref, it_ref):
        flag_diffs = int(np.sum(np.asarray(conv) != conv_ref))
        it_off = int(np.sum(np.abs(np.asarray(it, np.int64)
                                   - np.asarray(it_ref, np.int64)) > 1))
        diff = np.abs(np.asarray(nu) - nu_ref)
        nu_ok = bool(np.all(diff <= 2e-5 + 2e-5 * np.abs(nu_ref)))
        nu_diff = float(diff.max())
        ok = (nu_ok and flag_diffs <= max(1, len(conv_ref) // 100)
              and it_off == 0)
        return {"nu_max_diff": nu_diff, "flag_diffs": flag_diffs,
                "iters_off_by_more_than_1": it_off, "pass": bool(ok)}

    sharded = {
        "B": B, "devices": len(res.nu.sharding.device_set),
        "compile_s_mesh": c_n, "compile_s_one": c_1,
        "run_s_mesh": t_n, "run_s_one_total": t_1,
        "ms_per_iter_mesh": t_n / int(np.asarray(res.iterations).max()) * 1e3,
        "ms_per_iter_one": t_1 / iters_1 * 1e3,
        **parity(res.nu, res.converged, res.iterations, cat("nu"),
                 cat("converged"), cat("iterations")),
    }
    key = jax.random.PRNGKey(seed + 1)
    S = n * n_seeds_per
    timed(lambda: solve_multistart(tree, params, problem, key, S,
                                   mesh=mesh).error)
    ms_n, tm_n, _, _ = timed(lambda: solve_multistart(tree, params, problem,
                                                      key, S, mesh=mesh))
    timed(lambda: solve_multistart(tree, params, problem, key, S,
                                   mesh=one).error)
    ms_1, tm_1, _, _ = timed(lambda: solve_multistart(tree, params, problem,
                                                      key, S, mesh=one))
    r_n, r_1 = ms_n.result, ms_1.result
    multistart = {
        "seeds": S, "run_s_mesh": tm_n, "run_s_one": tm_1,
        "ms_per_iter_mesh": tm_n / int(np.asarray(r_n.iterations).max()) * 1e3,
        "ms_per_iter_one": tm_1 / int(np.asarray(r_1.iterations).max()) * 1e3,
        "top_error_mesh": float(ms_n.error[0]),
        "top_error_one": float(ms_1.error[0]),
        **parity(r_n.nu, r_n.converged, r_n.iterations, np.asarray(r_1.nu),
                 np.asarray(r_1.converged), np.asarray(r_1.iterations)),
    }
    return {"phase": f"cards{n}", "sharded": sharded, "multistart": multistart,
            "peak_bytes_in_use": peak_bytes(),
            "pass": sharded["pass"] and multistart["pass"]}


PHASES = {
    "flagship": lambda: phase_standard("flagship", 16384),
    "solo12": lambda: phase_standard("solo12", 10240),
    "talos": lambda: phase_standard("talos", 4096),
    "mixed": lambda: phase_mixed(1024),
    "multistart": lambda: phase_multistart(16384, batches=2),
    "tracking": lambda: phase_tracking((256, 16384), T=100),
}


def run_phases(phases) -> bool:
    """Run each phase, print its line, return whether all passed."""
    ok = True
    for name, fn in phases:
        try:
            rec = fn()
        except Exception:  # reported, and the run fails below
            traceback.print_exc()
            rec = {"phase": name, "pass": False, "error": "exception"}
        print(f"phase {name}: {json.dumps(rec)}", flush=True)
        ok = ok and bool(rec["pass"])
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the batch-sharded path on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from loik_tpu.utils.runenv import configure_compile_cache, query_cards

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found "
              f"'{devices[0].platform}'", file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs; "
              f"found {len(devices)}", file=sys.stderr)
        return 2
    configure_compile_cache()
    jax.config.update("jax_enable_x64", True)  # delta path's f64 KKT step
    for line in query_cards()[:args.cards]:
        print(f"card: {line}", flush=True)
    if args.cards == 1:
        ok = run_phases(list(PHASES.items()))
    else:
        ok = run_phases([("cards4", lambda: phase_cards(devices[:4]))])
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
