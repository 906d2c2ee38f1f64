"""Benchmark: converged diff-IK solves/s/chip (the BASELINE.json metric).

Protocol (mirrors the reference timing harness, tests/loik-loid.cpp:987-1032,
adapted to the batched regime per BASELINE.md): fix the problem family,
pre-generate R batches of random configurations, compile once, then time R
repeated batched cold solves; report throughput counting ONLY converged
problems.  The JSON line records BOTH the pipelined sustained throughput
(value) and the raw wall-clock throughput + p50 batch latency, so neither
number has to be taken on faith, and names the device it ran on.  It runs
on a GPU only: on any other platform it exits with status 2.

Workloads (--config) are the five BASELINE.json configs:
  flagship   panda_arm, one 6-D EE constraint + box bounds      [configs 0]
  mixed      512 UR5 + 512 panda batch, one padded super-batch  [configs 1]
  solo12     4 point-feet + 6-D base task, stance configs       [configs 2]
  talos      whole-body: 6-D base stance + gripper task, 38 dof [configs 3]
  multistart 100k+ random seeds -> argmin task error            [configs 4]
  all        run the five above, one JSON line each

Default invocation (no flags) = flagship, ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...}.
"""

import argparse
import json
import sys
import time

import numpy as np


def _skew(r):
    return np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0.0]])


def build_config(name, args, jnp, robots, make_problem, dtype):
    """Returns (trees, problem(s), q_sampler, B, metric_label).

    q_sampler(key) -> one batch of configurations (or list per group for
    'mixed')."""
    import jax

    if name == "flagship":
        tree = robots.get(args.robot, args.dtype)
        b = np.zeros((1, 6))
        b[0, 2] = args.b3
        problem = make_problem(
            tree, (tree.njoints - 1,), b=b,
            lb=-4.0 * np.ones(tree.nv), ub=4.0 * np.ones(tree.nv),
            dtype=dtype,
        )
        B = args.batch
        sampler = lambda k: tree.random_configuration(k, (B,)).astype(dtype)
        return tree, problem, sampler, B, args.robot

    if name == "solo12":
        # stance task: 6-D base velocity command + zero linear velocity of
        # the four foot POINTS (0.16 m below the knee frames: a joint frame
        # has no linear velocity at its own origin, so the contact point
        # must be offset — A encodes v_lin - [r]x w per foot)
        tree = robots.solo12(args.dtype)
        feet = tree.leaf_joints
        cl = (0,) + feet
        A = np.zeros((5, 6, 6))
        A[0] = np.eye(6)
        for k in range(1, 5):
            A[k, :3, :3] = np.eye(3)
            A[k, :3, 3:] = -_skew([0.0, 0.0, -0.16])
        b = np.zeros((5, 6))
        b[0, 2] = 0.1  # commanded base heave
        problem = make_problem(
            tree, cl, A=A, b=b,
            lb=-12.0 * np.ones(tree.nv), ub=12.0 * np.ones(tree.nv),
            dtype=dtype,
        )
        # bent-knee standing configs (straight legs are singular)
        q0 = np.asarray(tree.neutral()).copy()
        q0[7:] = [0, 0.8, -1.6] * 2 + [0, -0.8, 1.6] * 2
        B = args.batch
        q0j = jnp.asarray(q0, dtype)

        def sampler(k):
            dq = 0.3 * jax.random.uniform(
                k, (B, tree.nv), dtype=dtype, minval=-1.0, maxval=1.0
            )
            return jax.vmap(lambda d: tree.integrate(q0j, d))(dq)

        return tree, problem, sampler, B, "solo12 base+4 point feet"

    if name == "talos":
        tree = robots.talos(args.dtype)
        gl = tree.joint_names.index("gripper_left_joint")
        b = np.zeros((2, 6))
        b[0, 2] = 0.2  # commanded gripper heave; base held (stance)
        problem = make_problem(
            tree, (gl, 0), b=b,
            lb=-4.0 * np.ones(tree.nv), ub=4.0 * np.ones(tree.nv),
            dtype=dtype,
        )
        B = args.batch
        sampler = lambda k: tree.random_configuration(k, (B,)).astype(dtype)
        return tree, problem, sampler, B, "talos whole-body 38-dof"

    raise KeyError(name)


def make_solve_fn(args):
    """Tolerance-path backend selected by --mode (None = plain f32/f64
    single-stage solve)."""
    from loik_tpu.solver.refine import solve_delta_duals, solve_two_stage

    if args.mode == "two-stage":
        return lambda t, p, q, pr: solve_two_stage(
            t, p, q, pr, stage1_max_iter=args.stage1_max_iter,
            stage2_max_iter=args.stage2_max_iter)
    if args.mode == "delta":
        return lambda t, p, q, pr: solve_delta_duals(
            t, p, q, pr, stage1_max_iter=args.stage1_max_iter)
    return None


def run_standard(args, config_name):
    import jax
    import jax.numpy as jnp

    from loik_tpu.model import robots
    from loik_tpu.params import SolverParams
    from loik_tpu.problem import make_problem
    from loik_tpu.solver import solve

    dtype = jnp.dtype(args.dtype)
    tree, problem, sampler, B, label = build_config(
        config_name, args, jnp, robots, make_problem, dtype
    )
    params = SolverParams(
        max_iter=args.max_iter, tol_abs=args.tol, tol_rel=args.tol,
        mu=args.mu, mu_equality_scale_factor=args.mu_eq_scale,
        tail_solve=args.tail_solve, check_interval=args.check_interval,
    )
    fn = make_solve_fn(args)
    run = (lambda q: fn(tree, params, q, problem)) if fn else (
        lambda q: solve(tree, params, q, problem))

    R = args.reps
    keys = jax.random.split(jax.random.PRNGKey(0), R + 1)
    q_batches = [sampler(k) for k in keys]

    res = run(q_batches[-1])  # warmup / compile
    res.nu.block_until_ready()

    lat = []
    total_converged = 0
    t_all0 = time.perf_counter()
    for r in range(R):
        t0 = time.perf_counter()
        res = run(q_batches[r])
        res.converged.block_until_ready()
        lat.append(time.perf_counter() - t0)
        total_converged += int(res.converged.sum())
    t_all = time.perf_counter() - t_all0

    pipe = measure_pipelined(
        [(lambda qb=qb: run(qb)) for qb in q_batches[:R]],
        lambda rs: sum(int(np.asarray(x.converged).sum()) for x in rs),
    )
    dev_s, conv_dev = measure_device_reps(run, q_batches[:R])
    emit(args, label, lat, B, R, total_converged, t_all, res, pipelined=pipe,
         extra_fields={
             "device_ms_per_batch": round(dev_s / R * 1e3, 3),
             "device_value": round(conv_dev / dev_s, 1),
         })


def run_mixed(args):
    """BASELINE configs[1]: UR5 + Panda mixed batch as ONE padded
    super-batch program (parallel/mixed.py)."""
    import jax
    import jax.numpy as jnp

    from loik_tpu.model import robots
    from loik_tpu.params import SolverParams
    from loik_tpu.parallel.mixed import prepare_mixed_padded
    from loik_tpu.problem import make_problem

    dtype = jnp.dtype(args.dtype)
    B = args.batch  # total problems; half UR5, half panda_arm
    Bg = B // 2
    groups_proto = []
    for robot in ("ur5", "panda_arm"):
        tree = robots.get(robot, args.dtype)
        b = np.zeros((1, 6))
        b[0, 2] = args.b3
        # model velocity limits as the box bounds ("velocity-limit + box")
        vl = np.minimum(np.asarray(tree.velocity_limit), 4.0)
        problem = make_problem(tree, (tree.njoints - 1,), b=b,
                               lb=-vl, ub=vl, dtype=dtype)
        groups_proto.append((tree, problem))
    params = SolverParams(
        max_iter=args.max_iter, tol_abs=args.tol, tol_rel=args.tol,
        mu=args.mu, mu_equality_scale_factor=args.mu_eq_scale,
        tail_solve=args.tail_solve, check_interval=args.check_interval,
    )
    solve_fn = make_solve_fn(args)
    # super-batch assembled ONCE; the timed loop pays only q packing + solve
    mp = prepare_mixed_padded(
        [(tree, Bg, prob) for tree, prob in groups_proto], dtype=dtype)

    R = args.reps
    keys = jax.random.split(jax.random.PRNGKey(0), 2 * (R + 1)).reshape(
        R + 1, 2, -1)

    def batch(kk):
        return [
            tree.random_configuration(k, (Bg,)).astype(dtype)
            for (tree, _), k in zip(groups_proto, kk)
        ]

    q_batches = [batch(kk) for kk in keys]

    # raw super-batch solve per rep: the per-group unpack dispatches ~22
    # slice ops, which dominate host time at small B — consumers unpack
    # once outside the timed region (MixedPadded.solve_packed docstring)
    def run(qs):
        return mp.solve_packed(params, qs, solve_fn=solve_fn)

    res = run(q_batches[-1])
    res.nu.block_until_ready()

    lat = []
    total_converged = 0
    t_all0 = time.perf_counter()
    for r in range(R):
        t0 = time.perf_counter()
        res = run(q_batches[r])
        res.converged.block_until_ready()
        lat.append(time.perf_counter() - t0)
        total_converged += int(np.asarray(res.converged).sum())
    t_all = time.perf_counter() - t_all0

    pipe = measure_pipelined(
        [(lambda qb=qb: run(qb)) for qb in q_batches[:R]],
        lambda rss: sum(int(np.asarray(x.converged).sum()) for x in rss),
    )

    # device-side rate: R staged reps inside ONE scanned program
    # (MixedPadded.solve_scan) — zero host round-trips between reps, so at
    # small B this separates the device rate from the dispatch floor.
    # Packing is hoisted and only (converged, iterations) are stacked, so
    # "device rate" means the solve alone, with packing reported separately
    qs_stacked = [
        np.stack([qb[g] for qb in q_batches[:R]])
        for g in range(len(groups_proto))
    ]
    q_packed = mp.pack_q_stacked(qs_stacked)
    jax.block_until_ready(q_packed)
    t0 = time.perf_counter()
    jax.block_until_ready(mp.pack_q_stacked(qs_stacked))
    pack_s = time.perf_counter() - t0
    ys = mp.solve_scan(params, q_packed=q_packed, solve_fn=solve_fn,
                       light=True)
    jax.block_until_ready(ys)
    t0 = time.perf_counter()
    ys = mp.solve_scan(params, q_packed=q_packed, solve_fn=solve_fn,
                       light=True)
    jax.block_until_ready(ys)
    dev_s = time.perf_counter() - t0
    conv_dev = int(np.asarray(ys[0]).sum())
    extra_fields = {
        "device_ms_per_batch": round(dev_s / R * 1e3, 3),  # solve only
        "pack_ms_per_batch": round(pack_s / R * 1e3, 3),
        "device_value": round(conv_dev / dev_s, 1),
    }

    emit(args, "mixed ur5+panda super-batch", lat, B, R, total_converged,
         t_all, mp.unpack(res)[-1], pipelined=pipe,
         extra_fields=extra_fields)


def run_multistart(args):
    """BASELINE configs[4]: 100k+ random seeds, best-task-error reduction."""
    import jax
    import jax.numpy as jnp

    from loik_tpu.model import robots
    from loik_tpu.params import SolverParams
    from loik_tpu.parallel.multistart import solve_multistart
    from loik_tpu.problem import make_problem
    dtype = jnp.dtype(args.dtype)
    tree = robots.get(args.robot, args.dtype)
    b = np.zeros((1, 6))
    b[0, 2] = args.b3
    problem = make_problem(
        tree, (tree.njoints - 1,), b=b,
        lb=-4.0 * np.ones(tree.nv), ub=4.0 * np.ones(tree.nv), dtype=dtype,
    )
    params = SolverParams(
        max_iter=args.max_iter, tol_abs=args.tol, tol_rel=args.tol,
        mu=args.mu, mu_equality_scale_factor=args.mu_eq_scale,
        tail_solve=args.tail_solve, check_interval=args.check_interval,
    )
    solve_fn = make_solve_fn(args)
    B = args.batch
    R = max(args.reps, int(np.ceil(args.min_seeds / B)))  # >= 100k seeds
    keys = jax.random.split(jax.random.PRNGKey(0), R + 1)

    def run(k):
        return solve_multistart(tree, params, problem, k, B,
                                solve_fn=solve_fn)

    ms = run(keys[-1])
    ms.result.nu.block_until_ready()

    lat, total_converged, best = [], 0, np.inf
    t_all0 = time.perf_counter()
    for r in range(R):
        t0 = time.perf_counter()
        ms = run(keys[r])
        ms.error.block_until_ready()
        lat.append(time.perf_counter() - t0)
        total_converged += int(ms.num_converged)
        best = min(best, float(ms.error[0]))
    t_all = time.perf_counter() - t_all0
    res = ms.result

    pipe = measure_pipelined(
        [(lambda k=k: run(k)) for k in keys[:R]],
        lambda rss: sum(int(t.num_converged) for t in rss),
    )
    dev_s, _ = measure_device_reps(lambda k: run(k).result, list(keys[:R]))
    emit(args, f"multistart {B * R} seeds {args.robot} (best task err "
               f"{best:.2e})", lat, B, R, total_converged, t_all, res,
         unit="seeds/s", count_all=True,
         metric="multistart seeds/s/chip (%s, tol %g, %s)", pipelined=pipe,
         extra_fields={
             "device_ms_per_batch": round(dev_s / R * 1e3, 3),
             "device_value": round(B * R / dev_s, 1),  # seeds/s counts all
         })


def measure_device_reps(run, q_batches):
    """Pure device rate: all R reps inside ONE jitted `lax.scan` program, so
    the measurement contains zero host dispatches between reps — the
    chip-rate companion to the pipelined (dispatch-overlapped) number.
    Returns (seconds_total, converged_count)."""
    import jax
    import jax.numpy as jnp

    q_stack = jnp.stack([jnp.asarray(q) for q in q_batches])

    @jax.jit
    def scan_fn(qs):
        def rep(carry, q):
            res = run(q)
            return carry, (res.converged, res.iterations)

        _, ys = jax.lax.scan(rep, jnp.zeros(()), qs)
        return ys

    ys = scan_fn(q_stack)
    jax.block_until_ready(ys)
    t0 = time.perf_counter()
    ys = scan_fn(q_stack)
    jax.block_until_ready(ys)
    dt = time.perf_counter() - t0
    return dt, int(np.asarray(ys[0]).sum())


def measure_pipelined(thunks, count_converged):
    """Sustained throughput: dispatch every batch back-to-back with NO
    per-batch sync, one final block — the BASELINE protocol's
    (B x reps) / wall reading; a serving pipeline never syncs per batch.
    The window is repeated three times and the fastest kept; device work is
    identical in each window."""
    import jax

    best = None
    rs = []
    for _ in range(3):
        rs = []
        t0 = time.perf_counter()
        for thunk in thunks:
            rs.append(thunk())
        jax.block_until_ready(rs[-1])
        t_pipe = time.perf_counter() - t0
        best = t_pipe if best is None else min(best, t_pipe)
    return best, count_converged(rs)


def emit(args, label, lat, B, R, total_converged, t_all, res,
         unit="solves/s", count_all=False,
         metric="converged diff-IK solves/s/chip (%s, tol %g, %s)",
         pipelined=None, extra_fields=None):
    import jax

    # throughput = PIPELINED sustained rate (see measure_pipelined); latency
    # view = p50 of per-batch synced solves, reported alongside with the
    # sync-loop throughput so no number has to be taken on faith
    p50_ms = float(np.percentile(lat, 50) * 1e3)
    conv_frac = total_converged / (B * R)
    counted = B if count_all else conv_frac * B
    throughput = counted / (p50_ms / 1e3)
    throughput_wall = (B * R if count_all else total_converged) / t_all
    target = 1e5  # BASELINE.json: >=1e5 converged 7-DoF solves/s/chip @ 1e-6

    extra = {}
    if pipelined is not None:
        t_pipe, conv_pipe = pipelined
        counted_pipe = B * R if count_all else conv_pipe
        throughput = counted_pipe / t_pipe
        extra = {
            "pipelined_ms_per_batch": round(t_pipe / R * 1e3, 3),
            "sync_p50_value": round(counted / (p50_ms / 1e3), 1),
        }
    if extra_fields:
        extra.update(extra_fields)

    if args.verbose:
        it = np.asarray(res.iterations)
        print(
            f"# {label} B={B} R={R} conv={conv_frac:.3f} "
            f"p50={p50_ms:.2f}ms/batch wall={throughput_wall:.0f}/s "
            + (f"pipelined={extra['pipelined_ms_per_batch']}ms/batch "
               if pipelined is not None else "")
            + f"iters mean={it.mean():.1f} max={int(it.max())} "
            f"backend={jax.devices()[0].platform}",
            file=sys.stderr,
        )

    print(
        json.dumps(
            {
                "metric": metric % (label, args.tol, args.mode),
                "value": round(throughput, 1),
                "unit": unit,
                "vs_baseline": round(throughput / target, 4),
                "wall_value": round(throughput_wall, 1),
                "p50_batch_ms": round(p50_ms, 3),
                "converged_frac": round(conv_frac, 4),
                "batch": B,
                "reps": R,
                **extra,
                **args.device,
            }
        ),
        flush=True,
    )


def measure_device_ticks(tree, params, q, problem, slot, b_seq, state0):
    """Device-side warm-tick cost measured THROUGH the public API:
    `loik_tpu.solve_stream` chains T tracking ticks inside one jitted
    lax.scan (each tick updates the constraint target and re-solves from the
    previous tick's duals) so the measurement contains zero host round-trips
    — the number the 1 kHz budget claim rests on (reference protocol
    tests/loik-loid.cpp:1035-1078).  Returns (seconds_total, ticks,
    mean_warm_iters, conv_frac)."""
    import jax

    from loik_tpu.solver.stream import solve_stream

    # compile + settle
    stream = solve_stream(tree, params, q, problem, slot, b_seq,
                          warm_state=state0)
    jax.block_until_ready(stream.state)
    t0 = time.perf_counter()
    stream = solve_stream(tree, params, q, problem, slot, b_seq,
                          warm_state=stream.state)
    jax.block_until_ready(stream.state)
    dt = time.perf_counter() - t0
    T = b_seq.shape[0]
    return (dt, T,
            float(np.asarray(stream.iterations, np.float64).mean()),
            float(np.asarray(stream.converged, np.float64).mean()))


def run_tracking(args):
    import jax
    import jax.numpy as jnp

    from loik_tpu.api import DiffIkSolver
    from loik_tpu.model import robots
    from loik_tpu.params import SolverParams
    from loik_tpu.problem import make_problem

    dtype = jnp.dtype(args.dtype)
    tree = robots.get(args.robot, args.dtype)
    b = np.zeros((1, 6))
    b[0, 2] = args.b3
    problem = make_problem(
        tree, (tree.njoints - 1,), b=b,
        lb=-4.0 * np.ones(tree.nv), ub=4.0 * np.ones(tree.nv), dtype=dtype,
    )
    params = SolverParams(
        max_iter=args.max_iter, tol_abs=args.tol, tol_rel=args.tol,
        mu=args.mu, mu_equality_scale_factor=args.mu_eq_scale,
        tail_solve=args.tail_solve, check_interval=args.check_interval,
    )
    # per-tick warm-started tracking latency (reference tailored-timing
    # protocol, tests/loik-loid.cpp:1035-1078, batched): every tick updates
    # ONE constraint target and re-solves from the last duals; the metric is
    # wall latency per tick vs the 1 kHz control budget
    B, R = args.batch, args.reps
    ee = tree.njoints - 1
    solver = DiffIkSolver(tree, params.replace(warm_start=True), (ee,),
                          problem=problem)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    q = tree.random_configuration(keys[0], (B,)).astype(dtype)
    ticks = max(50, R)
    for t in range(5):  # compile + settle duals
        res = solver.solve_tracking(q, ee, b=jnp.asarray(b[0], dtype))
    res.converged.block_until_ready()
    lat = []
    for t in range(ticks):
        bt = b[0].copy()
        bt[2] = args.b3 * np.cos(2 * np.pi * t / ticks)
        t0 = time.perf_counter()
        res = solver.solve_tracking(q, ee, b=jnp.asarray(bt, dtype))
        res.converged.block_until_ready()
        lat.append(time.perf_counter() - t0)
    p50_ms = float(np.percentile(lat, 50) * 1e3)
    # pipelined: enqueue ticks without per-tick sync (a real controller
    # overlaps device compute with I/O; ticks stay ordered through the
    # warm-state dependency) — sustained rate, amortizing host RTT
    t0 = time.perf_counter()
    for t in range(ticks):
        bt = b[0].copy()
        bt[2] = args.b3 * np.sin(2 * np.pi * t / ticks)
        res = solver.solve_tracking(q, ee, b=jnp.asarray(bt, dtype))
    res.converged.block_until_ready()
    pipe_ms = (time.perf_counter() - t0) / ticks * 1e3
    # device-side warm-tick cost, zero host round-trips (one scanned program):
    # once at the full fleet size (throughput view) and once for a
    # 256-controller fleet (the 1 kHz per-tick latency claim)
    T = 100
    b_seq = np.tile(b[0], (T, 1)).astype(dtype)
    b_seq[:, 2] = args.b3 * np.cos(2 * np.pi * np.arange(T) / T)
    dev_s, dev_T, warm_iters, dev_conv = measure_device_ticks(
        solver.tree, solver.params, q, solver.problem, 0,
        jnp.asarray(b_seq), solver.state,
    )
    dev_ms = dev_s / dev_T * 1e3
    B_rt = 256
    solver_rt = DiffIkSolver(tree, params.replace(warm_start=True), (ee,),
                             problem=problem)
    q_rt = q[:B_rt]
    for t in range(3):
        res_rt = solver_rt.solve_tracking(q_rt, ee, b=jnp.asarray(b[0], dtype))
    res_rt.converged.block_until_ready()
    rt_s, rt_T, rt_iters, rt_conv = measure_device_ticks(
        solver_rt.tree, solver_rt.params, q_rt, solver_rt.problem, 0,
        jnp.asarray(b_seq), solver_rt.state,
    )
    rt_ms = rt_s / rt_T * 1e3
    if args.verbose:
        it = np.asarray(res.iterations)
        print(
            f"# tracking B={B} ticks={ticks} p50={p50_ms:.3f}ms "
            f"pipelined={pipe_ms:.3f}ms/tick device={dev_ms:.3f}ms/tick "
            f"(device conv={dev_conv:.3f}, warm iters {warm_iters:.2f}) "
            f"conv={float(np.asarray(res.converged).mean()):.3f} "
            f"warm iters mean={it.mean():.1f} max={int(it.max())} "
            f"backend={jax.devices()[0].platform}",
            file=sys.stderr,
        )
    print(json.dumps({
        "metric": "device-side tracking tick, 256-controller fleet (%s, "
                  "tol %g; B=%d fleet %.2f ms/tick; pipelined-dispatch "
                  "%.2f ms, sync p50 %.2f ms)"
                  % (args.robot, args.tol, B, dev_ms, pipe_ms, p50_ms),
        "value": round(rt_ms, 4),
        "unit": "ms",
        "vs_baseline": round(1.0 / max(rt_ms, 1e-9), 4),  # 1 kHz budget
        "device_ms_per_tick_B256": round(rt_ms, 4),
        "device_ms_per_tick_full": round(dev_ms, 4),
        "device_warm_iters_mean": round(rt_iters, 2),
        "device_conv_frac": round(rt_conv, 4),
        "pipelined_ms_per_tick": round(pipe_ms, 3),
        "sync_p50_ms": round(p50_ms, 3),
        **args.device,
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="flagship",
                    choices=["flagship", "mixed", "solo12", "talos",
                             "multistart", "all"],
                    help="BASELINE.json workload (see module docstring)")
    ap.add_argument("--robot", default="panda_arm")
    ap.add_argument("--batch", type=int, default=None,
                    help="problems per batch (default per config)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tol", type=float, default=None,
                    help="default 1e-6 (the BASELINE metric); tracking mode "
                         "defaults to 1e-4 instead — it runs pure f32, whose "
                         "floor is ~1e-5, and a sub-floor tolerance would "
                         "just burn max_iter on every tick")
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--b3", type=float, default=0.2, help="commanded EE v_z")
    ap.add_argument("--mode", default="delta",
                    choices=["f32", "f64", "two-stage", "delta", "tracking"],
                    help="two-stage = f32 bulk + warm f64 refinement; "
                         "delta = f32 bulk + f32 delta-duals correction with "
                         "one f64 KKT evaluation (both are tol-1e-6 paths; "
                         "f32 alone floors ~1e-5); tracking = warm-started "
                         "per-tick latency (the 1 kHz control-loop metric, "
                         "f32)")
    ap.add_argument("--stage1-max-iter", type=int, default=32,
                    help="two-stage: f32 stage-1 iteration cap (past ~4x the "
                         "p99 the stragglers are stage-2 work anyway, and the "
                         "masked batch pays for its slowest member)")
    ap.add_argument("--stage2-max-iter", type=int, default=4,
                    help="two-stage: f64 stage-2 cap; warm-started refinement "
                         "certifies in <=4 iters for all but ~3e-4 of "
                         "problems")
    ap.add_argument("--mu", type=float, default=0.1,
                    help="initial ADMM penalty (swept: mu=0.1, scale=1e5 cuts "
                         "converged-iteration mean from 7.6 to 5.1 and p99 "
                         "from 22 to 16 on the bench problem vs the reference "
                         "fixture defaults, at equal convergence)")
    ap.add_argument("--mu-eq-scale", type=float, default=1e5)
    ap.add_argument("--tail-solve", action="store_true",
                    help="run the closest-feasible tail on certified-"
                         "infeasible problems (off by default: the bench "
                         "metric consumes only converged solutions, and the "
                         "tail burns ~12 masked iterations per infeasible "
                         "problem)")
    ap.add_argument("--min-seeds", type=float, default=1e5,
                    help="multistart: total random seeds floor (BASELINE "
                         "configs[4] says 100k)")
    ap.add_argument("--check-interval", type=int, default=None,
                    help="run convergence checks every K-th iteration "
                         "(OSQP check_termination; 1 = reference parity). "
                         "Default: per config for cold solves (see "
                         "default_ci in main), 1 for tracking (warm ticks "
                         "converge in ~3 iterations; rounding to K would "
                         "cost more than the checks)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    import jax

    from loik_tpu.utils.runenv import (configure_compile_cache, device_record,
                                       query_cards)

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py: needs a GPU; JAX found "
              f"'{jax.devices()[0].platform}'", file=sys.stderr)
        sys.exit(2)
    configure_compile_cache()
    args.device = device_record(query_cards())
    if args.dtype == "float64" or args.mode in ("f64", "two-stage", "delta"):
        # delta runs its loops in f32 but evaluates the one-shot KKT
        # residual in f64
        jax.config.update("jax_enable_x64", True)
    if args.mode == "f64":
        args.dtype = "float64"
    elif args.mode in ("f32", "tracking", "delta"):
        args.dtype = "float32"
    if args.tol is None:
        args.tol = 1e-4 if args.mode == "tracking" else 1e-6

    if args.mode == "tracking":
        if args.check_interval is None:
            args.check_interval = 1
        args.batch = args.batch or 16384
        run_tracking(args)
        return

    default_B = dict(flagship=16384, mixed=1024, solo12=10240, talos=4096,
                     multistart=16384)
    configs = (["flagship", "mixed", "solo12", "talos", "multistart"]
               if args.config == "all" else [args.config])
    user_B = args.batch
    user_ci = args.check_interval
    # per-config check intervals: inherited values that define the
    # benchmark until they are re-swept on the H100 (ROADMAP Speed 5)
    default_ci = dict(flagship=8, mixed=4, solo12=4, talos=1, multistart=8)
    for name in configs:
        args.batch = user_B or default_B[name]
        args.check_interval = default_ci[name] if user_ci is None else user_ci
        if name == "mixed":
            run_mixed(args)
        elif name == "multistart":
            run_multistart(args)
        else:
            run_standard(args, name)


if __name__ == "__main__":
    main()
