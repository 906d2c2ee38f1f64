"""Sharded solve on the CPU-simulated 8-device mesh: results must be
identical to the single-device solve, and the multi-start driver must pick a
converged seed.  (New surface relative to the reference, which has no
distributed runtime — SURVEY.md §4 transfer notes.)"""

import jax
import jax.numpy as jnp
import numpy as np

from loik_tpu.model import robots
from loik_tpu.parallel import (
    task_error,
    convergence_metrics,
    make_mesh,
    solve_multistart,
    solve_sharded,
)
from loik_tpu.params import SolverParams
from loik_tpu.problem import make_problem
from loik_tpu.solver import solve

from tests.test_oracle import fixture_problem

PARAMS = SolverParams(max_iter=200, tol_abs=1e-6, tol_rel=1e-6)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_matches_single_device():
    tree = robots.panda()
    problem = fixture_problem(tree, b3=0.2)
    B = 64
    qs = tree.random_configuration(jax.random.PRNGKey(1), (B,))
    mesh = make_mesh()
    res_sh = solve_sharded(tree, PARAMS, qs, problem, mesh)
    res_ref = solve(tree, PARAMS, qs, problem)
    np.testing.assert_allclose(np.asarray(res_sh.nu), np.asarray(res_ref.nu), atol=1e-12)
    np.testing.assert_array_equal(
        np.asarray(res_sh.converged), np.asarray(res_ref.converged)
    )
    np.testing.assert_array_equal(
        np.asarray(res_sh.iterations), np.asarray(res_ref.iterations)
    )
    # output really is sharded over the mesh
    assert len(res_sh.nu.sharding.device_set) == 8


def test_sharded_heterogeneous_problems():
    """Per-problem targets sharded over devices."""
    tree = robots.ur5()
    B = 16
    b = np.zeros((B, 1, 6))
    b[:, 0, 2] = np.linspace(0.05, 0.4, B)
    problem = make_problem(tree, (tree.njoints - 1,)).replace(b=jnp.asarray(b))
    qs = jnp.broadcast_to(tree.neutral(), (B, tree.nq))
    res = solve_sharded(tree, PARAMS, qs, problem, make_mesh())
    assert bool(res.converged.all())
    # velocities scale with the commanded b
    vz = np.asarray(res.vis[:, -1, 2])
    np.testing.assert_allclose(vz, b[:, 0, 2], atol=1e-5)


def test_convergence_metrics():
    tree = robots.ur5()
    problem = fixture_problem(tree)
    qs = jnp.broadcast_to(tree.neutral(), (8, tree.nq))
    res = solve_sharded(tree, PARAMS, qs, problem, make_mesh())
    m = convergence_metrics(res)
    assert int(m["num_converged"]) == 8
    assert float(m["mean_iterations_converged"]) == float(res.iterations[0])


def test_multistart_picks_converged_seed():
    tree = robots.panda()
    problem = fixture_problem(tree, b3=0.2)
    ms = solve_multistart(
        tree, PARAMS, problem, jax.random.PRNGKey(0), num_seeds=64, mesh=make_mesh()
    )
    assert ms.found
    assert np.isfinite(float(ms.error[0]))
    assert float(ms.error[0]) < PARAMS.tol_abs * 10
    assert int(ms.num_converged) == int(ms.result.converged.sum()) > 0
    # the winner really is the argmin over converged seeds
    err_all = np.where(np.asarray(ms.result.converged),
                       np.asarray(task_error(ms.result, problem)), np.inf)
    assert float(ms.error[0]) == err_all.min()


def test_multistart_topk_ranked():
    """k>1 returns a beam of converged seeds ranked by task error."""
    tree = robots.panda()
    problem = fixture_problem(tree, b3=0.2)
    k = 8
    ms = solve_multistart(
        tree, PARAMS, problem, jax.random.PRNGKey(0), num_seeds=64,
        mesh=make_mesh(), k=k,
    )
    err = np.asarray(ms.error)
    assert err.shape == (k,)
    assert ms.q.shape == (k, tree.nq) and ms.nu.shape == (k, tree.nv)
    assert np.all(np.diff(err) >= 0)  # best first
    n_finite = int(np.isfinite(err).sum())
    assert n_finite == min(k, int(ms.num_converged))
    # each ranked slot's nu matches the full result at its seed
    err_all = np.where(np.asarray(ms.result.converged),
                       np.asarray(task_error(ms.result, problem)), np.inf)
    np.testing.assert_array_equal(err[:n_finite],
                                  np.sort(err_all)[:n_finite])


def test_multistart_no_winner():
    """All seeds infeasible: found=False, every slot flagged inf — the
    caller gets an explicit empty-beam signal, not a silent seed 0
    (VERDICT r4 weak #6)."""
    tree = robots.panda()
    # task velocity far outside what the tiny box bounds allow
    problem = fixture_problem(tree, b3=50.0).replace(
        lb=-0.01 * jnp.ones(tree.nv), ub=0.01 * jnp.ones(tree.nv)
    )
    ms = solve_multistart(
        tree, PARAMS, problem, jax.random.PRNGKey(0), num_seeds=16,
        mesh=make_mesh(), k=4,
    )
    assert int(ms.num_converged) == 0
    assert not ms.found
    assert np.all(np.isinf(np.asarray(ms.error)))


def test_stream_on_sharded_fleet():
    """A tracking stream over a batch-sharded controller fleet: scanned
    warm ticks run SPMD over the mesh and match the unsharded stream (the
    multi-chip form of the 1 kHz capability)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from loik_tpu.solver.stream import solve_stream

    tree = robots.panda()
    problem = fixture_problem(tree, b3=0.1)
    B, T = 16, 4
    qs = tree.random_configuration(jax.random.PRNGKey(5), (B,))
    b_seq = np.zeros((T, 6))
    b_seq[:, 2] = 0.1 * np.cos(np.arange(T))
    params = PARAMS.replace(warm_start=True)

    ref = solve_stream(tree, params, qs, problem, 0, b_seq)
    mesh = make_mesh()
    qs_sh = jax.device_put(qs, NamedSharding(mesh, P("batch")))
    sh = solve_stream(tree, params, qs_sh, problem, 0, b_seq)
    assert len(sh.nu.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(sh.nu), np.asarray(ref.nu),
                               atol=1e-10)
    np.testing.assert_array_equal(np.asarray(sh.converged),
                                  np.asarray(ref.converged))


def test_task_error_dot_runs_at_full_f32():
    """The multistart score's task product is pinned to HIGHEST precision:
    a GPU's default TF32 (~1e-3 relative) put ~5e-5 of error into top-seed
    scores that are ~1e-7 in f64 (chip_smoke's multistart check, tolerance
    1e-5 between the reported score and its f64 re-evaluation)."""
    import jax.numpy as jnp

    from loik_tpu.parallel.multistart import task_error

    tree = robots.get("panda_arm", "float32")
    problem = make_problem(tree, (tree.njoints - 1,), dtype=jnp.float32)
    q = tree.random_configuration(jax.random.PRNGKey(0), (4,))
    res = solve(tree, SolverParams(max_iter=5), q, problem)
    hlo = jax.jit(task_error).lower(res, problem).as_text()
    dots = [ln for ln in hlo.splitlines() if "dot_general" in ln]
    assert dots and all("precision = [HIGHEST, HIGHEST]" in ln for ln in dots)
