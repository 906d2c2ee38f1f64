"""Test-harness guards and the plain tracking tick."""

import jax
import numpy as np

from loik_tpu.api import DiffIkSolver
from loik_tpu.model import robots
from loik_tpu.params import SolverParams

from tests.test_oracle import fixture_problem

PARAMS = SolverParams(max_iter=64, tol_abs=1e-4, tol_rel=1e-4)


def test_map_count_guard_mechanism(monkeypatch):
    """The conftest vm.max_map_count guard: reading /proc/self/maps works
    and jax.clear_caches fires when the count exceeds the safety margin
    (the serial-pytest SIGSEGV fix — XLA:CPU JIT mappings accumulate to
    the kernel limit where LLVM's next mmap segfaults)."""
    import tests.conftest as conftest

    n = conftest._map_count()
    assert n > 100  # a live python process has hundreds of mappings
    assert conftest._MAP_SAFETY < conftest._MAP_LIMIT
    called = []
    monkeypatch.setattr(jax, "clear_caches", lambda: called.append(1))
    monkeypatch.setattr(conftest, "_map_count", lambda: conftest._MAP_SAFETY + 1)
    gen = conftest._bound_jit_code_mappings.__wrapped__()
    next(gen)
    try:
        next(gen)
    except StopIteration:
        pass
    assert called == [1]


def test_forced_false_still_solves():
    """A plain tracking tick on the production loop produces a correct
    solve."""
    tree = robots.ur5()
    problem = fixture_problem(tree)
    s = DiffIkSolver(tree, PARAMS, problem.constraint_links, problem)
    b = np.zeros(6)
    b[2] = 0.1
    res = s.solve_tracking(tree.neutral(), problem.constraint_links[0], b=b)
    assert bool(res.converged[0])
    np.testing.assert_allclose(np.asarray(res.vis[0, -1]), b, atol=1e-3)
