"""Observability: profiling traces, recompilation guard, NaN checks.

Replaces the reference's rigor mechanisms with their JAX-native analogs
(SURVEY.md §5):

- `PinocchioTicToc` timing (tests/loik-loid.cpp:1004) -> `trace()` context
  emitting a jax.profiler trace viewable in TensorBoard/XProf.
- `CHECK_RUNTIME_MALLOC` / `LOIK_EIGEN_MALLOC_NOT_ALLOWED` (macros.hpp:7-15;
  CMakeLists.txt:93-97) -> `no_recompile_guard()`: in steady state the jitted
  solver must hit its compile cache — a recompile is the moral equivalent of
  a hot-loop malloc (a shape/topology leak).
- `INITIALIZE_WITH_NAN` (CMakeLists.txt:88-91) -> `debug_nans()` context
  enabling jax's NaN checker.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/loik_tpu_trace"):
    """Profile a block with the JAX profiler (open in XProf/TensorBoard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    import jax

    old = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", old)


@dataclass
class CompileEvents:
    count: int = 0
    names: List[str] = field(default_factory=list)


@contextlib.contextmanager
def no_recompile_guard(allowed: int = 0):
    """Fail if more than `allowed` jit compilations happen inside the block.

    Usage: warm the solver up once, then wrap the steady-state loop; any
    recompile indicates a shape/topology/static-arg leak — the analog of the
    reference's runtime-malloc checker firing.
    """
    from jax import monitoring

    events = CompileEvents()

    def listener(name, duration, **kw):
        if name == "/jax/core/compile/backend_compile_duration":
            events.count += 1
            events.names.append(name)

    monitoring.register_event_duration_secs_listener(listener)
    try:
        yield events
    finally:
        monitoring.unregister_event_duration_listener(listener)
    if events.count > allowed:
        raise RuntimeError(
            f"no_recompile_guard: {events.count} compilations inside guarded "
            f"block (allowed {allowed}) — static-arg or shape leak "
            f"(the jit analog of a hot-loop malloc)"
        )


class Timer:
    """Wall-clock timing helper mirroring the SMOOTH(NBT) protocol of the
    reference timing tests (tests/loik-loid.cpp:1004-1026)."""

    def __init__(self):
        self.samples: List[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    @property
    def mean_us(self) -> float:
        return 1e6 * sum(self.samples) / max(len(self.samples), 1)

    def percentile_ms(self, p: float) -> float:
        import numpy as np

        return float(np.percentile(self.samples, p) * 1e3)
