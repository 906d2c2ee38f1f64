"""Device-resident tracking streams: T warm-started ticks in ONE program.

The reference's 1 kHz control-loop surface is the tailored
`Solve(q, c_id, Ai, bi)` overload (loik-loid-optimized.hpp:596-695): every
tick updates one constraint target and re-solves warm-started from the last
tick's duals.  Through a per-tick host dispatch that pattern pays one host
round-trip per tick, however little device work a warm tick costs.
`solve_stream` runs the WHOLE tick sequence as one jitted `lax.scan`, warm
state threaded on-device — zero host round-trips between ticks.  This is
the program `bench.py` measures for the device-side tracking line; it lives
here so users can call the measured capability directly.

A controller that must react to sensors each tick still uses
`DiffIkSolver.solve_tracking`; one that can stage a horizon of targets (or
replay a trajectory) uses `solve_stream` / `DiffIkSolver.track_scan` and
pays the round-trip once per horizon.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..params import SolverParams
from ..problem import IkProblem
from .solve import _solve_impl
from .state import SolverState


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Per-tick outputs of a tracking stream (leading tick axis T)."""

    nu: jnp.ndarray                 # (T, B, nv) flat joint velocities
    converged: jnp.ndarray          # (T, B)
    iterations: jnp.ndarray         # (T, B)
    primal_residual: jnp.ndarray    # (T, B)
    dual_residual: jnp.ndarray      # (T, B)
    state: SolverState              # final state (warm start for the next
                                    # stream / tick)




@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _stream_jit(tree, params, slot, refine, q, problem, warm_state, b_seq,
                A_seq):
    per_tick_q = q.ndim == 3

    def tick(st, xs):
        bt_, At_, qt_ = xs
        prob = problem.update_constraint(slot, A=At_, b=bt_)
        qt = qt_ if per_tick_q else q
        if refine == "delta":
            from .refine import solve_delta_duals

            res = solve_delta_duals(tree, params, qt, prob, warm_state=st)
        else:
            res = _solve_impl(tree, params, qt, prob, st)
        return res.state, (res.nu, res.converged, res.iterations,
                           res.primal_residual, res.dual_residual)

    xs = (b_seq, A_seq, q if per_tick_q else None)
    stT, (nu, conv, iters, rp, rd) = jax.lax.scan(tick, warm_state, xs)
    return StreamResult(nu=nu, converged=conv, iterations=iters,
                        primal_residual=rp, dual_residual=rd, state=stT)


def solve_stream(tree, params: SolverParams, q, problem: IkProblem,
                 slot: int, b_seq, A_seq=None,
                 warm_state: Optional[SolverState] = None,
                 refine: Optional[str] = None) -> StreamResult:
    """Run T tracking ticks as ONE device program (`lax.scan` over ticks).

    Each tick t updates constraint ``slot`` to ``b_seq[t]`` (and
    ``A_seq[t]`` when given), then re-solves warm-started from the previous
    tick's state — the batched analog of the reference's tailored control
    overload `Solve(q, c_id, Ai, bi)` (loik-loid-optimized.hpp:596-695),
    with the host dispatched ONCE for the whole horizon instead of per tick.

    Args:
      q: (B, nq) configurations held fixed across ticks, or (T, B, nq) for a
        per-tick configuration stream (the reference overload re-reads q
        every tick; pass the measured-state horizon here).
      b_seq: (T, ...) per-tick constraint targets, shaped like one
        ``problem.b[slot]`` entry per tick.
      A_seq: optional (T, ...) per-tick constraint matrices.
      warm_state: state threaded into tick 0 (e.g. from a previous stream or
        a settling `solve`); None starts cold.  With ``params.warm_start``
        every subsequent tick warm-starts from its predecessor either way —
        warm_start=False resets each tick (rarely what a tracker wants).
      refine: None (default) solves each tick in plain f32 at
        params.tol (the 1 kHz regime; the f32 floor is ~1e-5), or
        "delta" to run the delta-duals tol-1e-6 path per tick (f32 stages
        + one f64 KKT evaluation; needs jax x64 enabled) — full-space warm
        state threads between ticks, for slower control loops that need
        certified tight tolerances.

    Per-iteration logging is unsupported (T stacked log arrays; use
    `solve_tracking` per tick to log).
    """
    if params.logging:
        raise ValueError(
            "solve_stream does not support per-iteration logging (the scan "
            "would stack T full log arrays); use solve_tracking per tick"
        )
    q = jnp.asarray(q)
    if q.ndim not in (2, 3):
        raise ValueError(f"q must be (B, nq) or (T, B, nq); got {q.shape}")
    b_seq = jnp.asarray(b_seq, q.dtype)
    B = q.shape[-2]
    if refine not in (None, "delta"):
        raise ValueError(f"refine must be None or 'delta'; got {refine!r}")
    # the delta path's returned state is f32 regardless of q dtype; the
    # scan carry must be type-stable
    state_dtype = jnp.float32 if refine == "delta" else q.dtype
    if warm_state is None:
        from .state import init_state

        warm_state = init_state(tree, B, problem.num_constraints,
                                state_dtype)
    elif refine == "delta":
        from .refine import _cast_state

        warm_state = _cast_state(warm_state, jnp.float32)
    A_seq = None if A_seq is None else jnp.asarray(A_seq, q.dtype)
    return _stream_jit(tree, params, int(slot), refine, q, problem,
                       warm_state, b_seq, A_seq)
