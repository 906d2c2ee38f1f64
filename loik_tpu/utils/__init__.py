from .checkpoint import load_state, save_state
from .observability import Timer, debug_nans, no_recompile_guard, trace

__all__ = [
    "trace",
    "debug_nans",
    "no_recompile_guard",
    "Timer",
    "save_state",
    "load_state",
]
