"""Run-environment helpers shared by `bench.py` and `chip_smoke.py`: where
the persistent compile cache lives, and which card a measurement ran on."""

from __future__ import annotations

import os
import subprocess
from typing import Mapping, Optional

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """The directory the program should set for JAX's compile cache: None
    when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads the variable itself
    and no other directory may override it), else ``<checkout>/.jax_cache``."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def configure_compile_cache() -> None:
    import jax

    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def parse_card_line(line: str) -> dict:
    """One line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` -> {"name", "power_limit"} (text as printed)."""
    name, sep, limit = line.strip().rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return {"name": name.strip(), "power_limit": limit.strip()}


def query_cards() -> list:
    """The nvidia-smi lines for every visible card, read by a child process
    (so this process never opens the card for it); [] without nvidia-smi."""
    try:
        out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def device_record(card_lines) -> dict:
    """The device fields every measurement line carries."""
    import jax

    devs = jax.devices()
    rec = {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
           "device_count": len(devs)}
    if card_lines:
        rec.update({f"card_{k}": v
                    for k, v in parse_card_line(card_lines[0]).items()})
    return rec
