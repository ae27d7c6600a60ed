"""Process set-up shared by the measurement scripts (``bench.py``,
``benchmarks.py``, ``chip_smoke.py``): where the compile cache lives, the
refusal to measure without a GPU, and the card's name and power limit."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

import jax

REPO_ROOT = Path(__file__).resolve().parents[2]


def compile_cache_dir(environ=None) -> str:
    """The persistent compile cache's directory: ``JAX_COMPILATION_CACHE_DIR``
    when it is set (JAX reads that variable itself), else the fixed
    ``<repo>/.jax_cache`` (git-ignored). A fixed path matters: it is part of
    the cache's key, so a directory that moves never hits."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        REPO_ROOT / ".jax_cache")


def enable_compile_cache(environ=None) -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir``. Sets
    nothing when the environment variable already decides."""
    environ = os.environ if environ is None else environ
    path = compile_cache_dir(environ)
    if not environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first device, which must be a GPU. A measurement never falls
    back to the CPU: without a GPU this raises ``SystemExit``."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this script measures the GPU only")
    return dev


def device_record() -> dict:
    """The device as JAX reports it (the key every result carries)."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
