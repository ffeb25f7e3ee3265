"""Process set-up shared by the entry scripts (``bench.py``,
``chip_smoke.py``, ``demos/*.py``): the persistent compile cache, the GPU
check, and a one-line description of the device every result names.
"""

from __future__ import annotations

import os
import subprocess

import jax

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``
    (a fixed path: the path is part of the cache key)."""
    return os.environ.get(CACHE_ENV) or os.path.join(REPO, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.
    When the environment names a directory JAX already uses it, and no
    other path is set here."""
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return compile_cache_dir()


def require_gpu():
    """The device list, or RuntimeError unless JAX's first device is a
    GPU.  Measurement paths call this instead of falling back to the CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this path measures the GPU only")
    return devs


def card_name_and_power() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it
    (run as a child process that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def device_info() -> dict:
    """What every result line names: JAX's platform, device kind and
    device count, and the card's name and power limit."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_name_and_power()}
