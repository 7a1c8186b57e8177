"""Process set-up shared by every entry point: the persistent compile cache
and a report of the device the run got.

Cache rule: if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing here overrides it; otherwise the cache goes to ``.jax_cache/`` at the
checkout root (gitignored).  A fixed path matters: the cache key includes
it, so a directory that moves never hits.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
DEFAULT_CACHE_DIR = os.path.join(ROOT, ".jax_cache")


def cache_dir() -> str:
    """The compile-cache directory this process uses."""
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``cache_dir()``."""
    import jax

    path = cache_dir()
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_info() -> Dict:
    """``{"platform", "kind", "count"}`` of the default backend."""
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of each GPU as ``nvidia-smi`` reports them,
    read in a child process that stays off JAX; "not available" without
    ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out or "not available"


def report_device(tag: str) -> Dict:
    """Print the platform, device kind and count (one line) and return
    them."""
    info = device_info()
    print(f"[{tag}] device: platform={info['platform']} "
          f"kind={info['kind']} count={info['count']}", flush=True)
    return info


def setup(tag: str) -> Dict:
    """Entry-point start-up: enable the compile cache, report the device."""
    enable_compile_cache()
    return report_device(tag)
