"""ctypes bindings for the native (C++) host-side KS integrator.

Builds ``native/ks_solver.cc`` on first use (g++ -O3 -shared) into the
gitignored ``native/build/libks_solver.so`` — rebuilt whenever the source is
newer — and exposes numpy-friendly wrappers.  Used as an independent golden
oracle and as the single-core host baseline in ``bench.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "ks_solver.cc")
_LIB = os.path.join(_ROOT, "native", "build", "libks_solver.so")

_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    base = ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB, _SRC]
    try:
        subprocess.run(base[:2] + ["-march=native"] + base[2:], check=True,
                       capture_output=True)
    except subprocess.CalledProcessError:
        subprocess.run(base, check=True)


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        _build()
    lib = ctypes.CDLL(_LIB)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.ks_control_period.argtypes = [
        dp, dp, dp, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int,
    ]
    lib.ks_control_period.restype = None
    lib.ks_rhs.argtypes = [dp, dp, dp, ctypes.c_int, ctypes.c_double]
    lib.ks_rhs.restype = None
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def ks_control_period(
    u: np.ndarray, phi: np.ndarray, dx: float, dt: float, cfg_steps: int,
    objective: str = "l2control",
) -> Tuple[np.ndarray, np.ndarray]:
    """Advance [B, N] (or [N]) fields one control period; returns (u, reward)."""
    lib = load()
    squeeze = u.ndim == 1
    u = np.ascontiguousarray(np.atleast_2d(u), np.float64).copy()
    phi = np.ascontiguousarray(
        np.broadcast_to(np.atleast_2d(phi), u.shape), np.float64
    ).copy()
    b, n = u.shape
    rewards = np.zeros(b, np.float64)
    obj = 0 if objective == "l2control" else 1
    lib.ks_control_period(
        _ptr(u), _ptr(phi), _ptr(rewards), b, n, dx, dt, cfg_steps, obj
    )
    if squeeze:
        return u[0], rewards[0]
    return u, rewards


def ks_rhs(u: np.ndarray, phi: np.ndarray, dx: float) -> np.ndarray:
    lib = load()
    u = np.ascontiguousarray(u, np.float64)
    phi = np.ascontiguousarray(phi, np.float64)
    out = np.zeros_like(u)
    lib.ks_rhs(_ptr(u), _ptr(phi), _ptr(out), u.shape[-1], dx)
    return out
