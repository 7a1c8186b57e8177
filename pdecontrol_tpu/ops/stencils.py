"""Finite-difference stencils as circulant matrices.

The reference solver (``/root/reference/pdegym/kuramoto/kuramoto.py:23-27,118-129``)
applies 1-D periodic finite-difference stencils with ``scipy.ndimage.convolve1d``.
``convolve1d`` is a true convolution, i.e. it flips the kernel, so the
reference stores *pre-flipped* one-sided (upwind) coefficient tables.  Here we
store the **effective cross-correlation taps** directly:

    out[i] = sum_d  taps[d] * u[(i + d) % N]

and materialise each stencil as an ``N x N`` circulant matrix ``D`` so that a
batch of fields ``U`` of shape ``[..., N]`` is differentiated with a single
matrix multiply ``U @ D.T`` — one batched product instead of a scalar
gather loop: at reference scale (``N = 64``) a fused ``[B, N] @ [N, kN]``
matmul covers the whole vectorised environment batch.

Coefficient values are standard finite-difference tables (math constants, also
listed in the reference at ``kuramoto.py:24-27`` and ``phyloss.py:39-40``).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Effective cross-correlation taps, keyed by offset d: out[i] += c_d * u[i+d].
# ---------------------------------------------------------------------------

#: One-sided forward first derivative (used as the upwind branch for u < 0).
#: Effective taps of the reference's pre-flipped FWD table (kuramoto.py:24).
FIRST_DERIV_UPWIND_FWD: Mapping[int, float] = {
    0: -25.0 / 12.0,
    1: 4.0,
    2: -3.0,
    3: 4.0 / 3.0,
    4: -1.0 / 4.0,
}

#: One-sided backward first derivative (upwind branch for u >= 0)
#: (kuramoto.py:25 after the convolve1d flip).
FIRST_DERIV_UPWIND_BWD: Mapping[int, float] = {
    0: 25.0 / 12.0,
    -1: -4.0,
    -2: 3.0,
    -3: -4.0 / 3.0,
    -4: 1.0 / 4.0,
}

#: Sixth-order central second derivative (kuramoto.py:26; symmetric, flip-safe).
SECOND_DERIV_CENTRAL_6: Mapping[int, float] = {
    -3: 1.0 / 90.0,
    -2: -3.0 / 20.0,
    -1: 3.0 / 2.0,
    0: -49.0 / 18.0,
    1: 3.0 / 2.0,
    2: -3.0 / 20.0,
    3: 1.0 / 90.0,
}

#: Sixth-order central fourth derivative (kuramoto.py:27; symmetric).
FOURTH_DERIV_CENTRAL_6: Mapping[int, float] = {
    -4: 7.0 / 240.0,
    -3: -2.0 / 5.0,
    -2: 169.0 / 60.0,
    -1: -122.0 / 15.0,
    0: 91.0 / 8.0,
    1: -122.0 / 15.0,
    2: 169.0 / 60.0,
    3: -2.0 / 5.0,
    4: 7.0 / 240.0,
}

#: Second-order central first derivative (Burgers physics loss, phyloss.py:39).
FIRST_DERIV_CENTRAL_2: Mapping[int, float] = {
    -1: -1.0 / 2.0,
    1: 1.0 / 2.0,
}

#: Fourth-order central second derivative (Burgers physics loss, phyloss.py:40).
SECOND_DERIV_CENTRAL_4: Mapping[int, float] = {
    -2: -1.0 / 12.0,
    -1: 4.0 / 3.0,
    0: -5.0 / 2.0,
    1: 4.0 / 3.0,
    2: -1.0 / 12.0,
}


def circulant(taps: Mapping[int, float], n: int, dtype=np.float64) -> np.ndarray:
    """Materialise periodic correlation taps as a dense circulant matrix.

    Returns ``D`` with ``(D @ u)[i] = sum_d taps[d] * u[(i + d) % n]``.
    """
    mat = np.zeros((n, n), dtype=np.float64)
    for d, c in taps.items():
        for i in range(n):
            mat[i, (i + d) % n] += c
    return mat.astype(dtype)


def taps_to_kernel(taps: Mapping[int, float], width: int | None = None) -> np.ndarray:
    """Return the taps as a dense centered correlation kernel array."""
    radius = max(abs(d) for d in taps)
    if width is None:
        width = 2 * radius + 1
    center = width // 2
    kernel = np.zeros(width, dtype=np.float64)
    for d, c in taps.items():
        kernel[center + d] = c
    return kernel


def apply_taps_numpy(u: np.ndarray, taps: Mapping[int, float]) -> np.ndarray:
    """Reference/oracle application of periodic taps via ``np.roll`` (last axis)."""
    out = np.zeros_like(u)
    for d, c in taps.items():
        out = out + c * np.roll(u, -d, axis=-1)
    return out


def derivative_matrix(
    taps: Mapping[int, float], n: int, dx: float, order: int, dtype=np.float64
) -> np.ndarray:
    """Circulant matrix scaled by ``dx**-order`` (matches ``convolve1d(...) / dx**k``)."""
    return (circulant(taps, n, dtype=np.float64) / dx**order).astype(dtype)


def stacked_matrix(
    taps_list: Sequence[Mapping[int, float]],
    n: int,
    scales: Sequence[float],
    dtype=np.float64,
) -> np.ndarray:
    """Stack several scaled stencil matrices into one ``[n, k*n]`` operator.

    ``U @ stacked`` evaluates all ``k`` derivatives in a single matmul; the
    outputs are concatenated along the last axis.  Note each block is the
    *transposed* circulant so that right-multiplication applies the stencil.
    """
    blocks = [
        (circulant(taps, n, dtype=np.float64) * s).T for taps, s in zip(taps_list, scales)
    ]
    return np.concatenate(blocks, axis=1).astype(dtype)
