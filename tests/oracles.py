"""NumPy/SciPy oracle of the reference integrator for golden tests.

Implements exactly the scheme of
``/root/reference/pdegym/kuramoto/kuramoto.py`` (pre-flipped FD tables fed to
``scipy.ndimage.convolve1d(mode="wrap")``, RK4, per-sub-step reward) in plain
NumPy — the bar the JAX solver must match to <=1e-6 relative L2 over a full
episode (float64).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve1d

# Pre-flipped tables as the reference stores them (kuramoto.py:24-27).
FWD = [-1 / 4, 4 / 3, -3, 4, -25 / 12, 0, 0, 0, 0]
BWD = [0, 0, 0, 0, 25 / 12, -4, 3, -4 / 3, 1 / 4]
D2 = [1 / 90, -3 / 20, 3 / 2, -49 / 18, 3 / 2, -3 / 20, 1 / 90]
D4 = [7 / 240, -2 / 5, 169 / 60, -122 / 15, 91 / 8, -122 / 15, 169 / 60, -2 / 5, 7 / 240]


class KSOracle:
    def __init__(self, L=22.0, N=64, dt=1e-3, cfg_steps=250, objective="dissipation"):
        self.L, self.N, self.dt, self.cfg_steps = L, N, dt, cfg_steps
        self.dx = L / N
        self.objective = objective
        self.x = np.linspace(0.0, L - L / N, N)

    def rhs(self, u, phi):
        u_x_fwd = convolve1d(u**2, weights=FWD, mode="wrap") / self.dx
        u_x_bwd = convolve1d(u**2, weights=BWD, mode="wrap") / self.dx
        u_x = (u < 0) * u_x_fwd + (u >= 0) * u_x_bwd
        u_xx = convolve1d(u, weights=D2, mode="wrap") / self.dx**2
        u_xxxx = convolve1d(u, weights=D4, mode="wrap") / self.dx**4
        return -u_xxxx - u_xx - 0.5 * u_x + phi, (u_x, u_xx, u_xxxx)

    def reward(self, u, phi):
        if self.objective:  # truthy-string quirk -> l2control (kuramoto.py:72)
            return -np.sum(u**2) / self.N
        _, (u_x, u_xx, _) = self.rhs(u, phi)
        return -((u_xx**2).mean() + (u_x**2).mean() + (u * phi).mean())

    def control_period(self, u, phi):
        reward = 0.0
        for _ in range(self.cfg_steps):
            reward += self.reward(u, phi)
            k1, _ = self.rhs(u, phi)
            k2, _ = self.rhs(u + self.dt * k1 / 2.0, phi)
            k3, _ = self.rhs(u + self.dt * k2 / 2.0, phi)
            k4, _ = self.rhs(u + self.dt * k3, phi)
            u = u + self.dt * (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
        return u, reward / self.cfg_steps

    def forcing_matrix(self, Xi=(0.0, 0.25, 0.5, 0.75), sigma=0.4):
        xi = (self.L * np.asarray(Xi)).reshape(-1, 1)
        mat = np.exp(-((self.x - xi) ** 2) / (2.0 * sigma**2))
        return mat / np.sqrt(2.0 * np.pi * sigma)


class BurgersOracle:
    """Heun stepping with the BurgersPhyPDELoss stencils (phyloss.py:36-89).

    The physics-loss convolution is torch cross-correlation (no flip), so the
    taps are applied *unflipped* here.
    """

    D1 = np.array([-1 / 2, 0, 1 / 2])
    D2 = np.array([-1 / 12, 4 / 3, -5 / 2, 4 / 3, -1 / 12])

    def __init__(self, L=16.0, N=64, nu=0.05, dt=1e-3):
        self.L, self.N, self.nu, self.dt = L, N, nu, dt
        self.dx = L / N

    def _corr(self, u, taps):
        r = len(taps) // 2
        out = np.zeros_like(u)
        for j, c in enumerate(taps):
            out += c * np.roll(u, r - j, axis=-1)
        return out

    def rhs(self, u, phi):
        u_x = self._corr(u, self.D1) / self.dx
        u_xx = self._corr(u, self.D2) / self.dx**2
        return self.nu * u_xx - u * u_x + phi

    def heun(self, u, phi):
        utilde = u + 0.5 * self.dt * self.rhs(u, phi)
        return u + self.dt * self.rhs(utilde, phi)
