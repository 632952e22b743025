"""PDE dataset generator for the VMH configuration (counterpart of
``convection_diffusion_dataset`` in ``neuralgraphpde.data.pde``): the same
numpy and scipy host code, so one seed gives both packages the same arrays.

2-D convection-diffusion ``u_t = d Δu − v·∇u`` on a periodic [0, 2π]²
domain, solved exactly in Fourier space on a fine grid and sampled at
scattered points that a Delaunay graph connects.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..graph.builders import delaunay_graph
from ..graph.gnngraph import GnnGraph


def _gaussian_random_field_2d(n: int, rng, scale: float = 4.0) -> np.ndarray:
    """Smooth periodic random field via spectral filtering."""
    k = np.fft.fftfreq(n) * n
    kx, ky = np.meshgrid(k, k, indexing="ij")
    k2 = kx ** 2 + ky ** 2
    amp = np.exp(-k2 / (2 * scale ** 2))
    noise = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    field = np.real(np.fft.ifft2(noise * amp))
    field -= field.mean()
    field /= np.abs(field).max() + 1e-12
    return field


@dataclasses.dataclass
class ConvectionDiffusionData:
    """One batch of simulations on a shared scattered-node graph."""

    graph: GnnGraph  # Delaunay graph with ndata['x'] = positions (M, 2)
    u: np.ndarray  # (num_sims, T, M, 1) solution snapshots
    ts: np.ndarray  # (T,) save times
    positions: np.ndarray  # (M, 2)


def convection_diffusion_dataset(
    num_sims: int = 24,
    num_points: int = 3000,
    grid_n: int = 128,
    t_end: float = 0.2,
    num_saves: int = 21,
    diffusivity: float = 0.25,
    velocity: Tuple[float, float] = (4.0, -4.0),
    seed: int = 0,
) -> ConvectionDiffusionData:
    """Shared scattered nodes over the periodic domain; exact spectral
    evolution of ``num_sims`` random initial fields, bilinearly sampled at
    the nodes at ``num_saves`` times over ``[0, t_end]``."""
    rng = np.random.default_rng(seed)
    L = 2 * np.pi
    pts = rng.uniform(0, L, size=(num_points, 2))

    k = np.fft.fftfreq(grid_n) * grid_n  # integer wavenumbers for L = 2π
    kx, ky = np.meshgrid(k, k, indexing="ij")
    sym = -diffusivity * (kx ** 2 + ky ** 2) - 1j * (
        velocity[0] * kx + velocity[1] * ky)
    ts = np.linspace(0.0, t_end, num_saves)

    from scipy.interpolate import RegularGridInterpolator

    axes = np.linspace(0, L, grid_n, endpoint=False)
    u_all = np.empty((num_sims, num_saves, num_points, 1), np.float32)
    for sidx in range(num_sims):
        u0 = _gaussian_random_field_2d(grid_n, rng)
        u0_hat = np.fft.fft2(u0)
        for tidx, t in enumerate(ts):
            u_t = np.real(np.fft.ifft2(u0_hat * np.exp(sym * t)))
            interp = RegularGridInterpolator(
                (axes, axes), u_t, bounds_error=False, fill_value=None,
                method="linear")
            u_all[sidx, tidx, :, 0] = interp(pts % L)

    g = delaunay_graph(pts, ndata={"x": pts.astype(np.float32)})
    return ConvectionDiffusionData(
        graph=g, u=u_all, ts=ts.astype(np.float32),
        positions=pts.astype(np.float32))
