"""PDE dataset generators for the VMH and GNO configurations (counterparts
of ``convection_diffusion_dataset`` and ``darcy_dataset`` in
``neuralgraphpde.data.pde``): the same numpy and scipy host code, so one
seed gives both packages the same arrays.

- 2-D convection-diffusion ``u_t = d Δu − v·∇u`` on a periodic [0, 2π]²
  domain, solved exactly in Fourier space on a fine grid and sampled at
  scattered points that a Delaunay graph connects.
- Darcy flow with threshold-GRF coefficients, solved by 5-point finite
  differences on a grid that a radius graph connects.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..graph.builders import delaunay_graph, radius_graph
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


@dataclasses.dataclass
class DarcyData:
    graph: GnnGraph  # radius graph over grid nodes
    a: np.ndarray  # (num_samples, M, 1) coefficient fields
    u: np.ndarray  # (num_samples, M, 1) solutions
    positions: np.ndarray  # (M, 2)


def darcy_dataset(
    num_samples: int = 32,
    n: int = 32,
    radius: float = 0.08,
    a_low: float = 3.0,
    a_high: float = 12.0,
    seed: int = 0,
) -> DarcyData:
    """Darcy flow ``−∇·(a∇u) = f`` on the unit square (the GNO
    configuration): threshold-GRF coefficients, f ≡ 1, homogeneous Dirichlet
    boundary, 5-point finite differences on the ``n × n`` interior grid,
    whose nodes a radius graph connects."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(seed)
    h = 1.0 / (n + 1)
    xs = np.linspace(h, 1 - h, n)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)
    M = n * n

    a_all = np.empty((num_samples, M, 1), np.float32)
    u_all = np.empty((num_samples, M, 1), np.float32)

    def idx(i, j):
        return i * n + j

    for sidx in range(num_samples):
        grf = _gaussian_random_field_2d(n, rng, scale=3.0)
        a = np.where(grf > 0, a_high, a_low)

        rows, cols, vals = [], [], []
        b = np.full(M, 1.0)
        for i in range(n):
            for j in range(n):
                c = idx(i, j)
                diag = 0.0
                for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    ii, jj = i + di, j + dj
                    if 0 <= ii < n and 0 <= jj < n:
                        aa = 0.5 * (a[i, j] + a[ii, jj])
                        rows.append(c)
                        cols.append(idx(ii, jj))
                        vals.append(-aa / h ** 2)
                        diag += aa / h ** 2
                    else:
                        diag += a[i, j] / h ** 2  # Dirichlet ghost
                rows.append(c)
                cols.append(c)
                vals.append(diag)
        A = sp.csr_matrix((vals, (rows, cols)), shape=(M, M))
        u = spla.spsolve(A, b)
        a_all[sidx, :, 0] = a.reshape(-1)
        u_all[sidx, :, 0] = u

    g = radius_graph(pts, radius,
                     ndata={"x": pts.astype(np.float32)})
    return DarcyData(graph=g, a=a_all, u=u_all,
                     positions=pts.astype(np.float32))
