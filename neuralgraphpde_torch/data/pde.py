"""PDE dataset generators for the VMH, MP-PDE and GNO configurations
(counterparts of ``convection_diffusion_dataset``, ``burgers_dataset`` and
``darcy_dataset`` in ``neuralgraphpde.data.pde``): the same numpy and scipy
host code, so one seed gives both packages the same arrays (Burgers: the
same initial conditions, then a torch solve).

- 2-D convection-diffusion ``u_t = d Δu − v·∇u`` on a periodic [0, 2π]²
  domain, solved exactly in Fourier space on a fine grid and sampled at
  scattered points that a Delaunay graph connects.
- 1-D viscous Burgers on a periodic chain, pseudo-spectral RK4.
- Darcy flow with threshold-GRF coefficients, solved by 5-point finite
  differences on a grid that a radius graph connects.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..graph.builders import delaunay_graph, grid_graph_1d, radius_graph
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
class BurgersData:
    graph: GnnGraph  # 1-D stencil graph, ndata['x'] = positions (nx, 1)
    u: np.ndarray  # (num_sims, T, nx, 1)
    ts: np.ndarray  # (T,)
    nu: float


def burgers_dataset(
    num_sims: int = 32,
    nx: int = 256,
    t_end: float = 2.0,
    num_saves: int = 41,
    nu: float = 0.01,
    stencil: int = 2,
    seed: int = 0,
    substeps: int = 40,
    device=None,
) -> BurgersData:
    """1-D periodic viscous Burgers ``u_t + u u_x = ν u_xx`` on [0, 2π) (the
    MP-PDE configuration): pseudo-spectral, the nonlinear term dealiased at
    ``nx // 3``, RK4 with ``substeps`` steps per save interval, all sims in
    one batch. The initial conditions are sums of 2 to 5 low-frequency sines
    drawn from ``np.random.default_rng(seed)`` in the JAX package's order.
    The solve runs on ``device`` (default: the CPU) in complex64, as the JAX
    package's does with x64 off; its FFTs are another library's, so the
    arrays agree with JAX's to float rounding, not bit for bit."""
    import torch

    from ..ode.integrate import odeint_grid

    rng = np.random.default_rng(seed)
    freqs = np.fft.fftfreq(nx) * nx
    k = torch.as_tensor(freqs, dtype=torch.float32, device=device)
    ik = 1j * k
    dealias = torch.as_tensor(np.abs(freqs) < nx // 3, device=device)

    def rhs(t, u, args):
        u_hat = torch.fft.fft(u)
        conv_hat = 0.5 * ik * torch.fft.fft(u * u) * dealias
        visc_hat = -nu * (k ** 2) * u_hat
        return torch.fft.ifft(visc_hat - conv_hat).real

    ts = np.linspace(0.0, t_end, num_saves)
    x = np.linspace(0, 2 * np.pi, nx, endpoint=False)

    u0s = []
    for _ in range(num_sims):
        # random sum of low-frequency sines (Brandstetter-style init)
        u0 = np.zeros(nx)
        for _ in range(rng.integers(2, 6)):
            A = rng.uniform(-0.5, 0.5)
            kk = rng.integers(1, 4)
            phi = rng.uniform(0, 2 * np.pi)
            u0 += A * np.sin(kk * x + phi)
        u0s.append(u0)
    u0s = torch.as_tensor(np.stack(u0s).astype(np.float32).reshape(
        num_sims, nx), device=device)
    with torch.no_grad():
        u = odeint_grid(rhs, u0s, ts.astype(np.float32), solver="rk4",
                        steps_per_interval=substeps)  # (T, S, nx)
    u = u.transpose(0, 1).cpu().numpy()

    g = grid_graph_1d(nx, periodic=True, stencil=stencil,
                      ndata={"x": x.reshape(-1, 1).astype(np.float32)})
    return BurgersData(graph=g, u=u[..., None].astype(np.float32),
                       ts=ts.astype(np.float32), nu=nu)


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
