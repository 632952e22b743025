"""Darcy flow samples on a radius graph over a grid, for a traffic file with
a ``darcy`` block: the inputs of one cell from its parameters and the run's
seed, made on the device in bulk. The same seed gives the same inputs;
every seed gives the same sizes.

- The coefficient: a Gaussian random field with covariance ``(−Δ + τ²
  I)^(−α)`` under zero Neumann conditions (a cosine series, every mode's
  coefficient ``τ^(α−1) (π² |k|² + τ²)^(−α/2)`` times a standard normal,
  the constant mode dropped), thresholded to ``a_high`` where it is at
  least 0 and ``a_low`` elsewhere, on the ``fine`` grid of the unit square
  (spacing ``1 / (fine − 1)``, the boundary included).
- The solution of ``−∇·(a ∇u) = 1`` with ``u = 0`` on the boundary: the
  5-point finite-difference scheme on the fine grid (a face's coefficient
  the mean of its two nodes'), solved by conjugate gradients with a
  diagonal preconditioner in float64 to a relative residual of ``cg_tol``.
- The smoothed coefficient ``a_ε``: ``a`` under a Gaussian filter of
  standard deviation ``smooth`` (in units of the domain) on the fine grid,
  reflected at the boundary; its gradient by central differences (one-sided
  on the boundary).
- Every ``sub``-th point of the fine grid in each direction is kept: the
  ``points`` × ``points`` grid, nodes numbered row by row (``x`` first).
- Each input channel and the target are normalized point by point over the
  mix's ``samples``: ``(v − mean) / (std + 1e-5)`` (the sample standard
  deviation).
- The graph joins every node to every node within ``radius`` (in units of
  the domain, by the float64 distance ``sqrt(dx² + dy²)`` between
  ``np.linspace`` points), the node itself included: both
  directions, sorted by receiver. Where the block gives ``edges``, a graph
  of another size stops the run.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .generate import streams, torch_gen

EPS = 1e-5  # the normalization's guard against a point that never varies


def ball_edges(points: int, radius: float):
    """``(senders, receivers)``: every pair of nodes of the ``points``²
    grid whose distance is at most ``radius``, self-loops included, sorted
    by receiver then sender. The coordinates are ``np.linspace(0, 1,
    points)`` and the distance ``sqrt(dx² + dy²)`` in float64, so a pair
    that lies ``radius`` apart on the lattice is kept or dropped by how its
    coordinates round (at 61 points and radius 0.1: 383,293 of the 386,221
    pairs within 6 lattice steps)."""
    xs = np.linspace(0.0, 1.0, points)
    reach = int(math.ceil(radius * (points - 1))) + 1  # lattice steps
    ix, iy = np.meshgrid(np.arange(points), np.arange(points), indexing="ij")
    ix, iy = ix.ravel(), iy.ravel()
    s, r = [], []
    for dx in range(-reach, reach + 1):
        for dy in range(-reach, reach + 1):
            jx, jy = ix + dx, iy + dy
            keep = (jx >= 0) & (jx < points) & (jy >= 0) & (jy < points)
            kx, ky, jx, jy = ix[keep], iy[keep], jx[keep], jy[keep]
            near = np.sqrt((xs[jx] - xs[kx]) ** 2
                           + (xs[jy] - xs[ky]) ** 2) <= radius
            s.append(jx[near] * points + jy[near])
            r.append(kx[near] * points + ky[near])
    s, r = np.concatenate(s), np.concatenate(r)
    order = np.lexsort((s, r))
    return s[order].astype(np.int32), r[order].astype(np.int32)


def coefficient(spec: dict, count: int, gen, device) -> torch.Tensor:
    """``count`` thresholded fields ``(count, fine, fine)`` in float64."""
    n, alpha, tau = spec["fine"], spec["alpha"], spec["tau"]
    k = torch.arange(n, dtype=torch.float64, device=device)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    coef = tau ** (alpha - 1) * (math.pi ** 2 * k2 + tau ** 2) ** (
        -alpha / 2)
    coef[0, 0] = 0.0
    xi = torch.randn((count, n, n), generator=gen, device=device,
                     dtype=torch.float64)
    x = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=device)
    basis = torch.cos(math.pi * x[:, None] * k[None, :])  # (point, mode)
    field = basis @ (xi * coef) @ basis.T
    return torch.where(field >= 0, spec["a_high"], spec["a_low"]).to(
        torch.float64)


def _faces(a: torch.Tensor):
    """The faces' coefficients along x ``(S, n − 1, n)`` and y ``(S, n, n −
    1)``: the mean of the two nodes'."""
    return 0.5 * (a[:, 1:, :] + a[:, :-1, :]), 0.5 * (a[:, :, 1:]
                                                      + a[:, :, :-1])


def _operator(u, ax, ay, inv_h2, interior):
    """``−∇·(a ∇u)`` by the 5-point scheme at the interior nodes (0 on the
    boundary)."""
    fx = ax * (u[:, 1:, :] - u[:, :-1, :])
    fy = ay * (u[:, :, 1:] - u[:, :, :-1])
    out = torch.zeros_like(u)
    out[:, :-1, :] -= fx
    out[:, 1:, :] += fx
    out[:, :, :-1] -= fy
    out[:, :, 1:] += fy
    return out * inv_h2 * interior


def solve(a: torch.Tensor, tol: float, max_iter: int = 20000,
          check_every: int = 25) -> torch.Tensor:
    """``u`` with ``−∇·(a ∇u) = 1`` inside, 0 on the boundary, on the fine
    grid of ``a`` ``(S, n, n)``: preconditioned conjugate gradients, all
    samples together, each to ``|r| ≤ tol · |b|``."""
    n = a.shape[-1]
    inv_h2 = float((n - 1) ** 2)
    interior = torch.zeros_like(a[:1])
    interior[:, 1:-1, 1:-1] = 1.0
    ax, ay = _faces(a)
    diag = torch.zeros_like(a)
    diag[:, :-1, :] += ax
    diag[:, 1:, :] += ax
    diag[:, :, :-1] += ay
    diag[:, :, 1:] += ay
    inv_diag = interior / (diag * inv_h2)
    b = interior.expand_as(a).clone()
    u = torch.zeros_like(a)
    r = b.clone()
    z = r * inv_diag
    p = z.clone()
    rz = (r * z).sum(dim=(1, 2), keepdim=True)
    goal = tol * b.flatten(1).norm(dim=1)
    for it in range(max_iter):
        ap = _operator(p, ax, ay, inv_h2, interior)
        alpha = rz / (p * ap).sum(dim=(1, 2), keepdim=True)
        u = u + alpha * p
        r = r - alpha * ap
        if it % check_every == 0 and bool(
                (r.flatten(1).norm(dim=1) <= goal).all()):
            return u
        z = r * inv_diag
        rz_new = (r * z).sum(dim=(1, 2), keepdim=True)
        p = z + (rz_new / rz) * p
        rz = rz_new
    raise RuntimeError(f"Darcy solve: no convergence in {max_iter} steps")


def smooth(a: torch.Tensor, sigma: float) -> torch.Tensor:
    """``a`` ``(S, n, n)`` under a separable Gaussian filter of standard
    deviation ``sigma`` (units of the domain), reflected at the
    boundary."""
    n = a.shape[-1]
    s = sigma * (n - 1)  # in grid steps
    half = max(1, int(math.ceil(3 * s)))
    t = torch.arange(-half, half + 1, dtype=a.dtype, device=a.device)
    w = torch.exp(-0.5 * (t / s) ** 2)
    w = (w / w.sum()).view(1, 1, -1)
    out = a
    for dim in (1, 2):
        x = out.movedim(dim, -1)
        shape = x.shape
        x = x.reshape(-1, 1, n)
        x = torch.nn.functional.pad(x, (half, half), mode="reflect")
        x = torch.nn.functional.conv1d(x, w).reshape(shape)
        out = x.movedim(-1, dim)
    return out


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """``(v − mean) / (std + EPS)`` point by point over the samples (dim
    0)."""
    return (v - v.mean(dim=0)) / (v.std(dim=0) + EPS)


def darcy(traffic: dict, seed: int, device) -> dict:
    """The mix's graph and samples: ``feats`` ``(S, N, 6)`` = ``[x, y, a,
    a_ε, ∂x a_ε, ∂y a_ε]`` (positions as they are, the rest normalized),
    ``a`` ``(S, N, 1)`` (normalized) and ``y`` ``(S, N, 1)`` (the
    normalized solution), float32 on ``device``; ``pos`` ``(N, 2)``; the
    graph's ``senders`` and ``receivers`` on the host."""
    spec, count = traffic["darcy"], traffic["samples"]
    points, sub = spec["points"], spec["sub"]
    if spec["fine"] != (points - 1) * sub + 1:
        raise ValueError("darcy: fine must be (points − 1) · sub + 1")
    gen = torch_gen(streams(seed)[1], device)
    a = coefficient(spec, count, gen, device)
    u = solve(a, spec["cg_tol"])
    a_eps = smooth(a, spec["smooth"])
    gx, gy = torch.gradient(a_eps, spacing=1.0 / (spec["fine"] - 1),
                            dim=(1, 2))
    keep = (slice(None), slice(None, None, sub), slice(None, None, sub))
    chans = [c[keep].reshape(count, -1) for c in (a, a_eps, gx, gy, u)]
    a_n, ae_n, gx_n, gy_n, y = (_normalize(c) for c in chans)
    xs = torch.from_numpy(np.linspace(0.0, 1.0, points)).to(device)
    pos = torch.stack(torch.meshgrid(xs, xs, indexing="ij"), -1).reshape(
        -1, 2)
    feats = torch.cat([pos.expand(count, -1, -1)]
                      + [c[..., None] for c in (a_n, ae_n, gx_n, gy_n)],
                      dim=-1)
    s, r = ball_edges(points, spec["radius"])
    if spec.get("edges") not in (None, len(s)):
        raise ValueError(f"darcy: {len(s)} edges, the mix gives "
                         f"{spec['edges']}")
    f32 = dict(dtype=torch.float32)
    return dict(num_nodes=points * points, senders=s, receivers=r,
                pos=pos.to(**f32).contiguous(),
                feats=feats.to(**f32).contiguous(),
                a=a_n[..., None].to(**f32).contiguous(),
                y=y[..., None].to(**f32).contiguous(), loss_nodes=None)
