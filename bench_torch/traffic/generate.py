"""The general traffic generator: inputs of one cell from its traffic
file's parameters and the run's seed. The same seed gives the same inputs;
every seed gives the same sizes.

Graphs (``graph.kind``):

- ``delaunay``: the Delaunay triangulation of ``points`` uniform random
  points in the unit square, every side in both directions; node ids are
  the points' random order, so the labels carry no locality.
- ``grid``: the ``nx`` × ``ny`` lattice, 8 neighbours with ``diagonals``
  (4 without), not periodic, nodes numbered row by row: the same graph for
  every seed.
- ``chung_lu``: ``edges`` draws of an edge whose two ends are drawn
  independently with probability proportional to an expected degree
  ``w_i ∝ i^(−1/(exponent − 1))`` (Chung and Lu), node ids shuffled;
  self-edges dropped, then made undirected without duplicates.

Node classification data (``task: train`` with ``features``): features
N(0, 1) of width ``features``, labels uniform over ``classes``, and
exactly ``train_nodes`` nodes in the train mask.

Fields (``field.kind: convdiff``): 2-D convection-diffusion ``u_t = d Δu −
v·∇u`` on the periodic square of side ``domain``, solved exactly in Fourier
space on a ``grid``² grid from smooth random initial fields (complex white
noise under a Gaussian filter of width ``scale``, mean removed, scaled to
a largest magnitude of 1: the sampler of the port's dataset), sampled
bilinearly (periodic) at ``points`` uniform random points that a Delaunay
triangulation connects. ``sims`` trajectories at the save times, or a pool
of ``pool`` initial fields. The mesh comes from the mix's ``mesh_seed`` where
it has one (the mesh a committed model was trained on), else from the run's
seed; the fields always come from the run's seed.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def streams(seed: int, count: int = 4):
    """``count`` independent 63-bit seeds derived from ``seed``."""
    state = np.random.SeedSequence(int(seed)).generate_state(count, np.uint64)
    return [int(s) >> 1 for s in state]


def torch_gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def delaunay_edges(points: np.ndarray):
    """Sorted unique ``(sender, receiver)`` pairs of every triangle side,
    both directions."""
    from scipy.spatial import Delaunay

    n = points.shape[0]
    tri = Delaunay(points).simplices.astype(np.int64)
    e = np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [0, 2]]])
    e = np.concatenate([e, e[:, ::-1]])
    key = np.unique(e[:, 0] * n + e[:, 1])
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def grid_edges(nx: int, ny: int, diagonals: bool):
    """Every lattice neighbour pair, both directions, sorted by receiver."""
    offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if diagonals:
        offsets += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ix, iy = ix.ravel(), iy.ravel()
    s, r = [], []
    for dx, dy in offsets:
        jx, jy = ix + dx, iy + dy
        keep = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
        s.append(jx[keep] * ny + jy[keep])
        r.append(ix[keep] * ny + iy[keep])
    s, r = np.concatenate(s), np.concatenate(r)
    order = np.lexsort((s, r))
    return s[order].astype(np.int32), r[order].astype(np.int32)


def chung_lu_edges(n: int, m: int, exponent: float, rng):
    w = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / (exponent - 1.0))
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    ends = np.searchsorted(cdf, rng.random((2, m)), side="right")
    ends = np.minimum(ends, n - 1)
    ids = rng.permutation(n)
    s, r = ids[ends[0]], ids[ends[1]]
    keep = s != r
    s, r = s[keep], r[keep]
    key = np.unique(np.concatenate([s * n + r, r * n + s]))
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def graph(spec: dict, rng):
    """``(num_nodes, senders, receivers)`` on the host."""
    kind = spec["kind"]
    if kind == "delaunay":
        pts = rng.random((spec["points"], 2))
        return (spec["points"], *delaunay_edges(pts))
    if kind == "grid":
        return (spec["nx"] * spec["ny"],
                *grid_edges(spec["nx"], spec["ny"], spec["diagonals"]))
    if kind == "chung_lu":
        return (spec["nodes"], *chung_lu_edges(spec["nodes"], spec["edges"],
                                               spec["exponent"], rng))
    raise ValueError(f"unknown graph kind {kind!r}")


def node_classification(traffic: dict, seed: int, device) -> dict:
    g_seed, d_seed = streams(seed)[:2]
    n, s, r = graph(traffic["graph"], np.random.default_rng(g_seed))
    gen = torch_gen(d_seed, device)
    x = torch.randn((n, traffic["features"]), generator=gen, device=device)
    y = torch.randint(0, traffic["classes"], (n,), generator=gen,
                      device=device)
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[torch.randperm(n, generator=gen, device=device)[
        :traffic["train_nodes"]]] = True
    return dict(num_nodes=n, senders=s, receivers=r, x=x, y=y, mask=mask,
                classes=traffic["classes"])


def _random_fields(count: int, n: int, scale: float, gen, device):
    k = torch.fft.fftfreq(n, device=device) * n
    kx, ky = torch.meshgrid(k, k, indexing="ij")
    amp = torch.exp(-(kx ** 2 + ky ** 2) / (2 * scale ** 2))
    re = torch.randn((count, n, n), generator=gen, device=device)
    im = torch.randn((count, n, n), generator=gen, device=device)
    field = torch.fft.ifft2(torch.complex(re, im) * amp).real
    field = field - field.mean(dim=(1, 2), keepdim=True)
    return field / (field.abs().amax(dim=(1, 2), keepdim=True) + 1e-12)


def _sample(fields: torch.Tensor, pts: torch.Tensor, domain: float):
    """Periodic bilinear values of ``(..., n, n)`` grids at ``(M, 2)``
    points: ``(..., M)``."""
    n = fields.shape[-1]
    g = pts / domain * n
    i0 = torch.floor(g).long()
    f = g - i0
    i0 = i0 % n
    i1 = (i0 + 1) % n
    v = lambda a, b: fields[..., a[:, 0], b[:, 1]]  # noqa: E731
    return ((1 - f[:, 0]) * (1 - f[:, 1]) * v(i0, i0)
            + f[:, 0] * (1 - f[:, 1]) * v(i1, i0)
            + (1 - f[:, 0]) * f[:, 1] * v(i0, i1)
            + f[:, 0] * f[:, 1] * v(i1, i1))


def convdiff(traffic: dict, seed: int, device, ts: Sequence[float]) -> dict:
    """The shared mesh, and ``u`` ``(sims, T, M, 1)`` trajectories at
    ``ts`` (``sims``) or ``fields`` ``(pool, M, 1)`` initial fields on the
    host (``pool``)."""
    spec = traffic["field"]
    d_seed = streams(seed)[1]
    g_seed = streams(traffic.get("mesh_seed", seed))[0]
    rng = np.random.default_rng(g_seed)
    domain, n = spec["domain"], spec["grid"]
    pts = rng.random((spec["points"], 2)) * domain
    s, r = delaunay_edges(pts)
    gen = torch_gen(d_seed, device)
    pos = torch.as_tensor(pts, dtype=torch.float32, device=device)
    out = dict(num_nodes=spec["points"], senders=s, receivers=r,
               pos=pts.astype(np.float32))
    if "pool" in traffic:
        fields = [_sample(_random_fields(c, n, spec["scale"], gen, device),
                          pos, domain)
                  for c in _chunks(traffic["pool"], 512)]
        out["fields"] = torch.cat(fields)[..., None].cpu()
        return out
    u0 = _random_fields(traffic["sims"], n, spec["scale"], gen, device)
    k = torch.fft.fftfreq(n, device=device) * n * (2 * math.pi / domain)
    kx, ky = torch.meshgrid(k, k, indexing="ij")
    d, (vx, vy) = spec["diffusivity"], spec["velocity"]
    sym = torch.complex(-d * (kx ** 2 + ky ** 2), -(vx * kx + vy * ky))
    u_hat = torch.fft.fft2(u0.to(torch.complex64))
    u = torch.stack([_sample(torch.fft.ifft2(u_hat * torch.exp(sym * t)).real,
                             pos, domain) for t in ts], dim=1)
    out["u"] = u[..., None].contiguous()
    return out


def _chunks(total: int, size: int):
    while total > 0:
        yield min(size, total)
        total -= size


def generate(traffic: dict, seed: int, device, **extra) -> dict:
    if "graph" in traffic:
        return node_classification(traffic, seed, device)
    if "field" in traffic:
        return convdiff(traffic, seed, device, **extra)
    raise ValueError("a traffic file names a graph or a field")
