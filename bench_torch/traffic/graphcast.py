"""GraphCast's graphs and synthetic 0.25° samples, for a traffic file with a
``graphcast`` block: the inputs of one cell from its parameters and the
run's seed. The graphs are the same for every seed; the samples are made on
the device in bulk from the seed. Nothing of the port is imported: the
builders below are this module's own numpy and scipy code, so the reference
and the port meet on the same graphs only if both build them right.

- The icosahedron as GraphCast's code lists it (its 12 vertices, its 20
  faces in its order), turned about y by ``(π − 2 asin(φ / √3)) / 2`` so
  that a face points at each pole; refined ``splits`` times, each face into
  four at its sides' midpoints pushed onto the unit sphere, new vertices
  appended in the order their sides first appear (face by face, sides
  ``ab``, ``bc``, ``ca``).
- The multimesh: the union of every level's sides, both directions.
- The grid: ``n_lat`` latitudes from −90° to 90°, ``n_lon`` longitudes from
  0°, latitude by latitude; ``(cos φ cos λ, cos φ sin λ, sin φ)``.
- Grid → mesh: every grid point within ``radius_fraction`` × the finest
  mesh's longest side (the 3-D chord) of a mesh vertex.
- Mesh → grid: the three vertices of the finest face whose cone from the
  centre holds the grid point (among the 8 faces with the nearest centres,
  then more; the one whose smallest barycentric coordinate is largest).
- Node features ``[cos φ, sin λ, cos λ]``; edge features ``[|d|, d] /
  max|d|``, ``d`` the sender's displacement from the receiver rotated by
  ``−λ_r`` about z and then by ``φ_r`` about y (the receiver's local
  frame). Edges sorted by receiver, then sender.
- Samples: ``samples`` inputs ``(grid points, inputs)`` and targets
  ``(grid points, targets)``, every channel N(0, 1) (ERA5 is not in the
  repository; the shapes and the work are the published ones).
- The loss's area weights: ``cos φ · sin(Δφ / 2)``, ``sin(Δφ / 4)²`` at
  the poles, over their mean (GraphCast's for a grid holding the poles).

The block gives the graphs' sizes (``mesh_nodes``, ``mesh_edges``,
``grid2mesh_edges``, ``mesh2grid_edges``): ``graphcast`` hands them on
without building a graph, and ``build_graphs`` stops on a graph of another
size.
"""
from __future__ import annotations

import numpy as np
import torch

from .generate import streams, torch_gen

CANDIDATES = 8  # nearest face centres tried first for each grid point
BLOCK = 1 << 17  # grid points a block of that search


def _icosahedron():
    p = (1.0 + np.sqrt(5.0)) / 2.0
    v = []
    for c1 in (1.0, -1.0):
        for c2 in (p, -p):
            v += [(c1, c2, 0.0), (0.0, c1, c2), (c2, 0.0, c1)]
    v = np.array(v, dtype=np.float64) / np.linalg.norm([1.0, p])
    f = np.array([[0, 1, 2], [0, 6, 1], [8, 0, 2], [8, 4, 0], [3, 8, 2],
                  [3, 2, 7], [7, 2, 1], [0, 4, 6], [4, 11, 6], [6, 11, 5],
                  [1, 5, 7], [4, 10, 11], [4, 8, 10], [10, 8, 3], [10, 3, 9],
                  [11, 10, 9], [11, 9, 5], [5, 9, 7], [9, 3, 7], [1, 6, 5]],
                 dtype=np.int64)
    t = (np.pi - 2.0 * np.arcsin(p / np.sqrt(3.0))) / 2.0
    turn = np.array([[np.cos(t), 0.0, np.sin(t)], [0.0, 1.0, 0.0],
                     [-np.sin(t), 0.0, np.cos(t)]])
    return v @ turn, f


def _split(v, f):
    """Every face into four; midpoints numbered by first appearance."""
    n = len(v)
    sides = f[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)
    lo, hi = sides.min(axis=1), sides.max(axis=1)
    key = lo * n + hi
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    mid = n + rank[inv.reshape(-1)].reshape(-1, 3)  # ab, bc, ca
    ends = np.stack([lo, hi], axis=1)[np.sort(first)]
    m = v[ends[:, 0]] + v[ends[:, 1]]
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    a, b, c = f[:, 0], f[:, 1], f[:, 2]
    ab, bc, ca = mid[:, 0], mid[:, 1], mid[:, 2]
    faces = np.stack([a, ab, ca, ab, b, bc, ca, bc, c, ab, bc, ca],
                     axis=1).reshape(-1, 3)
    return np.concatenate([v, m]), faces


def _sides(f):
    """Each side of ``f`` in both directions once, as ``(k, 2)``."""
    e = f[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)
    return np.unique(np.concatenate([e, e[:, ::-1]]), axis=0)


def _sorted(s, r):
    order = np.lexsort((s, r))
    return s[order].astype(np.int64), r[order].astype(np.int64)


def _lat_lon(xyz):
    lat = np.rad2deg(np.arcsin(np.clip(xyz[:, 2], -1.0, 1.0)))
    lon = np.rad2deg(np.arctan2(xyz[:, 1], xyz[:, 0])) % 360.0
    return lat, lon


def _node_feats(xyz):
    lat, lon = _lat_lon(xyz)
    phi, lam = np.deg2rad(lat), np.deg2rad(lon)
    return np.stack([np.cos(phi), np.sin(lam), np.cos(lam)],
                    axis=1).astype(np.float32)


def _edge_feats(sx, rx, s, r):
    ps, pr = sx[s], rx[r]
    lat, lon = _lat_lon(pr)
    phi, lam = np.deg2rad(lat), np.deg2rad(lon)
    d = ps - pr
    x1 = np.cos(lam) * d[:, 0] + np.sin(lam) * d[:, 1]
    y1 = -np.sin(lam) * d[:, 0] + np.cos(lam) * d[:, 1]
    x2 = np.cos(phi) * x1 + np.sin(phi) * d[:, 2]
    z2 = -np.sin(phi) * x1 + np.cos(phi) * d[:, 2]
    local = np.stack([x2, y1, z2], axis=1)
    length = np.linalg.norm(local, axis=1, keepdims=True)
    return (np.concatenate([length, local], axis=1)
            / length.max()).astype(np.float32)


def _containing(points, v, f):
    """The index into ``f`` of each point's containing face."""
    from scipy.spatial import cKDTree

    corners = v[f]
    solve = np.linalg.inv(np.transpose(corners, (0, 2, 1)))
    centre = corners.mean(axis=1)
    tree = cKDTree(centre / np.linalg.norm(centre, axis=1, keepdims=True))
    out = np.full(len(points), -1, np.int64)
    todo, k = np.arange(len(points)), CANDIDATES
    while len(todo):
        left = []
        for blk in np.array_split(todo, -(-len(todo) // BLOCK)):
            _, cand = tree.query(points[blk], k=min(k, len(f)))
            cand = cand.reshape(len(blk), -1)
            lam = np.einsum("nkij,nj->nki", solve[cand], points[blk])
            lam = lam / lam.sum(axis=2, keepdims=True)
            low = lam.min(axis=2)
            pick = low.argmax(axis=1)
            i = np.arange(len(blk))
            ok = low[i, pick] >= -1e-9
            out[blk[ok]] = cand[i, pick][ok]
            left.append(blk[~ok])
        todo = np.concatenate(left)
        if len(todo) and k >= len(f):
            raise RuntimeError("graphcast: a grid point in no face")
        k *= 4
    return out


def _grid_lat(spec: dict) -> np.ndarray:
    """Each grid point's latitude in degrees, latitude by latitude."""
    return np.repeat(np.linspace(-90.0, 90.0, spec["n_lat"]), spec["n_lon"])


def build_graphs(spec: dict) -> dict:
    """The mix's graphs on the host: ``mesh``, ``g2m``, ``m2g`` each
    ``(senders, receivers, edge features)``; ``mesh_x`` the mesh nodes'
    features; ``grid_lat`` and ``grid_lon`` in degrees."""
    v, f = _icosahedron()
    levels = [f]
    for _ in range(spec["splits"]):
        v, f = _split(v, f)
        levels.append(f)
    lat = _grid_lat(spec)
    lon = np.tile(np.arange(spec["n_lon"]) * (360.0 / spec["n_lon"]),
                  spec["n_lat"])
    phi, lam = np.deg2rad(lat), np.deg2rad(lon)
    grid = np.stack([np.cos(phi) * np.cos(lam), np.cos(phi) * np.sin(lam),
                     np.sin(phi)], axis=1)

    mesh = np.unique(np.concatenate([_sides(lf) for lf in levels]), axis=0)
    ms, mr = _sorted(mesh[:, 0], mesh[:, 1])

    from scipy.spatial import cKDTree

    fine = _sides(f)
    longest = np.linalg.norm(v[fine[:, 0]] - v[fine[:, 1]], axis=1).max()
    near = cKDTree(grid).query_ball_point(
        v, r=spec["radius_fraction"] * longest)
    gs = np.concatenate([np.asarray(h, np.int64) for h in near])
    gr = np.repeat(np.arange(len(v)), [len(h) for h in near])
    gs, gr = _sorted(gs, gr)

    face = _containing(grid, v, f)
    ds, dr = _sorted(f[face].reshape(-1),
                     np.repeat(np.arange(len(grid)), 3))

    out = dict(mesh=(ms, mr, _edge_feats(v, v, ms, mr)),
               g2m=(gs, gr, _edge_feats(grid, v, gs, gr)),
               m2g=(ds, dr, _edge_feats(v, grid, ds, dr)),
               mesh_x=_node_feats(v), grid_lat=lat, grid_lon=lon,
               num_mesh=len(v), num_grid=len(grid))
    sizes = dict(mesh_nodes=len(v), mesh_edges=len(ms),
                 grid2mesh_edges=len(gs), mesh2grid_edges=len(ds))
    for key, n in sizes.items():
        if spec.get(key) not in (None, n):
            raise ValueError(f"graphcast: {key} {n}, the mix gives "
                             f"{spec[key]}")
    return out


def area_weights(lat: np.ndarray) -> np.ndarray:
    rows = np.unique(lat)
    step = np.deg2rad(rows[1] - rows[0])
    w = np.cos(np.deg2rad(rows)) * np.sin(step / 2)
    w[0] = w[-1] = np.sin(step / 4) ** 2
    w = w[np.searchsorted(rows, lat)]
    return (w / w.mean()).astype(np.float32)


def graphcast(traffic: dict, seed: int, device) -> dict:
    """The mix's samples on ``device`` and its sizes, without its graphs
    (whoever needs them calls ``build_graphs``): ``inputs`` ``(samples,
    grid points, inputs)``, ``targets`` ``(samples, grid points,
    targets)``, float32 N(0, 1) from the seed; ``area_weight`` on
    ``device``; ``loss_nodes`` None (all grid points); ``num_grid`` and
    ``num_mesh``, and the edge counts ``mesh_edges``, ``grid2mesh_edges``
    and ``mesh2grid_edges`` as the block gives them."""
    spec, count = traffic["graphcast"], traffic["samples"]
    lat = _grid_lat(spec)
    n = len(lat)
    data = dict(num_grid=n, num_mesh=spec["mesh_nodes"],
                **{k: spec[k] for k in ("mesh_edges", "grid2mesh_edges",
                                        "mesh2grid_edges")})
    gen = torch_gen(streams(seed)[1], device)
    data["inputs"] = torch.randn((count, n, spec["inputs"]), generator=gen,
                                 device=device)
    data["targets"] = torch.randn((count, n, spec["targets"]),
                                  generator=gen, device=device)
    data["area_weight"] = torch.from_numpy(area_weights(lat)).to(device)
    data["loss_nodes"] = None
    return data
