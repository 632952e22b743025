"""Graph constructors (host numpy), the same code as
``neuralgraphpde.graph.builders`` so both packages build identical arrays
from one seed."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .gnngraph import GnnGraph


def rand_graph(
    num_nodes: int,
    num_edges: int,
    *,
    bidirected: bool = False,
    seed: Optional[int] = None,
    **features,
) -> GnnGraph:
    """Random COO graph with ``num_edges`` directed edges (no dedup)."""
    rng = np.random.default_rng(seed)
    if num_nodes == 0 or num_edges == 0:
        return GnnGraph.from_coo(
            np.zeros(0, np.int32), np.zeros(0, np.int32),
            num_nodes=num_nodes, **features,
        )
    if bidirected:
        if num_edges % 2 != 0:
            raise ValueError("bidirected rand_graph needs an even num_edges")
        half = num_edges // 2
        s = rng.integers(0, num_nodes, size=half)
        t = rng.integers(0, num_nodes, size=half)
        senders = np.concatenate([s, t])
        receivers = np.concatenate([t, s])
    else:
        senders = rng.integers(0, num_nodes, size=num_edges)
        receivers = rng.integers(0, num_nodes, size=num_edges)
    return GnnGraph.from_coo(
        senders.astype(np.int32), receivers.astype(np.int32),
        num_nodes=num_nodes, **features,
    )


def grid_graph_1d(n: int, *, periodic: bool = False, stencil: int = 1,
                  **features) -> GnnGraph:
    """1-D chain with ``stencil`` neighbours each side (the MP-PDE Burgers
    mesh); edges in receiver order, each receiver's senders from
    ``-stencil`` to ``+stencil``."""
    s_list, t_list = [], []
    for i in range(n):
        for off in range(-stencil, stencil + 1):
            if off == 0:
                continue
            j = i + off
            if periodic:
                j %= n
            elif not (0 <= j < n):
                continue
            s_list.append(j)
            t_list.append(i)
    return GnnGraph.from_coo(
        np.asarray(s_list, np.int32), np.asarray(t_list, np.int32),
        num_nodes=n, **features,
    )


def grid_graph_2d(nx: int, ny: int, *, periodic: bool = False,
                  diagonals: bool = False, **features) -> GnnGraph:
    """2-D lattice, 4- or 8-neighborhood, bidirected, receiver-sorted."""
    offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if diagonals:
        offsets += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ix = ix.ravel()
    iy = iy.ravel()
    s_parts, t_parts = [], []
    for dx, dy in offsets:
        jx, jy = ix + dx, iy + dy
        if periodic:
            jx, jy = jx % nx, jy % ny
            keep = slice(None)
        else:
            keep = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
        s_parts.append((jx[keep] * ny + jy[keep]).astype(np.int32))
        t_parts.append((ix[keep] * ny + iy[keep]).astype(np.int32))
    s = np.concatenate(s_parts)
    t = np.concatenate(t_parts)
    order = np.argsort(t, kind="stable")
    return GnnGraph.from_coo(
        s[order], t[order], num_nodes=nx * ny, **features,
    )


def radius_graph(
    points: np.ndarray,
    radius: float,
    *,
    loop: bool = False,
    max_degree: Optional[int] = None,
    **features,
) -> GnnGraph:
    """Connect all point pairs within ``radius`` (the GNO Darcy
    configuration's graph), both directions; ``loop`` adds self-loops and
    ``max_degree`` keeps each receiver's nearest in-edges. ``points``:
    (n, d). Uses a KD-tree."""
    from scipy.spatial import cKDTree

    points = np.asarray(points)
    tree = cKDTree(points)
    pairs = tree.query_pairs(radius, output_type="ndarray")  # (m, 2), i < j
    s = np.concatenate([pairs[:, 0], pairs[:, 1]])
    t = np.concatenate([pairs[:, 1], pairs[:, 0]])
    if loop:
        idx = np.arange(points.shape[0])
        s = np.concatenate([s, idx])
        t = np.concatenate([t, idx])
    if max_degree is not None:
        # Keep at most max_degree in-edges per receiver (nearest first).
        dist = np.linalg.norm(points[s] - points[t], axis=1)
        order = np.lexsort((dist, t))
        s, t, dist = s[order], t[order], dist[order]
        keep = np.zeros(len(t), dtype=bool)
        start = 0
        for i in range(len(t)):
            if i == 0 or t[i] != t[i - 1]:
                start = i
            keep[i] = (i - start) < max_degree
        s, t = s[keep], t[keep]
    return GnnGraph.from_coo(
        s.astype(np.int32), t.astype(np.int32),
        num_nodes=points.shape[0], **features,
    )


def delaunay_graph(points: np.ndarray, *, bidirected: bool = True,
                   **features) -> GnnGraph:
    """Delaunay triangulation edges (the VMH configuration's scattered-node
    mesh): every simplex side, sorted unique ``(sender, receiver)`` pairs,
    both directions when ``bidirected``."""
    from scipy.spatial import Delaunay

    points = np.asarray(points)
    tri = Delaunay(points)
    edges = set()
    for simplex in tri.simplices:
        m = len(simplex)
        for a in range(m):
            for b in range(a + 1, m):
                i, j = int(simplex[a]), int(simplex[b])
                edges.add((i, j))
                if bidirected:
                    edges.add((j, i))
    edges = sorted(edges)
    s = np.asarray([e[0] for e in edges], np.int32)
    t = np.asarray([e[1] for e in edges], np.int32)
    return GnnGraph.from_coo(s, t, num_nodes=points.shape[0], **features)
