"""Bandwidth-reducing node reorderings (counterpart of
``neuralgraphpde.graph.reorder``; the numpy code is the JAX package's, so
both give the same integer orders).

The block-band SpMM paths (``ops/bsr.py``) only pay off when the adjacency
is block-banded: every edge's ``|receiver − sender|`` must be small relative
to the block size. Grids already are; Delaunay and radius meshes with
scrambled labels are not until the nodes are renumbered:

- ``rcm_order``    — reverse Cuthill–McKee: BFS from a pseudo-peripheral
                     vertex, neighbours visited in degree order, sequence
                     reversed.
- ``morton_order`` — sort by the Morton (Z-curve) code of quantized
                     coordinates.

``reorder_graph`` relabels a ``GnnGraph``; external per-node arrays follow
with ``permute_nodes`` and outputs go back with ``unpermute_nodes`` (numpy
arrays or torch tensors).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .gnngraph import GnnGraph
from .transforms import host_edges, sort_by_receiver


def _adjacency_csr(senders: np.ndarray, receivers: np.ndarray,
                   num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected adjacency in CSR (offsets, cols), deduplicated."""
    s = np.concatenate([senders, receivers]).astype(np.int64)
    r = np.concatenate([receivers, senders]).astype(np.int64)
    keep = s != r
    s, r = s[keep], r[keep]
    key = np.unique(s * num_nodes + r)
    rows = (key // num_nodes).astype(np.int64)
    cols = (key % num_nodes).astype(np.int64)
    offsets = np.zeros(num_nodes + 1, np.int64)
    np.add.at(offsets, rows + 1, 1)
    np.cumsum(offsets, out=offsets)
    return offsets, cols


def rcm_order(senders, receivers, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill–McKee ordering. Returns ``order`` with ``order[new] =
    old``: node ``order[k]`` gets new id ``k``. Disconnected components are
    processed smallest-degree-first."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    offsets, cols = _adjacency_csr(senders, receivers, num_nodes)
    deg = np.diff(offsets)
    visited = np.zeros(num_nodes, bool)
    order = np.empty(num_nodes, np.int64)
    pos = 0
    # component seeds in ascending degree (classic Cuthill–McKee start)
    seeds = np.argsort(deg, kind="stable")
    for seed in seeds:
        if visited[seed]:
            continue
        # pseudo-peripheral refinement: hop to a min-degree vertex of the
        # last BFS level twice (George–Liu)
        start = int(seed)
        for _ in range(2):
            seen = np.zeros(num_nodes, bool)
            seen[start] = True
            level = np.array([start], np.int64)
            last = level
            while level.size:
                counts = offsets[level + 1] - offsets[level]
                nbr = np.concatenate(
                    [cols[offsets[u]:offsets[u + 1]] for u in level]
                ) if counts.sum() else np.empty(0, np.int64)
                nbr = np.unique(nbr[~seen[nbr]]) if nbr.size else nbr
                if nbr.size:
                    seen[nbr] = True
                    last = nbr
                level = nbr
            start = int(last[np.argmin(deg[last])])
        # Cuthill–McKee BFS from `start`
        visited[start] = True
        order[pos] = start
        pos += 1
        head = pos - 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = cols[offsets[u]:offsets[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos:pos + nbrs.size] = nbrs
                pos += nbrs.size
    assert pos == num_nodes
    return order[::-1].copy()  # the "reverse" in RCM


def morton_order(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Z-curve ordering of 1-D/2-D/3-D points; ``order[new] = old``."""
    pts = np.asarray(points, np.float64)
    if pts.ndim == 1:
        pts = pts[:, None]
    lo = pts.min(axis=0)
    span = np.maximum(pts.max(axis=0) - lo, 1e-30)
    q = ((pts - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    d = pts.shape[1]
    code = np.zeros(len(pts), np.uint64)
    for b in range(bits):
        for axis in range(d):
            code |= ((q[:, axis] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * d + axis)
    return np.argsort(code, kind="stable")


def bandwidth(senders, receivers) -> int:
    """Max ``|receiver − sender|`` over the edges (matrix bandwidth)."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    if s.size == 0:
        return 0
    return int(np.abs(r - s).max())


def reorder_graph(g: GnnGraph, order: np.ndarray,
                  return_edge_perm: bool = False):
    """Relabel nodes so old node ``order[k]`` becomes new node ``k``.

    ndata rows are permuted; edata and gdata are kept (edges keep their
    identity, endpoints are relabeled); the result is receiver-sorted. The
    receiver sort permutes the edges: ``return_edge_perm=True`` also returns
    that permutation (new edge slot ``k`` holds old edge ``perm[k]``), so
    per-edge arrays can be realigned. The graph stays on ``g``'s device.
    """
    order = np.asarray(order, np.int64)
    if order.shape != (g.num_nodes,):
        raise ValueError(f"order must have shape ({g.num_nodes},)")
    inv = np.empty_like(order)
    inv[order] = np.arange(g.num_nodes, dtype=np.int64)
    s, r = host_edges(g)
    new_s = inv[s.astype(np.int64)].astype(np.int32)
    new_r = inv[r.astype(np.int64)].astype(np.int32)
    gi = g.graph_indicator
    if gi is not None:
        gi = permute_nodes(gi, order)
    g2 = GnnGraph.from_coo(
        new_s, new_r, num_nodes=g.num_nodes,
        ndata={k: permute_nodes(v, order) for k, v in g.ndata.items()},
        edata=dict(g.edata), gdata=dict(g.gdata),
        num_graphs=g.num_graphs, graph_indicator=gi)
    if g.device.type != "cpu":
        g2 = g2.to(g.device)
    if return_edge_perm:
        g3, eperm = sort_by_receiver(g2, return_perm=True)
        return g3, np.asarray(eperm)
    return sort_by_receiver(g2)


def _index(order: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(order, np.int64), device=like.device)


def permute_nodes(x, order: np.ndarray):
    """Reorder a per-node array (numpy or torch) into the new numbering
    (``x[order]``)."""
    if isinstance(x, np.ndarray):
        return x[np.asarray(order)]
    return x.index_select(0, _index(order, x))


def unpermute_nodes(y, order: np.ndarray):
    """Map a per-node array (numpy or torch) back to the original
    numbering."""
    order = np.asarray(order, np.int64)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=np.int64)
    if isinstance(y, np.ndarray):
        return y[inv]
    return y.index_select(0, _index(inv, y))


def rcm_reorder(g: GnnGraph) -> Tuple[GnnGraph, np.ndarray]:
    """RCM-renumber ``g``; returns ``(graph, order)``."""
    s, r = host_edges(g)
    order = rcm_order(s, r, g.num_nodes)
    return reorder_graph(g, order), order


def spatial_reorder(g: GnnGraph, points: Optional[np.ndarray] = None,
                    ) -> Tuple[GnnGraph, np.ndarray]:
    """Morton-renumber ``g`` by node positions (default ``ndata['x']``)."""
    if points is None:
        if "x" not in g.ndata:
            raise ValueError("spatial_reorder needs points or g.ndata['x']")
        points = g.ndata["x"].cpu().numpy()
    order = morton_order(points)
    return reorder_graph(g, order), order
