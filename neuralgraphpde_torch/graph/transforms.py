"""Structural graph transforms: self-loops, degree, CSR offsets, receiver
sort, dense adjacency (counterparts of ``neuralgraphpde.graph.transforms``),
and blocks of receivers (``receiver_blocks``, which the JAX package does not
have).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .gnngraph import GnnGraph


def host_edges(g: GnnGraph):
    """``(senders, receivers)`` as numpy, from ``host_coo`` when kept."""
    if g.host_coo is not None:
        return g.host_coo
    return g.senders.cpu().numpy(), g.receivers.cpu().numpy()


def add_self_loops(g: GnnGraph) -> GnnGraph:
    """Append one ``i -> i`` edge per node, after the existing edges. Edge
    features are dropped."""
    n = g.num_nodes
    loop = torch.arange(n, dtype=torch.int32, device=g.device)
    host_coo = None
    if g.host_coo is not None:
        loop_np = np.arange(n, dtype=np.int32)
        host_coo = (np.concatenate([g.host_coo[0], loop_np]),
                    np.concatenate([g.host_coo[1], loop_np]))
    return GnnGraph(
        senders=torch.cat([g.senders, loop]),
        receivers=torch.cat([g.receivers, loop]),
        ndata=g.ndata, edata={}, gdata=g.gdata,
        graph_indicator=g.graph_indicator, num_nodes=n,
        num_edges=g.num_edges + n, num_graphs=g.num_graphs,
        receivers_sorted=False, host_coo=host_coo)


def degree(g: GnnGraph, dtype=torch.float32, *, direction: str = "in",
           edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Weighted) degree vector ``(num_nodes,)``: edges counted by receiver
    (``direction='in'``) or sender."""
    idx = g.receivers if direction == "in" else g.senders
    if edge_weight is None:
        weights = torch.ones(g.num_edges, dtype=dtype, device=g.device)
    else:
        weights = edge_weight.to(dtype)
    out = torch.zeros(g.num_nodes, dtype=dtype, device=weights.device)
    return out.index_add_(0, idx.to(weights.device), weights)


def sort_by_receiver(g: GnnGraph, return_perm: bool = False):
    """Stable-sort edges by receiver (CSR order); edge features follow.
    ``return_perm`` also returns the numpy permutation (new slot ``k`` holds
    old edge ``perm[k]``)."""
    if g.receivers_sorted:
        return (g, np.arange(g.num_edges)) if return_perm else g
    if g.num_edges == 0:
        g2 = g.replace(receivers_sorted=True)
        return (g2, np.arange(0)) if return_perm else g2
    host_coo = None
    if g.host_coo is not None:
        s_np, r_np = g.host_coo
        perm_np = np.argsort(r_np, kind="stable")
        host_coo = (s_np[perm_np], r_np[perm_np])
        senders = torch.from_numpy(host_coo[0].copy()).to(g.device)
        receivers = torch.from_numpy(host_coo[1].copy()).to(g.device)
    else:
        perm_t = torch.argsort(g.receivers, stable=True)
        perm_np = perm_t.cpu().numpy()
        senders, receivers = g.senders[perm_t], g.receivers[perm_t]
    perm = torch.from_numpy(perm_np)
    g2 = GnnGraph(
        senders=senders, receivers=receivers, ndata=g.ndata,
        edata={k: v[perm.to(v.device)] for k, v in g.edata.items()},
        gdata=g.gdata, graph_indicator=g.graph_indicator,
        num_nodes=g.num_nodes, num_edges=g.num_edges,
        num_graphs=g.num_graphs, receivers_sorted=True, host_coo=host_coo,
        num_senders=g.num_senders)
    return (g2, perm_np) if return_perm else g2


def csr_offsets(g: GnnGraph) -> torch.Tensor:
    """Row offsets ``(num_nodes + 1,)`` int32 of a receiver-sorted graph."""
    if not g.receivers_sorted:
        raise ValueError("csr_offsets requires a receiver-sorted graph; "
                         "call sort_by_receiver(g) first")
    counts = torch.bincount(g.receivers.to(torch.int64),
                            minlength=g.num_nodes)
    zero = torch.zeros(1, dtype=torch.int32, device=g.device)
    return torch.cat([zero, torch.cumsum(counts, 0).to(torch.int32)])


def to_dense_adjacency(g: GnnGraph, *,
                       edge_weight: Optional[torch.Tensor] = None,
                       dtype=torch.float32) -> torch.Tensor:
    """Dense ``A[r, s] = Σ weights of edges s -> r``, so ``A @ X`` is the
    receiver sum of sender features."""
    n = g.num_nodes
    w = (torch.ones(g.num_edges, dtype=dtype, device=g.device)
         if edge_weight is None else edge_weight.to(dtype))
    flat = g.receivers.to(torch.int64) * n + g.senders.to(torch.int64)
    dense = torch.zeros(n * n, dtype=dtype, device=w.device)
    return dense.index_add_(0, flat.to(w.device), w).reshape(n, n)


@dataclasses.dataclass(frozen=True)
class ReceiverBlocks:
    """A receiver-sorted graph cut into blocks of consecutive receivers:
    block ``b`` holds receivers ``rows[b]:rows[b + 1]`` and edges
    ``edges[b]:edges[b + 1]`` of the whole, as a graph of its own
    (``graphs[b]``: its receivers numbered from the block's first, its
    senders as they are, so a bipartite graph over the whole sender set).
    Iterating gives ``(graph, (r0, r1), (e0, e1))``; ``to(device)`` moves
    every block."""

    graphs: tuple
    rows: tuple
    edges: tuple

    def __len__(self):
        return len(self.graphs)

    def __iter__(self):
        for b, g in enumerate(self.graphs):
            yield (g, (self.rows[b], self.rows[b + 1]),
                   (self.edges[b], self.edges[b + 1]))

    def to(self, device) -> "ReceiverBlocks":
        return dataclasses.replace(
            self, graphs=tuple(g.to(device) for g in self.graphs))


def receiver_blocks(g: GnnGraph, count: int,
                    prepare: Callable = lambda b: b) -> ReceiverBlocks:
    """``g`` (sorted by receiver) cut into ``count`` blocks of consecutive
    receivers with about equal numbers of edges; ``prepare`` is applied to
    each block's graph (``precompute``, say). Edge features are sliced with
    the edges; node features stay with ``g``."""
    if not g.receivers_sorted:
        raise ValueError("receiver_blocks needs a receiver-sorted graph")
    s, r = host_edges(g)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(
        r.astype(np.int64), minlength=g.num_nodes))])
    goal = np.arange(1, count) * (g.num_edges / count)
    rows = [0] + [int(v) for v in np.searchsorted(ptr, goal)] + [g.num_nodes]
    edges = [int(ptr[v]) for v in rows]
    senders = g.num_senders if g.bipartite else g.num_nodes
    graphs = tuple(
        prepare(GnnGraph.from_coo(
            s[e0:e1], r[e0:e1] - r0, num_nodes=r1 - r0, num_senders=senders,
            edata={k: v[e0:e1] for k, v in g.edata.items()}))
        for r0, r1, e0, e1 in zip(rows, rows[1:], edges, edges[1:]))
    return ReceiverBlocks(graphs, tuple(rows), tuple(edges))
