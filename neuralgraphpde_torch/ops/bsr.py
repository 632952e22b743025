"""Structured storage selection (counterpart of the DIA branch of
``neuralgraphpde.ops.bsr.precompute_bsr``).

The JAX package picks, in order: hybrid DIA (stencil + COO remainder), full
DIA, packed block bands, dense block bands, block-sparse. The port has the
full-DIA branch only; for a graph where JAX would take any other branch it
attaches nothing, and the graph stays on the segment-SpMM kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..graph.gnngraph import GnnGraph
from .dia import build_dia, plan_dia, transpose_dia

# Widest stencil the JAX package's kernel accepts (ops/bsr.py, ops/spmm.py).
DIA_MAX_BANDWIDTH = 8192


def host_edges(g: GnnGraph):
    """``(senders, receivers)`` as numpy, from ``host_coo`` when kept."""
    if g.host_coo is not None:
        return g.host_coo
    return g.senders.cpu().numpy(), g.receivers.cpu().numpy()


def precompute_bsr(g: GnnGraph, *, edge_weight: Optional[np.ndarray] = None,
                   dia: bool = True) -> GnnGraph:
    """Attach ``dia``/``dia_rev`` when the graph is a full-DIA stencil that
    the kernel takes; otherwise return ``g`` unchanged."""
    s, r = host_edges(g)
    plan = plan_dia(s, r, g.num_nodes) if dia else None
    if plan is None:
        return g
    if plan.hybrid_ok and (not plan.full_ok
                           or plan.full_bw > DIA_MAX_BANDWIDTH
                           or 4 * plan.hybrid_bw <= plan.full_bw):
        return g  # JAX builds the hybrid DIA + COO remainder here
    if plan.full_ok and plan.full_bw <= DIA_MAX_BANDWIDTH:
        dm = build_dia(s, r, g.num_nodes, edge_weight=edge_weight)
        if dm is not None:
            return g.copy(cache={**g.cache, "dia": dm,
                                 "dia_rev": transpose_dia(dm)})
    return g  # JAX tries packed / dense block bands / block-sparse here
