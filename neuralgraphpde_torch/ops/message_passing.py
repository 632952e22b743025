"""Message passing: ``propagate`` / ``apply_edges`` / ``aggregate_neighbors``
(counterparts of ``neuralgraphpde.ops.message_passing``).

For every edge ``j -> i``: gather ``xj`` at the sender, ``xi`` at the
receiver and ``e`` at the edge, evaluate the message over all edges at once,
then reduce onto receivers. The fixed-message sum (``copy_xj``, ``e_mul_xj``,
``w_mul_xj``) goes to the SpMM dispatcher in ``ops.spmm``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch

from ..graph.gnngraph import GnnGraph
from ..graph.transforms import degree
from ..utils.profiling import annotate
from .scatter import Reduction, canonical_reduction, gather, segment_reduce
from .spmm import (segment_max_pallas, segment_min_pallas, segment_sum_pallas,
                   spmm, takes_kernels)

Features = Union[torch.Tensor, Dict[str, torch.Tensor], None]


def copy_xj(xi, xj, e):
    return xj


def e_mul_xj(xi, xj, e):
    """Edge-scalar (or edge-vector) weighted sender features."""
    if e.dim() != xj.dim():
        e = e.reshape(tuple(e.shape) + (1,) * (xj.dim() - e.dim()))
    return e * xj


def w_mul_xj(xi, xj, e):
    """``e_mul_xj`` on the graph's stored edge weight ``g.edata['e']``,
    which ``propagate`` resolves."""
    return e_mul_xj(xi, xj, e)


_BUILTIN_SUM_FASTPATH = (copy_xj, e_mul_xj, w_mul_xj)


def _tree_gather(x: Features, idx: torch.Tensor) -> Features:
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: gather(v, idx) for k, v in x.items()}
    return gather(x, idx)


def apply_edges(message: Callable, g: GnnGraph, *, xi: Features = None,
                xj: Features = None, e: Features = None) -> Any:
    """Edge-expand node features and evaluate ``message(xi_e, xj_e, e)``
    over all edges."""
    return message(_tree_gather(xi, g.receivers), _tree_gather(xj, g.senders),
                   e)


def node_degree(g: GnnGraph, dtype,
                edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each node's in-degree in ``dtype``: the one ``precompute`` cached
    when there are no runtime edge weights, else summed from the edges."""
    if edge_weight is None and "in_degree" in g.cache:
        return g.cache["in_degree"].to(dtype)
    return degree(g, dtype, direction="in", edge_weight=edge_weight)


def takes_edge_kernels(g: GnnGraph, x: torch.Tensor) -> bool:
    """The gate of the kernels over the edge-id layout (K1 and K6 here, K3
    and K5 in ``ops.fused``): the layout, and a mode that takes kernels."""
    return "tcsr_edges" in g.cache and takes_kernels(x)


def aggregate_neighbors(g: GnnGraph, aggr: Reduction,
                        messages: torch.Tensor) -> torch.Tensor:
    """Reduce ``(num_edges, F)`` messages onto receiver nodes. Over the
    edge-index layout that ``precompute(pallas=True)`` attaches, in a mode
    that takes kernels, sum and mean go through the segment-SpMM kernel
    (K1), and max and min through the segment-max kernel (K6) when the
    graph's edges are sorted by receiver (JAX's guard: its kernel needs each
    receiver's edges in one run); an unsorted graph, and every other case,
    takes the scatter path. Under a profiler the reduction runs in an
    ``ngpde.dispatch.k1``, ``.k6`` or ``.scatter`` span."""
    red = canonical_reduction(aggr)
    if (red in ("sum", "mean", "max", "min")
            and isinstance(messages, torch.Tensor) and messages.dim() == 2
            and takes_edge_kernels(g, messages)):
        if red in ("max", "min"):
            if g.receivers_sorted:
                fn = (segment_max_pallas if red == "max"
                      else segment_min_pallas)
                with annotate("ngpde.dispatch.k6"):
                    return fn(g, messages)
        else:
            with annotate("ngpde.dispatch.k1"):
                out = segment_sum_pallas(g, messages)
                if red == "mean":
                    out = out / node_degree(g, out.dtype).clamp_min(
                        1.0)[:, None]
                return out
    with annotate("ngpde.dispatch.scatter"):
        return segment_reduce(messages, g.receivers, g.num_nodes, aggr)


def propagate(message: Callable, g: GnnGraph, aggr: Reduction, *,
              xi: Features = None, xj: Features = None,
              e: Features = None) -> torch.Tensor:
    """gather → message → reduce. The fixed-message sum takes the SpMM
    dispatcher (dense, K1 segment kernel, DIA stencil or scatter)."""
    if message is w_mul_xj and e is None:
        if "e" not in g.edata:
            raise ValueError("w_mul_xj requires edge weights in g.edata['e']")
        e = g.edata["e"]
    if (message in _BUILTIN_SUM_FASTPATH
            and canonical_reduction(aggr) == "sum"
            and isinstance(xj, torch.Tensor)):
        weight = None
        if message in (e_mul_xj, w_mul_xj):
            weight = e["e"] if isinstance(e, dict) else e
            weight = weight.reshape(-1) if weight.dim() > 1 else weight
        return spmm(g, xj, edge_weight=weight)
    msgs = apply_edges(message, g, xi=xi, xj=xj, e=e)
    return aggregate_neighbors(g, aggr, msgs)
