"""Graph-as-state utilities: ``wrapgraph`` / ``update_graph``, and
``drop``.

A GNN layer holds its graph as a plain attribute (state), never as a
parameter; ``update_graph`` swaps it on every layer of a model, per batch.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import torch

from ..graph.gnngraph import GnnGraph, empty_graph


def drop(d: Mapping, key: str) -> Dict:
    """Copy of ``d`` without ``key``, in ``d``'s order."""
    return {k: v for k, v in d.items() if k != key}


def wrapgraph(g: Union[None, GnnGraph, Callable]) -> Callable[[], GnnGraph]:
    """Normalize an ``initialgraph`` argument into a thunk; ``None`` gives
    the empty graph."""
    if g is None:
        return empty_graph
    if isinstance(g, GnnGraph):
        return lambda: g.copy()
    if callable(g):
        return g
    raise TypeError(f"initialgraph must be a GnnGraph or callable, got {g!r}")


def update_graph(model: torch.nn.Module, g: Optional[GnnGraph] = None,
                 **feature_overrides) -> torch.nn.Module:
    """Replace the graph of every layer in ``model`` that holds one. With
    ``g`` given, all layers share it; with ``g=None`` each layer's graph is
    copied with the feature overrides (``ndata=``, ``edata=``, ``gdata=``).
    Returns ``model``."""
    for module in model.modules():
        old = getattr(module, "graph", None)
        if isinstance(old, GnnGraph):
            if g is not None:
                module.graph = g
            elif feature_overrides:
                module.graph = old.copy(**feature_overrides)
    return model
