"""GNN layer base class: the graph lives in the layer's state.

A GNN layer owns no graph parameters; it keeps ``self.graph`` (by default
the empty graph, or ``initialgraph()``), which ``utils.update_graph``
replaces per batch.
"""
from __future__ import annotations

from ..utils.state import wrapgraph
from .core import Layer


class AbstractGNNLayer(Layer):
    """Leaf GNN layer holding ``self.graph``."""

    def __init__(self, initialgraph=None):
        super().__init__()
        self.initialgraph = wrapgraph(initialgraph)
        self.graph = self.initialgraph()
