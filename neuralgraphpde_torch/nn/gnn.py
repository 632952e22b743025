"""GNN layer base classes: the graph lives in the layer's state.

A GNN layer owns no graph parameters; it keeps ``self.graph`` (by default
the empty graph, or ``initialgraph()``), which ``utils.update_graph``
replaces per batch.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from ..utils.state import wrapgraph
from .core import ContainerLayer, Layer

# Bare-tensor layer inputs are wrapped under this key so they can be merged
# with ndata without collisions. It comes first in ``{**x, **g.ndata}``, so
# input features come first in message concatenations.
INPUT_KEY = "_input"


def wrap_input(x: Union[torch.Tensor, Dict[str, torch.Tensor]]
               ) -> Dict[str, torch.Tensor]:
    if isinstance(x, dict):
        return x
    return {INPUT_KEY: x}


class AbstractGNNLayer(Layer):
    """Leaf GNN layer holding ``self.graph``."""

    def __init__(self, initialgraph=None):
        super().__init__()
        self.initialgraph = wrapgraph(initialgraph)
        self.graph = self.initialgraph()


class AbstractGNNContainerLayer(ContainerLayer):
    """GNN layer wrapping named sub-layers (``layer_names``) and holding
    ``self.graph`` of its own."""

    def __init__(self, initialgraph=None):
        super().__init__()
        self.initialgraph = wrapgraph(initialgraph)
        self.graph = self.initialgraph()
