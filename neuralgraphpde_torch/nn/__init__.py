from .core import ContainerLayer, Layer
from .basic import (Chain, Dense, glorot_normal, glorot_uniform,
                    resolve_activation, zeros_init)
from .gnn import AbstractGNNLayer
from .conv import GCNConv

__all__ = [
    "Layer", "ContainerLayer", "Dense", "Chain", "glorot_normal",
    "glorot_uniform", "zeros_init", "resolve_activation", "AbstractGNNLayer",
    "GCNConv",
]
