from .core import ContainerLayer, Layer
from .basic import (MLP, Chain, ConditionalLayerNorm, Dense, LayerNorm,
                    glorot_normal, glorot_uniform, resolve_activation,
                    zeros_init)
from .gnn import (INPUT_KEY, AbstractGNNContainerLayer, AbstractGNNLayer,
                  wrap_input)
from .conv import (ExplicitEdgeConv, GCNConv, GNOConv, Interaction,
                   InteractionConv, MeshAttention, MPPDEConv,
                   TransformerBlock, VMHConv)
from .precision import Precision, bf16

__all__ = [
    "Layer", "ContainerLayer", "Dense", "Chain", "MLP", "LayerNorm",
    "ConditionalLayerNorm", "MeshAttention", "TransformerBlock",
    "glorot_normal", "glorot_uniform", "zeros_init", "resolve_activation",
    "INPUT_KEY", "wrap_input", "AbstractGNNLayer",
    "AbstractGNNContainerLayer", "GCNConv", "ExplicitEdgeConv", "VMHConv",
    "MPPDEConv", "GNOConv", "InteractionConv", "Interaction", "Precision",
    "bf16",
]
