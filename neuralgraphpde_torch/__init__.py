"""neuralgraphpde_torch — the PyTorch / CUDA port of ``neuralgraphpde``.

Same module layout and public names as the JAX package, in PyTorch idiom:
layers are ``nn.Module``s (``y = layer(x)``) whose graph lives in state
(``update_graph``), tensors are row-major ``(entities, features)``, and the
aggregation kernels are hand-written CUDA for Hopper (``kernels/``, sources
in ``csrc/``), each with a plain PyTorch version that CPU tensors take.
This package imports neither ``jax`` nor ``neuralgraphpde``.
"""

from .graph import (GnnGraph, add_self_loops, csr_offsets, degree,
                    empty_graph, grid_graph_2d, rand_graph, sort_by_receiver,
                    to_dense_adjacency)
from .ops import (aggregate_neighbors, apply_edges, copy_xj,
                  e_mul_xj, get_spmm_mode, precompute, propagate,
                  segment_reduce, set_spmm_mode, spmm, w_mul_xj)
from .nn import (AbstractGNNLayer, Chain, ContainerLayer, Dense, GCNConv,
                 Layer)
from .utils import update_graph, wrapgraph
from .ode import NeuralGraphODE, odeint, odeint_grid
from .models import grand_model
from .data import synthetic_cora
from .interop import params_from_jax

__version__ = "0.1.0"
