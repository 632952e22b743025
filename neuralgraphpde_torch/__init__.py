"""neuralgraphpde_torch — the PyTorch / CUDA port of ``neuralgraphpde``.

Same module layout and public names as the JAX package, in PyTorch idiom:
layers are ``nn.Module``s (``y = layer(x)``) whose graph lives in state
(``update_graph``), tensors are row-major ``(entities, features)``, and the
aggregation kernels are hand-written CUDA for Hopper (``kernels/``, sources
in ``csrc/``), each with a plain PyTorch version that CPU tensors take.
This package imports neither ``jax`` nor ``neuralgraphpde``.
"""

from .graph import (GnnGraph, add_self_loops, bandwidth, csr_offsets, degree,
                    delaunay_graph, empty_graph, gencast_graphs,
                    graphcast_graphs, grid_graph_1d, grid_graph_2d,
                    morton_order,
                    permute_nodes, radius_graph, rand_graph, rcm_order,
                    rcm_reorder, receiver_blocks, reorder_graph,
                    sort_by_receiver, spatial_reorder, to_dense_adjacency,
                    unpermute_nodes)
from .ops import (aggregate_neighbors, apply_edges, copy_xj,
                  e_mul_xj, get_spmm_mode, precompute, propagate,
                  segment_reduce, set_spmm_mode, spmm, w_mul_xj)
from .nn import (MLP, AbstractGNNContainerLayer, AbstractGNNLayer, Chain,
                 ContainerLayer, Dense, ExplicitEdgeConv, GCNConv, GNOConv,
                 ConditionalLayerNorm, InteractionConv, Layer, LayerNorm,
                 MeshAttention, MPPDEConv, Precision, TransformerBlock,
                 VMHConv, bf16)
from .utils import drop, update_graph, wrapgraph
from .ode import NeuralGraphODE, odeint, odeint_grid, solve_stats
from .models import (GKNModel, GNOModel, GenCast, GraphCast, MPPDESolver,
                     grand_model, precompute_graphs, vmh_model)
from .data import (burgers_dataset, convection_diffusion_dataset,
                   cora_dataset, darcy_dataset, load_cora, synthetic_cora)
from .train import (MetricsLogger, Rprop, accuracy, adam, adamw,
                    edm_weighted_mse, make_train_step, masked_cross_entropy,
                    mse, rollout_mse, rprop, weighted_mse)
from .interop import params_from_jax

__version__ = "0.1.0"
