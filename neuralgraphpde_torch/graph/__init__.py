from .gnngraph import GnnGraph, empty_graph
from .builders import (delaunay_graph, grid_graph_1d, grid_graph_2d,
                       radius_graph, rand_graph)
from .transforms import (
    ReceiverBlocks,
    add_self_loops,
    csr_offsets,
    degree,
    receiver_blocks,
    sort_by_receiver,
    to_dense_adjacency,
)
from .sphere import (GenCastGraphs, GraphCastGraphs, gencast_graphs,
                     graphcast_graphs)
from .reorder import (bandwidth, morton_order, permute_nodes, rcm_order,
                      rcm_reorder, reorder_graph, spatial_reorder,
                      unpermute_nodes)

__all__ = [
    "GnnGraph", "empty_graph", "rand_graph", "grid_graph_1d", "grid_graph_2d",
    "delaunay_graph",
    "radius_graph",
    "add_self_loops", "degree", "sort_by_receiver", "csr_offsets",
    "to_dense_adjacency", "receiver_blocks", "ReceiverBlocks",
    "graphcast_graphs", "GraphCastGraphs", "gencast_graphs", "GenCastGraphs",
    "rcm_order", "rcm_reorder",
    "morton_order", "spatial_reorder", "reorder_graph", "permute_nodes", "unpermute_nodes",
    "bandwidth",
]
