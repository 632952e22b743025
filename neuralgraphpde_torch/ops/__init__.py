from .message_passing import (aggregate_neighbors, apply_edges, copy_xj,
                              e_mul_xj, propagate, w_mul_xj)
from .scatter import segment_reduce
from .spmm import get_spmm_mode, precompute, set_spmm_mode, spmm

__all__ = [
    "aggregate_neighbors", "apply_edges", "copy_xj", "e_mul_xj",
    "propagate", "w_mul_xj", "segment_reduce", "get_spmm_mode", "precompute",
    "set_spmm_mode", "spmm",
]
