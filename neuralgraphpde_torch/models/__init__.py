from .gno import GKNModel, GNOModel
from .gencast import GenCast
from .graphcast import GraphCast, precompute_graphs
from .grand import grand_model
from .mppde import MPPDESolver
from .vmh import vmh_model

__all__ = ["grand_model", "vmh_model", "GNOModel", "GKNModel",
           "MPPDESolver", "GenCast", "GraphCast", "precompute_graphs"]
