from .state import update_graph, wrapgraph

__all__ = ["update_graph", "wrapgraph"]
