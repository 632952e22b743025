from .state import drop, update_graph, wrapgraph

__all__ = ["drop", "update_graph", "wrapgraph"]
