"""Graph kernel network for Darcy flow (Li et al., arXiv:2003.03485;
counterpart of ``neuralgraphpde.models.gno``): lift the coefficient field
and positions, apply ``depth`` ``GNOConv`` kernel-integration layers on a
radius graph, project to the solution."""
from __future__ import annotations

from typing import Optional

import torch

from ..graph.gnngraph import GnnGraph
from ..nn.basic import MLP, Dense
from ..nn.conv import GNOConv
from ..nn.gnn import AbstractGNNContainerLayer


class GNOModel(AbstractGNNContainerLayer):
    """Input: coefficient field ``a`` (N, a_dim); output: solution (N,
    out_dim). The model's graph carries ``ndata = {'x': positions}``
    (``update_graph``); each forward hands every conv a copy of it with
    ``ndata = {'a': a, 'x': positions}`` and gives the conv its own graph
    back afterwards, so no sample's ``a`` stays on a module. Children:
    ``lift``, ``conv_1..conv_depth``, ``proj``. Parameters are drawn from
    ``generator`` on the CPU and placed on ``device``."""

    def __init__(self, a_dim: int = 1, pos_dim: int = 2, width: int = 64,
                 ker_width: int = 128, depth: int = 4, out_dim: int = 1,
                 initialgraph: Optional[GnnGraph] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(initialgraph)
        kw = dict(generator=generator, device=device)
        edge_in = 2 * (a_dim + pos_dim)
        self.lift = Dense(a_dim + pos_dim, width, **kw)
        names = ["lift"]
        for i in range(depth):
            phi = MLP((edge_in, ker_width, ker_width, width * width),
                      activation="relu", **kw)
            conv = GNOConv(width, width, phi,
                           activation="relu" if i < depth - 1 else None,
                           aggr="mean", **kw)
            self.add_module(f"conv_{i + 1}", conv)
            names.append(f"conv_{i + 1}")
        self.proj = Dense(width, out_dim, **kw)
        self.layer_names = tuple(names) + ("proj",)
        self.depth = depth

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        g = self.graph
        pos = g.ndata["x"]
        h = self.lift(torch.cat([a, pos], dim=-1))
        g_conv = g.copy(ndata={"a": a, "x": pos})
        for i in range(self.depth):
            conv = getattr(self, f"conv_{i + 1}")
            own = conv.graph
            conv.graph = g_conv
            try:
                h = conv(h)
            finally:
                conv.graph = own
        return self.proj(h)
