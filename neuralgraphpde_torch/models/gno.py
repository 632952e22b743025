"""Graph kernel networks for Darcy flow (Li et al., arXiv:2003.03485):
``GNOModel`` (counterpart of ``neuralgraphpde.models.gno``) lifts the
coefficient field and positions, applies ``depth`` ``GNOConv``
kernel-integration layers on a radius graph, each with its own kernel
network, and projects to the solution; ``GKNModel`` is the published
network, one conv and its kernel network shared by every iteration."""
from __future__ import annotations

from typing import Optional

import torch

from ..graph.gnngraph import GnnGraph
from ..nn.basic import MLP, Dense
from ..nn.conv import GNOConv
from ..nn.gnn import AbstractGNNContainerLayer
from ..utils.profiling import annotate


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


class GKNModel(AbstractGNNContainerLayer):
    """The graph kernel network as published for Darcy flow (the paper's
    section 4 and the authors' ``KernelNN``): ``v = P u + p`` from the
    ``node_dim`` features ``u`` of each node; ``depth`` times ``v ←
    ReLU(W v + mean_{j→i} κ(e_ij) v_j + b)``, one ``GNOConv`` whose W, b
    and kernel network serve every iteration; ``Q v + q``. The kernel
    network is ``MLP(edge_dim → ker_width / 2 → ker_width → width²,
    ReLU)`` on the edge's ``edge_dim`` features (twice the widths of ``a``
    and the positions: 6 for Darcy), its output the ``width × width``
    matrix κ(e_ij).

    The model's graph carries ``ndata = {'x': positions}``;
    ``forward(u, a)`` hands the conv a copy with ``ndata = {'a': a, 'x':
    positions}`` (an edge's features ``[a_i, x_i, a_j, x_j]``) and gives
    the conv its own graph back afterwards. The kernel network's layers but
    its last depend on those features alone: they run once a forward, in
    an ``ngpde.gno.kernel_net`` span, and each iteration hands the conv
    their ``(E, ker_width)`` output (``GNOConv.forward(x, ph)``), so on the
    card every iteration's K5 call reads that one tensor and autograd sums
    the iterations' gradients into it. Children: ``lift``, ``conv``,
    ``proj``. Parameters are drawn from ``generator`` on the CPU and placed
    on ``device``."""

    layer_names = ("lift", "conv", "proj")

    def __init__(self, node_dim: int = 6, edge_dim: int = 6,
                 width: int = 64, ker_width: int = 1024, depth: int = 6,
                 out_dim: int = 1, initialgraph: Optional[GnnGraph] = None,
                 *, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(initialgraph)
        kw = dict(generator=generator, device=device)
        self.lift = Dense(node_dim, width, **kw)
        phi = MLP((edge_dim, ker_width // 2, ker_width, width * width),
                  activation="relu", **kw)
        self.conv = GNOConv(width, width, phi, activation="relu",
                            aggr="mean", **kw)
        self.proj = Dense(width, out_dim, **kw)
        self.depth = depth

    def forward(self, u: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        g, conv = self.graph, self.conv
        own = conv.graph
        conv.graph = g.copy(ndata={"a": a, "x": g.ndata["x"]})
        try:
            with annotate("ngpde.gno.kernel_net"):
                ph = conv.phi_prefix(u)
            h = self.lift(u)
            for _ in range(self.depth):
                h = conv(h, ph)
        finally:
            conv.graph = own
        return self.proj(h)
