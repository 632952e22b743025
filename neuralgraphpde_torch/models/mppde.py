"""MP-PDE solver (Brandstetter et al., arXiv:2202.03376) with temporal
bundling (counterpart of ``neuralgraphpde.models.mppde``):

- encoder: a per-node MLP over the bundled history ``[u_{t-K+1..t}, x, θ]``;
- processor: ``depth`` residual ``MPPDEConv`` blocks;
- decoder: an MLP emitting K per-step increments; the next bundle is
  ``u_t + cumsum(increments)``. The rollout repeats the whole model every
  K steps.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graph.gnngraph import GnnGraph
from ..nn.basic import MLP
from ..nn.conv import MPPDEConv, _values_cat
from ..nn.gnn import AbstractGNNContainerLayer


class MPPDESolver(AbstractGNNContainerLayer):
    """K-bundled neural PDE solver. Input and output: ``(N, K)`` solution
    windows.

    The model's graph (``update_graph``) supplies the node positions
    ``ndata['x']`` and the PDE parameters θ (``gdata``). Each forward hands
    every conv a copy of it with ``ndata = {'u': window, 'x': positions}``
    (that key order: the conv's ``d_i − d_j`` terms) and gives the conv its
    own graph back afterwards. Children: ``encoder``,
    ``conv_1..conv_depth`` (each with ``phi`` and ``psi``), ``decoder``;
    every conv reduces by mean. Parameters are drawn from ``generator`` on
    the CPU and placed on ``device``."""

    def __init__(self, bundle: int = 25, hidden: int = 128, depth: int = 6,
                 pos_dim: int = 1, theta_dim: int = 0,
                 initialgraph: Optional[GnnGraph] = None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(initialgraph)
        K, H, P, TH = bundle, hidden, pos_dim, theta_dim
        kw = dict(activation="swish", generator=generator, device=device)
        self.encoder = MLP((K + P + TH, H, H), **kw)
        names = ["encoder"]
        for i in range(depth):
            conv = MPPDEConv(phi=MLP((2 * H + K + P + TH, H, H), **kw),
                             psi=MLP((H + H + TH, H, H), **kw), aggr="mean")
            self.add_module(f"conv_{i + 1}", conv)
            names.append(f"conv_{i + 1}")
        self.decoder = MLP((H, H, K), **kw)
        self.layer_names = tuple(names) + ("decoder",)
        self.bundle, self.hidden, self.depth = bundle, hidden, depth

    def forward(self, u_window: torch.Tensor) -> torch.Tensor:
        g = self.graph
        pos = g.ndata["x"]
        theta = _values_cat(g.gdata, u_window, g.num_graphs)
        theta_n = theta.repeat_interleave(g.num_nodes // g.num_graphs, dim=0)
        h = self.encoder(torch.cat([u_window, pos, theta_n], dim=-1))
        g_conv = g.copy(ndata={"u": u_window, "x": pos})
        for i in range(self.depth):
            conv = getattr(self, f"conv_{i + 1}")
            own = conv.graph
            conv.graph = g_conv
            try:
                h = h + conv(h)  # residual processor block
            finally:
                conv.graph = own
        delta = self.decoder(h)
        return u_window[:, -1:] + torch.cumsum(delta, dim=-1)

    @torch.no_grad()
    def rollout(self, u_window: torch.Tensor,
                num_bundles: int) -> torch.Tensor:
        """Autoregressive K-step rollout: ``(num_bundles, N, K)``."""
        traj, u = [], u_window
        for _ in range(num_bundles):
            u = self(u)
            traj.append(u)
        return torch.stack(traj)
