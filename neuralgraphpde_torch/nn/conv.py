"""GNN convolution layers (counterpart of ``neuralgraphpde.nn.conv``;
``GCNConv`` so far)."""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Union

import torch

from ..graph.transforms import add_self_loops as _add_self_loops
from ..graph.transforms import degree as _degree
from ..kernels.dia_kernels import TF_MAX, dia_gcn_rhs, epilogue_supported
from ..ops.message_passing import copy_xj, e_mul_xj, propagate, w_mul_xj
from ..ops.spmm import get_spmm_mode, kernel_available
from .basic import glorot_normal, make_params, resolve_activation, zeros_init
from .gnn import AbstractGNNLayer


class GCNConv(AbstractGNNLayer):
    """Degree-normalized graph convolution ``σ(W(D^{-1/2} Ã D^{-1/2} x) + b)``
    with optional bias, self-loops and stored or runtime edge weights, and
    the multiply-before-aggregate order when ``out_chs < in_chs``.

    Fused right-hand side: on graphs carrying the normalized stencil
    (``precompute(..., add_self_loops=True)`` on a grid, ``dia_norm``), the
    whole layer runs as one DIA kernel call when all of: no edge weights,
    2-D input, an activation the kernel applies (``epilogue_supported``),
    a kernel-side width (``out_chs`` if ``out_chs < in_chs``, else
    ``in_chs``) of at most 512, and a mode that takes kernels (``pallas``,
    ``bsr``, or ``auto`` with x on the card). Otherwise the exact path runs.
    """

    def __init__(self, in_chs: int, out_chs: int,
                 activation: Union[None, str, Callable] = None,
                 initialgraph=None, *, init_weight=glorot_normal,
                 init_bias=zeros_init, use_bias: bool = True,
                 add_self_loops: bool = True, use_edge_weight: bool = False,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__(initialgraph)
        self.in_chs, self.out_chs = in_chs, out_chs
        self.activation = activation
        self.add_self_loops = add_self_loops
        self.use_edge_weight = use_edge_weight
        make_params(self, in_chs, out_chs, use_bias, init_weight, init_bias,
                    generator, device, dtype)

    def forward(self, x: torch.Tensor,
                edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        g = self.graph
        looped = g.cache.get("self_looped", False)
        if edge_weight is not None and edge_weight.shape[0] != g.num_edges:
            # a pre-self-looped graph may get weights for its original edges
            if not (looped and
                    edge_weight.shape[0] == g.num_edges - g.num_nodes):
                raise ValueError(
                    f"wrong number of edge weights (expected {g.num_edges}, "
                    f"got {edge_weight.shape[0]})")

        if self.add_self_loops and not looped:
            if any(k in g.cache for k in ("adj", "tcsr", "dia")):
                warnings.warn(
                    "GCNConv(add_self_loops=True) rebuilds the graph each "
                    "forward, discarding the SpMM structure attached by "
                    "ops.precompute — aggregation falls back to the scatter "
                    "path. Precompute on the self-looped graph instead: "
                    "g = precompute(g, add_self_loops=True).", stacklevel=2)
            g = _add_self_loops(g)
            if edge_weight is not None:
                edge_weight = torch.cat(
                    [edge_weight, edge_weight.new_ones(g.num_nodes)])
        elif (self.add_self_loops and edge_weight is not None
              and edge_weight.shape[0] != g.num_edges):
            # weights for the original edges of a pre-self-looped graph go
            # where precompute recorded them; loop edges keep weight 1
            pos = g.cache.get("orig_edge_pos")
            full = edge_weight.new_ones(g.num_edges)
            if pos is None:
                full[: edge_weight.shape[0]] = edge_weight
            else:
                full[pos.to(torch.int64)] = edge_weight
            edge_weight = full

        w, b = self.weight, self.bias
        premultiply = self.out_chs < self.in_chs
        if (edge_weight is None and not self.use_edge_weight
                and "dia_norm" in g.cache and x.dim() == 2):
            mode = get_spmm_mode()
            kernel_width = self.out_chs if premultiply else x.shape[1]
            if (epilogue_supported(self.activation)
                    and kernel_width <= TF_MAX
                    and (mode in ("pallas", "bsr")
                         or (mode == "auto" and kernel_available(x)))):
                nrm = g.cache["dia_norm"]
                if premultiply:
                    y = dia_gcn_rhs(self.activation, x @ w, None, b, nrm)
                else:
                    y = dia_gcn_rhs(self.activation, x, w, b, nrm)
                return y.to(x.dtype)

        if premultiply:
            x = x @ w
        if edge_weight is not None:
            dw = edge_weight
        elif self.use_edge_weight:
            dw = g.edata["e"].reshape(-1)
        else:
            dw = None
        if dw is None and "in_degree" in g.cache:
            d = g.cache["in_degree"].to(x.dtype)
        else:
            d = _degree(g, x.dtype, direction="in", edge_weight=dw)
        c = torch.where(d > 0, 1.0 / torch.sqrt(d.clamp_min(1e-30)),
                        torch.zeros_like(d))
        x = x * c[:, None]
        if edge_weight is not None:
            x = propagate(e_mul_xj, g, "sum", xj=x, e=edge_weight)
        elif self.use_edge_weight:
            x = propagate(w_mul_xj, g, "sum", xj=x)
        else:
            x = propagate(copy_xj, g, "sum", xj=x)
        x = x * c[:, None]
        if not premultiply:
            x = x @ w
        if b is not None:
            x = x + b
        return resolve_activation(self.activation)(x)
