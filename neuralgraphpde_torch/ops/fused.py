"""The conv layers' fused kernel paths, each in its ``ngpde.dispatch.*``
span: the layers (``nn.conv``) hand in weights and activations, the gates
and the kernel for each cached storage live here."""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..graph.gnngraph import GnnGraph
from ..kernels.banded_kernels import banded_gcn_rhs, pbanded_gcn_rhs
from ..kernels.dia_kernels import TF_MAX, dia_gcn_rhs, epilogue_supported
from ..kernels.fused_mlp_kernels import (fused_mlp_aggregate,
                                         supported_activation)
from ..kernels.attention_kernels import (AttentionLayout,
                                         mesh_attention_plain)
from ..kernels.attention_kernels import mesh_attention as _mesh_attention
from ..kernels.gno_kernels import fused_gno_aggregate, pack_last_layer
from ..nn.basic import matmul
from ..utils.profiling import annotate
from .message_passing import node_degree, takes_edge_kernels
from .scatter import Reduction, canonical_reduction
from .spmm import takes_kernels

# the GCN right-hand side's storage, in the JAX gate's order, and its span
_NORMALIZED = {"dia_norm": "ngpde.dispatch.dia_fused",
               "pbanded_norm": "ngpde.dispatch.pbanded_fused",
               "banded_norm": "ngpde.dispatch.banded_fused"}


def gcn_rhs(g: GnnGraph, activation, x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor],
            premultiply: bool) -> Optional[torch.Tensor]:
    """``act(C·Ã·C x W + b)`` as one kernel call (K2, K4 or K7) on the first
    degree-normalized storage ``g`` carries, in x's dtype; ``premultiply``
    aggregates x @ W. None where the exact path runs: no such storage, x
    not 2-D, an activation the kernel does not apply, a kernel-side width
    past ``TF_MAX``, or a mode that takes no kernels (``bsr`` does)."""
    norm = next((k for k in _NORMALIZED if k in g.cache), None)
    if (norm is None or x.dim() != 2 or not epilogue_supported(activation)
            or (w.shape[1] if premultiply else x.shape[1]) > TF_MAX
            or not takes_kernels(x, forced=("pallas", "bsr"))):
        return None
    rhs = (dia_gcn_rhs if norm == "dia_norm" else
           pbanded_gcn_rhs if norm == "pbanded_norm" else banded_gcn_rhs)
    st, st_rev = g.cache[norm], g.cache.get(norm + "_rev")
    with annotate(_NORMALIZED[norm]):
        if premultiply:
            y = rhs(activation, matmul(x, w), None, b, st, st_rev)
        else:
            y = rhs(activation, x, w, b, st, st_rev)
        return y.to(x.dtype)


def edge_mlp_fits(activations, aggr: Reduction) -> bool:
    """Whether K3 takes a Dense stack of these activations under ``aggr``
    (JAX's gate: widths are the wrapper's to refuse, on the card)."""
    return (canonical_reduction(aggr) in ("sum", "mean")
            and all(supported_activation(a) for a in activations))


def edge_mlp_aggregate(plan: tuple, feats: torch.Tensor, g: GnnGraph,
                       aggr: Reduction) -> torch.Tensor:
    """``aggr_{e→i} ϕ(feats_e)`` through K3 where ``takes_edge_kernels``
    and ``edge_mlp_fits`` hold. ``plan = (acts, ws, bs, post)``: the layers the
    kernel runs, and ``post``, a linear last layer applied after the
    reduce, or None."""
    acts, ws, bs, post = plan
    with annotate("ngpde.dispatch.k3"):
        reduced = fused_mlp_aggregate(acts, feats, ws, bs,
                                      g.cache["tcsr_edges"])
        deg = node_degree(g, reduced.dtype)
        return fused_phi_post(reduced, post, deg, canonical_reduction(aggr))


def fused_phi_post(reduced, post, deg, red):
    """Post-reduce epilogue of the fused ϕ path: mean normalization and the
    split-off linear layer (``Σ(h@W+b) = (Σh)@W + deg·b``), with the
    empty-receiver conventions of the segment reduce (an empty mean row
    stays 0, a sum row gets ``deg·b``)."""
    if post is None:
        return (reduced / deg.clamp_min(1.0)[:, None]
                if red == "mean" else reduced)
    w, b = post
    if red == "mean":
        m = matmul(reduced / deg.clamp_min(1.0)[:, None], w)
        if b is not None:
            m = m + b
        # empty receivers stay 0 (segment-mean convention), not the bias
        return torch.where(deg[:, None] > 0, m, torch.zeros_like(m))
    m = matmul(reduced, w)
    if b is not None:
        m = m + deg[:, None] * b
    return m


def gno_aggregate(g: GnnGraph, aggr: Reduction, x: torch.Tensor,
                  ph: Union[torch.Tensor, Callable[[], torch.Tensor]],
                  w: torch.Tensor, b: Optional[torch.Tensor], in_chs: int,
                  out_chs: int) -> Optional[torch.Tensor]:
    """``aggr_j ϕ(e_ij)·x_j`` through K5: ϕ's linear last layer ``(w, b)``
    on its prefix ``ph`` (or on what ``ph()`` makes inside the span), the
    per-edge matvec and the receiver sum or mean. None where the exact
    path runs: another reduction, no edge-id layout, or a mode that takes
    no kernels. Widths are the wrapper's to refuse, on the card."""
    red = canonical_reduction(aggr)
    if red not in ("sum", "mean") or not takes_edge_kernels(g, x):
        return None
    with annotate("ngpde.dispatch.k5"):
        if callable(ph):
            ph = ph()
        wl, bl = pack_last_layer(w, b, in_chs, out_chs)
        m = fused_gno_aggregate(ph, x, wl, bl, g.cache["tcsr_edges"],
                                g.senders)
        if red == "mean":
            m = m / node_degree(g, m.dtype).clamp_min(1.0)[:, None]
        return m


def mesh_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   layout: AttentionLayout, heads: int) -> torch.Tensor:
    """Attention over ``layout``'s pairs: K8 where ``takes_kernels`` holds
    (``ngpde.dispatch.mesh_attention``), its plain version otherwise
    (``ngpde.dispatch.mesh_attention_plain``)."""
    if takes_kernels(q):
        with annotate("ngpde.dispatch.mesh_attention"):
            return _mesh_attention(q, k, v, layout, heads)
    with annotate("ngpde.dispatch.mesh_attention_plain"):
        return mesh_attention_plain(q, k, v, layout, heads)
