"""SpMM dispatch: receiver sum of (optionally weighted) sender features,
``out[i] = Σ_{edges j->i} w_e · x[j]`` (counterpart of
``neuralgraphpde.ops.spmm``).

Modes, as in the JAX package:

- ``xla``    — gather + ``index_add_`` scatter; always available.
- ``dense``  — precomputed dense adjacency ``A @ X``.
- ``pallas`` — the receiver-sorted segment-SpMM kernel (K1,
  ``kernels.segment_kernels``; max/min aggregation takes its segment-max
  kernel, K6). The mode keeps its JAX name.
- ``bsr``    — the DIA stencil kernel (K2, ``kernels.dia_kernels``) on
  graphs that ``precompute`` found to be stencils.

``auto`` picks dense if cached, else the stencil if cached, else the segment
kernel when the features live on the card, else scatter. Each kernel
wrapper takes its plain PyTorch version for CPU tensors, so a forced mode
runs anywhere.

``precompute(g, ...)`` attaches the structure the fast paths need to
``g.cache`` once per graph, with the JAX package's gates.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph.gnngraph import GnnGraph
from ..graph.transforms import (add_self_loops as _add_self_loops, csr_offsets,
                                degree, sort_by_receiver, to_dense_adjacency)
from ..kernels.dia_kernels import dia_spmm_stencil
from ..kernels.segment_kernels import (build_segment_csr,
                                       segment_max_aggregate, segment_spmm)
from .bsr import host_edges, precompute_bsr
from .dia import build_dia, transpose_dia

_MODES = ("auto", "xla", "dense", "pallas", "bsr")
_SPMM_MODE = "auto"


def set_spmm_mode(mode: str) -> None:
    """Force one SpMM implementation process-wide (``auto`` restores the
    dispatch on cached structure)."""
    global _SPMM_MODE
    if mode not in _MODES:
        raise ValueError(f"unknown spmm mode {mode!r}")
    _SPMM_MODE = mode


def get_spmm_mode() -> str:
    return _SPMM_MODE


def kernel_available(x: torch.Tensor) -> bool:
    """``auto`` mode takes a CUDA kernel only for tensors on the card (the
    JAX package's gate is "the backend is a TPU")."""
    return x.is_cuda


def precompute(
    g: GnnGraph,
    *,
    dense: Optional[bool] = None,
    csr: bool = True,
    pallas: Optional[bool] = None,
    dense_threshold_nodes: int = 8192,
    adj_dtype=torch.float32,
    edge_weight=None,
    bsr: Optional[bool] = None,
    bsr_tb: int = 256,
    add_self_loops: bool = False,
    gcn_fused: Optional[bool] = None,
    dia: bool = True,
) -> GnnGraph:
    """Attach SpMM structure to ``g.cache``; the result lives on ``g``'s
    device.

    - ``in_degree`` always; ``adj`` (dense adjacency) for graphs of at most
      ``dense_threshold_nodes`` nodes; ``csr_offsets`` after a receiver sort.
    - ``tcsr``/``tcsr_rev``/``tcsr_edges``: the segment kernel's CSR
      layouts (forward, transposed for the backward, and edge-indexed for
      per-edge messages); ``edge_weight`` is baked into the first two.
    - ``dia``/``dia_rev``: full-DIA stencil storage, tried on graphs that
      are not dense and have at least ``4 * bsr_tb`` nodes (or when
      ``bsr=True``).
    - ``dia_norm``/``dia_norm_rev``: the degree-normalized stencil
      ``C·Ã·C`` for the fused GCN right-hand side, built by default when
      ``add_self_loops=True`` (``gcn_fused``).

    ``add_self_loops=True`` adds the loops first and marks the cache, so
    ``GCNConv(add_self_loops=True)`` keeps the fast path. ``edge_weight``
    is given in ``g``'s edge order (after the loops, if added).
    """
    device = g.device
    orig_edges = g.num_edges
    if add_self_loops:
        g = _add_self_loops(g)
    if dense is None:
        dense = g.num_nodes <= dense_threshold_nodes
    if pallas is None:
        pallas = not dense
    ew = None
    if edge_weight is not None:
        ew = np.asarray(torch.as_tensor(edge_weight).cpu(),
                        np.float32).reshape(-1)
        if ew.shape[0] != g.num_edges:
            raise ValueError(f"edge_weight has {ew.shape[0]} entries, the "
                             f"graph {g.num_edges} edges")
    perm = None
    if csr and not g.receivers_sorted:
        g, perm = sort_by_receiver(g, return_perm=True)
        if ew is not None:
            ew = ew[perm]
    cache = dict(g.cache)
    if add_self_loops:
        cache["self_looped"] = True
        # where each original edge landed in the sorted edge order: runtime
        # weights for the original edges are scattered there (loops get 1)
        if perm is None:
            pos = np.arange(orig_edges)
        else:
            inv = np.empty(len(perm), np.int64)
            inv[perm] = np.arange(len(perm))
            pos = inv[:orig_edges]
        cache["orig_edge_pos"] = torch.as_tensor(pos, dtype=torch.int32)
    cache["in_degree"] = degree(
        g, torch.float32, direction="in",
        edge_weight=None if ew is None else torch.from_numpy(ew).to(device))
    if dense:
        cache["adj"] = to_dense_adjacency(g, dtype=adj_dtype)
    if csr:
        cache["csr_offsets"] = csr_offsets(g)
    if pallas:
        s, r = host_edges(g)
        n = g.num_nodes
        cache["tcsr"] = build_segment_csr(s, r, n, edge_weight=ew)
        cache["tcsr_rev"] = build_segment_csr(r, s, n, edge_weight=ew)
        cache["tcsr_edges"] = build_segment_csr(
            np.arange(g.num_edges, dtype=np.int64), r, n,
            num_cols=g.num_edges)
    g = g.copy(cache=cache)
    if bsr or (bsr is None and not dense and g.num_nodes >= 4 * bsr_tb):
        g = precompute_bsr(g, edge_weight=ew, dia=dia)
        if ((gcn_fused or (gcn_fused is None and add_self_loops))
                and "dia" in g.cache and edge_weight is None):
            # degree normalization baked into the stencil values, paid once
            # here instead of twice per right-hand-side evaluation
            d = g.cache["in_degree"].cpu().numpy().astype(np.float64)
            c = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-30)), 0.0)
            s, r = host_edges(g)
            vals = (c[r] * c[s]).astype(np.float32)
            dn = build_dia(s, r, g.num_nodes, edge_weight=vals,
                           dtype=g.cache["dia"].values.dtype)
            g = g.copy(cache={**g.cache, "dia_norm": dn,
                              "dia_norm_rev": transpose_dia(dn)})
    return g.to(device)


def segment_sum_pallas(g: GnnGraph, messages: torch.Tensor) -> torch.Tensor:
    """Receiver sum of per-edge messages through the segment kernel
    (requires ``precompute(g, pallas=True)``)."""
    return segment_spmm(messages, g.cache["tcsr_edges"])


def segment_max_pallas(g: GnnGraph, messages: torch.Tensor) -> torch.Tensor:
    """Receiver max of per-edge messages through the segment-max kernel
    (K6; requires ``precompute(g, pallas=True)``). Empty receivers get
    ``-inf``; every tied arg-max edge receives the full gradient."""
    return segment_max_aggregate(messages, g.cache["tcsr_edges"],
                                 g.receivers)


def segment_min_pallas(g: GnnGraph, messages: torch.Tensor) -> torch.Tensor:
    """Receiver min: the max kernel on negated messages."""
    return -segment_max_pallas(g, -messages)


def spmm_xla(g: GnnGraph, x: torch.Tensor,
             edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather + scatter-add reference path."""
    xj = x.index_select(0, g.senders)
    if edge_weight is not None:
        xj = xj * edge_weight.reshape((-1,) + (1,) * (x.dim() - 1))
    out = xj.new_zeros((g.num_nodes,) + tuple(x.shape[1:]))
    return out.index_add_(0, g.receivers, xj)


def spmm_dense(g: GnnGraph, x: torch.Tensor) -> torch.Tensor:
    adj = g.cache["adj"]
    return (adj @ x.to(adj.dtype)).to(x.dtype)


def spmm_pallas(g: GnnGraph, x: torch.Tensor) -> torch.Tensor:
    return segment_spmm(x, g.cache["tcsr"])


def spmm_pallas_weighted(g: GnnGraph, x: torch.Tensor,
                         edge_weight: torch.Tensor) -> torch.Tensor:
    """Runtime-weighted receiver sum: weighted messages formed by gather,
    then summed by the segment kernel over the edge-index layout."""
    m = x.index_select(0, g.senders) * edge_weight.reshape(
        (-1,) + (1,) * (x.dim() - 1))
    return segment_sum_pallas(g, m)


def spmm(g: GnnGraph, x: torch.Tensor,
         edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Receiver sum of (optionally weighted) sender features, dispatched per
    ``set_spmm_mode`` and the structure cached on ``g``."""
    mode = _SPMM_MODE
    weighted = edge_weight is not None
    two_d = x.dim() == 2
    kernel = kernel_available(x)
    if mode == "auto":
        if "adj" in g.cache and not weighted:
            mode = "dense"
        elif "dia" in g.cache and two_d and not weighted:
            mode = "bsr"
        elif "tcsr" in g.cache and two_d and not weighted and kernel:
            mode = "pallas"
        elif "tcsr_edges" in g.cache and two_d and weighted and kernel:
            mode = "pallas"
        else:
            mode = "xla"
    if mode == "dense" and (weighted or "adj" not in g.cache):
        mode = "xla"
    if mode == "pallas" and (not two_d or (
            "tcsr_edges" not in g.cache if weighted
            else "tcsr" not in g.cache)):
        mode = "xla"
    if mode == "bsr" and ("dia" not in g.cache or not two_d or weighted):
        # runtime weights cannot ride the stored stencil values
        mode = ("pallas" if weighted and "tcsr_edges" in g.cache and two_d
                and kernel else "xla")
    if mode == "dense":
        return spmm_dense(g, x)
    if mode == "bsr":
        return dia_spmm_stencil(x, g.cache["dia"])
    if mode == "pallas":
        if weighted:
            return spmm_pallas_weighted(g, x, edge_weight)
        return spmm_pallas(g, x)
    return spmm_xla(g, x, edge_weight)
