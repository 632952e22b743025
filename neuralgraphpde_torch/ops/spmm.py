"""SpMM dispatch: receiver sum of (optionally weighted) sender features,
``out[i] = Σ_{edges j->i} w_e · x[j]`` (counterpart of
``neuralgraphpde.ops.spmm``).

Modes, as in the JAX package:

- ``xla``    — gather + ``index_add_`` scatter; always available.
- ``dense``  — precomputed dense adjacency ``A @ X``.
- ``pallas`` — the receiver-sorted segment-SpMM kernel (K1,
  ``kernels.segment_kernels``; max/min aggregation takes its segment-max
  kernel, K6). The mode keeps its JAX name.
- ``bsr``    — structured storage that ``precompute`` found: the DIA
  stencil kernel (K2, ``kernels.dia_kernels``, plus the hybrid's COO
  remainder), the packed or dense block-band kernel (K4 / K7,
  ``kernels.banded_kernels``), or block-sparse rows (plain torch).

``auto`` picks dense if cached, else structured storage if cached, else the
segment kernel when the features live on the card, else scatter. Each
kernel wrapper takes its plain PyTorch version for CPU tensors, so a forced
mode runs anywhere. Every path is differentiable.

``precompute(g, ...)`` attaches the structure the fast paths need to
``g.cache`` once per graph, with the JAX package's gates.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..graph.gnngraph import GnnGraph
from ..graph.reorder import rcm_order, reorder_graph
from ..graph.transforms import (add_self_loops as _add_self_loops, csr_offsets,
                                degree, sort_by_receiver, to_dense_adjacency)
from ..kernels.banded_kernels import banded_spmm_pallas, pbanded_spmm_pallas
from ..kernels.dia_kernels import dia_spmm_stencil
from ..kernels.segment_kernels import (build_segment_csr,
                                       segment_max_aggregate, segment_spmm)
from ..utils.profiling import annotate
from .bsr import (build_banded, build_packed_banded, bsr_spmm, host_edges,
                  precompute_bsr, structured_storages)
from .dia import build_dia, dia_remainder_spmm, transpose_dia

_MODES = ("auto", "xla", "dense", "pallas", "bsr")
# the profiler span of each mode ``spmm`` resolves to
_SPANS = {m: f"ngpde.dispatch.spmm.{m}" for m in _MODES}
_SPMM_MODE = "auto"
# Band-count cap after an automatic reorder: RCM'd planar meshes at ~10^5
# nodes land just past the dense-band builder's 16 (the JAX package's value).
AUTO_REORDER_MAX_BANDS = 24


def set_spmm_mode(mode: str) -> None:
    """Force one SpMM implementation process-wide (``auto`` restores the
    dispatch on cached structure)."""
    global _SPMM_MODE
    if mode not in _MODES:
        raise ValueError(f"unknown spmm mode {mode!r}")
    _SPMM_MODE = mode


def get_spmm_mode() -> str:
    return _SPMM_MODE


def takes_kernels(x: torch.Tensor, forced=("pallas",)) -> bool:
    """Whether the mode sends ``x`` to a hand-written kernel: a mode in
    ``forced``, or ``auto`` with ``x`` on the card (JAX: "the backend is a
    TPU"). Every kernel path of ``ops`` and ``nn`` asks this one gate."""
    return _SPMM_MODE in forced or (_SPMM_MODE == "auto" and x.is_cuda)


def _try_auto_reorder(g: GnnGraph, tb: int):
    """RCM-renumber ``g`` when, and only when, that unlocks a banded, DIA
    or packed structure the graph does not have as labeled. Returns
    ``(graph, order, edge_perm)``, ``order = None`` when nothing changed;
    ``edge_perm`` is the receiver re-sort's edge permutation (new slot
    ``k`` holds old edge ``edge_perm[k]``)."""
    s, r = host_edges(g)
    n = g.num_nodes
    if n < 4 * tb or g.num_edges == 0:
        return g, None, None
    if next(structured_storages(s, r, n, tb, 16), None):
        return g, None, None  # already structured
    order = rcm_order(s, r, n)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n, dtype=np.int64)
    s2, r2 = inv[s.astype(np.int64)], inv[r.astype(np.int64)]
    if not next(structured_storages(s2, r2, n, tb, AUTO_REORDER_MAX_BANDS),
                None):
        return g, None, None  # expander-like: no narrow ordering exists
    g2, eperm = reorder_graph(g, order, return_edge_perm=True)
    return g2, order, eperm


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
    auto_reorder: bool = False,
) -> GnnGraph:
    """Attach SpMM structure to ``g.cache``; the result lives on ``g``'s
    device.

    - ``in_degree`` always; ``adj`` (dense adjacency) for graphs of at most
      ``dense_threshold_nodes`` nodes; ``csr_offsets`` after a receiver sort.
    - ``tcsr``/``tcsr_rev``/``tcsr_edges``: the segment kernel's CSR
      layouts (forward, transposed for the backward, and edge-indexed for
      per-edge messages); ``edge_weight`` is baked into the first two.
    - structured storage (``ops.bsr.precompute_bsr``), tried on graphs that
      are not dense and have at least ``4 * bsr_tb`` nodes (or when
      ``bsr=True``): hybrid DIA (``dia``/``dia_rev``/``dia_rem``), full DIA,
      packed block bands (``pbanded``/``pbanded_rev``), dense block bands
      (``banded``/``banded_rev``, at most ``max_bands`` = 16, or 24 after a
      reorder) or block-sparse rows (``bsr``).
    - the degree-normalized storage ``C·Ã·C`` for the fused GCN right-hand
      side (``dia_norm``, ``pbanded_norm`` or ``banded_norm``, each with its
      ``*_rev``), built by default when ``add_self_loops=True``
      (``gcn_fused``), but not on hybrid graphs or with ``edge_weight``.

    ``auto_reorder=True``: when the graph is not banded, DIA or packed as
    labeled but an RCM renumbering makes it so (meshes with scrambled
    labels), the nodes are relabeled first and ``cache['node_order']``
    holds the old id of each new node. THE NODE IDS CHANGE: permute
    per-node inputs with ``graph.reorder.permute_nodes(x, order)`` and map
    outputs back with ``unpermute_nodes``.

    A bipartite graph (``g.num_senders`` set: senders and receivers in
    different node sets) gets ``in_degree``, ``csr_offsets`` and the
    segment kernel's layouts alone (``tcsr`` reads ``num_senders`` rows of
    x; ``tcsr_rev`` sums onto them), and takes no loops or reorder.

    ``add_self_loops=True`` adds the loops first and marks the cache, so
    ``GCNConv(add_self_loops=True)`` keeps the fast path; ``orig_edge_pos``
    records where each original edge landed. ``edge_weight`` is given in
    ``g``'s edge order (after the loops, if added).
    """
    device = g.device
    orig_edges = g.num_edges
    if g.bipartite:
        if add_self_loops or auto_reorder or dense or bsr:
            raise ValueError("a bipartite graph takes the segment layouts "
                             "alone: no loops, reorder, dense or bsr")
        dense, bsr = False, False
    if add_self_loops:
        g = _add_self_loops(g)
    ew = None
    if edge_weight is not None:
        ew = np.asarray(torch.as_tensor(edge_weight).cpu(),
                        np.float32).reshape(-1)
        if ew.shape[0] != g.num_edges:
            raise ValueError(f"edge_weight has {ew.shape[0]} entries, the "
                             f"graph {g.num_edges} edges")
    node_order = edge_perm = None
    if auto_reorder:
        g, node_order, edge_perm = _try_auto_reorder(g, bsr_tb)
        if edge_perm is not None and ew is not None:
            ew = ew[edge_perm]
    if dense is None:
        dense = g.num_nodes <= dense_threshold_nodes
    if pallas is None:
        pallas = not dense
    perm = None
    if csr and not g.receivers_sorted:
        g, perm = sort_by_receiver(g, return_perm=True)
        if ew is not None:
            ew = ew[perm]
    cache = dict(g.cache)
    if node_order is not None:
        cache["node_order"] = torch.as_tensor(node_order, dtype=torch.int32)
    if add_self_loops:
        cache["self_looped"] = True
        # where each original edge landed in the final (reordered, sorted)
        # edge order: slot k holds old edge edge_perm[perm[k]]; runtime
        # weights for the original edges are scattered there (loops get 1)
        comb = edge_perm
        if perm is not None:
            comb = perm if comb is None else np.asarray(comb)[perm]
        if comb is None:
            pos = np.arange(orig_edges)
        else:
            inv = np.empty(len(comb), np.int64)
            inv[comb] = np.arange(len(comb))
            pos = inv[:orig_edges]
        cache["orig_edge_pos"] = torch.as_tensor(pos, dtype=torch.int32)
    cache["in_degree"] = degree(
        g, torch.float32, direction="in",
        edge_weight=None if ew is None else torch.from_numpy(ew).to(
            g.device))
    if dense:
        cache["adj"] = to_dense_adjacency(g, dtype=adj_dtype)
    if csr:
        cache["csr_offsets"] = csr_offsets(g)
    if pallas:
        s, r = host_edges(g)
        n = g.num_nodes
        ns = g.num_senders if g.bipartite else n
        cache["tcsr"] = build_segment_csr(s, r, n, num_cols=ns,
                                          edge_weight=ew)
        cache["tcsr_rev"] = build_segment_csr(r, s, ns, num_cols=n,
                                              edge_weight=ew)
        cache["tcsr_edges"] = build_segment_csr(
            np.arange(g.num_edges, dtype=np.int64), r, n,
            num_cols=g.num_edges)
    g = g.copy(cache=cache)
    if bsr or (bsr is None and not dense and g.num_nodes >= 4 * bsr_tb):
        g = precompute_bsr(
            g, tb=bsr_tb, edge_weight=ew, dia=dia,
            max_bands=AUTO_REORDER_MAX_BANDS if node_order is not None else 16)
        if ((gcn_fused or (gcn_fused is None and add_self_loops))
                and any(k in g.cache for k in ("banded", "dia", "pbanded"))
                and "dia_rem" not in g.cache and edge_weight is None):
            g = g.copy(cache={**g.cache, **_normalized_storage(g)})
    return g.to(device)


def _normalized_storage(g: GnnGraph) -> dict:
    """The degree-normalized ``C·Ã·C`` (C = D^-1/2) of the structured
    storage ``g`` carries, and its transpose: the two per-stage degree
    scalings of the GCN right-hand side become stored values. The build
    takes that storage's parameters (dtype, block shape, and for dense
    bands their count as the cap), so it fits where the storage did."""
    d = g.cache["in_degree"].cpu().numpy().astype(np.float64)
    c = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-30)), 0.0)
    s, r = host_edges(g)
    n = g.num_nodes
    vals = (c[r] * c[s]).astype(np.float32)
    if "dia" in g.cache:
        dn = build_dia(s, r, n, edge_weight=vals,
                       dtype=g.cache["dia"].values.dtype)
        return {"dia_norm": dn, "dia_norm_rev": transpose_dia(dn)}
    if "pbanded" in g.cache:
        key, build, st = "pbanded", build_packed_banded, g.cache["pbanded"]
        kw = dict(tb=st.tb, tb_rows=st.row_height)
    else:
        key, build, st = "banded", build_banded, g.cache["banded"]
        kw = dict(tb=st.tb, max_bands=len(st.offsets))
    out = {key + "_norm": build(s, r, n, edge_weight=vals,
                                dtype=st.blocks.dtype, **kw),
           key + "_norm_rev": build(r, s, n, edge_weight=vals,
                                    dtype=st.blocks.dtype, **kw)}
    if None in out.values():
        raise RuntimeError(f"the degree-normalized {key} storage does not "
                           f"fit where {key} did")
    return out


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
    return segment_spmm(x, g.cache["tcsr"], csr_rev=g.cache.get("tcsr_rev"))


_STRUCTURED = ("dia", "banded", "pbanded", "bsr")


def spmm_structured(g: GnnGraph, x: torch.Tensor) -> torch.Tensor:
    """The ``bsr`` mode, in the JAX package's order: DIA stencil (plus the
    hybrid's COO remainder), packed block bands, dense block bands,
    block-sparse rows."""
    c = g.cache
    if "dia" in c:
        y = dia_spmm_stencil(x, c["dia"], c.get("dia_rev"))
        if "dia_rem" in c:
            y = y + dia_remainder_spmm(c["dia_rem"], x, g.num_nodes)
        return y
    if "pbanded" in c:
        return pbanded_spmm_pallas(x, c["pbanded"], c.get("pbanded_rev"))
    if "banded" in c:
        return banded_spmm_pallas(x, c["banded"], c.get("banded_rev"))
    return bsr_spmm(c["bsr"], x)


def spmm(g: GnnGraph, x: torch.Tensor,
         edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Receiver sum of (optionally weighted) sender features, dispatched per
    ``set_spmm_mode`` and the structure cached on ``g``; under a profiler,
    in an ``ngpde.dispatch.spmm.<mode>`` span of the mode taken."""
    mode = _SPMM_MODE
    weighted = edge_weight is not None
    two_d = x.dim() == 2
    # runtime weights cannot ride the stored values
    structured = (two_d and not weighted
                  and any(k in g.cache for k in _STRUCTURED))
    # the segment kernel's layout for this call (over the edges if weighted)
    segments = two_d and ("tcsr_edges" if weighted else "tcsr") in g.cache
    if mode == "auto":
        if "adj" in g.cache and not weighted:
            mode = "dense"
        elif structured:
            mode = "bsr"
        else:
            mode = "pallas" if segments and takes_kernels(x) else "xla"
    elif mode == "dense" and (weighted or "adj" not in g.cache):
        mode = "xla"
    elif mode == "pallas" and not segments:
        mode = "xla"
    elif mode == "bsr" and not structured:
        # the weighted segment kernel where it can run (JAX: "the backend
        # is a TPU")
        mode = "pallas" if weighted and segments and x.is_cuda else "xla"
    with annotate(_SPANS[mode]):
        if mode == "dense":
            return spmm_dense(g, x)
        if mode == "bsr":
            return spmm_structured(g, x)
        if mode == "pallas":
            if weighted:  # weighted messages, summed over the edge layout
                return segment_sum_pallas(g, x.index_select(0, g.senders)
                                          * edge_weight.reshape(-1, 1))
            return spmm_pallas(g, x)
        return spmm_xla(g, x, edge_weight)
