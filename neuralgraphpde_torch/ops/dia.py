"""Scalar-diagonal (DIA / stencil) sparse storage (counterpart of
``neuralgraphpde.ops.dia``: full DIA, and the hybrid of DIA and a small COO
remainder).

A regular grid's adjacency has all nonzeros on a few scalar diagonals: the
8-neighbour grid with self-loops has exactly 9 offsets. DIA stores one value
per edge, ``values[i, k] = A[i, i + offsets[k]]``, and the SpMM becomes a
stencil ``out[i] = Σ_k values[i, k] · x[i + offsets[k]]``: no gather, no
scatter. The host build is the JAX package's numpy code, so both packages
hold identical value sheets, padded to a multiple of 512 rows.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class DiaMatrix:
    """``values[i, k] = A[i, i + offsets[k]]`` (0 where absent or out of
    range). ``num_nodes`` rows, stored padded to ``padded_nodes``."""

    values: torch.Tensor  # (padded_nodes, K) f32 or bf16
    offsets: tuple  # ascending scalar offsets
    num_nodes: int
    # the offsets as an int32 tensor beside ``values``, read by the kernel
    offsets_t: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.offsets_t is None:
            object.__setattr__(self, "offsets_t", torch.tensor(
                self.offsets, dtype=torch.int32, device=self.values.device))

    @property
    def padded_nodes(self) -> int:
        return self.values.shape[0]

    @property
    def bandwidth(self) -> int:
        return max(abs(d) for d in self.offsets) if self.offsets else 0

    def to(self, device) -> "DiaMatrix":
        return DiaMatrix(self.values.to(device), self.offsets, self.num_nodes,
                         self.offsets_t.to(device))


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Which DIA form ``precompute_bsr`` should build, from one pass over
    the ``sender − receiver`` offsets."""

    full_ok: bool  # few enough distinct offsets for full DIA
    full_bw: int  # bandwidth of full DIA (max |offset|)
    hybrid_ok: bool  # a kept-diagonals + small-remainder split exists
    hybrid_bw: int  # bandwidth of the kept diagonals


def plan_dia(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    max_diags: int = 32,
    bw_limit: int = 8192,
    min_fill: float = 0.25,
    rem_frac: float = 0.05,
) -> Optional[DiaPlan]:
    """Build decision, with the JAX package's gates: full DIA takes at most
    ``max_diags`` offsets; the hybrid keeps diagonals with |offset| ≤
    ``bw_limit`` and fill ≥ ``min_fill``·N and spills 0 < rem ≤
    ``rem_frac``·E edges."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    E = senders.shape[0]
    if E == 0:
        return None
    d = senders - receivers
    offsets, counts = np.unique(d, return_counts=True)
    full_ok = len(offsets) <= max_diags
    full_bw = int(np.abs(offsets).max())
    good = (np.abs(offsets) <= bw_limit) & (counts >= min_fill * num_nodes)
    if good.sum() > max_diags:
        order = np.argsort(np.where(good, counts, -1))[::-1][:max_diags]
        good = np.zeros_like(good)
        good[order] = True
    hybrid_ok, hybrid_bw = False, 0
    if good.any():
        n_rem = int(counts[~good].sum())
        hybrid_ok = 0 < n_rem <= rem_frac * E
        hybrid_bw = int(np.abs(offsets[good]).max())
    return DiaPlan(full_ok=full_ok, full_bw=full_bw,
                   hybrid_ok=hybrid_ok, hybrid_bw=hybrid_bw)


def build_dia(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    edge_weight: Optional[np.ndarray] = None,
    max_diags: int = 32,
    tile: int = 512,
    dtype=torch.float32,
) -> Optional[DiaMatrix]:
    """Host DIA build; None when the graph has more than ``max_diags``
    distinct ``sender − receiver`` offsets. Duplicate edges accumulate."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    E = senders.shape[0]
    w = (np.ones(E, np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32).reshape(-1))
    d = senders - receivers
    offsets = np.unique(d)
    if len(offsets) > max_diags:
        return None
    n_pad = -(-num_nodes // tile) * tile
    vals = np.zeros((n_pad, len(offsets)), np.float32)
    k = np.searchsorted(offsets, d)
    np.add.at(vals, (receivers, k), w)
    return DiaMatrix(values=torch.from_numpy(vals).to(dtype),
                     offsets=tuple(int(o) for o in offsets),
                     num_nodes=num_nodes)


class DiaRemainder(NamedTuple):
    """The COO edges a hybrid DIA leaves out (``cache['dia_rem']``),
    receiver-sorted: ``(senders, receivers, weights)``."""

    senders: torch.Tensor  # (R,) int32
    receivers: torch.Tensor  # (R,) int32
    weights: torch.Tensor  # (R,) f32

    def to(self, device) -> "DiaRemainder":
        return DiaRemainder(*(t.to(device) for t in self))


def build_dia_hybrid(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    edge_weight: Optional[np.ndarray] = None,
    max_diags: int = 32,
    tile: int = 512,
    dtype=torch.float32,
    bw_limit: int = 8192,
    min_fill: float = 0.25,
    rem_frac: float = 0.05,
):
    """Almost-DIA graphs (a periodic grid: the stencil plus its wrap
    edges): keep the populous diagonals the stencil kernel reaches (fill ≥
    ``min_fill``·N, |offset| ≤ ``bw_limit``) and spill every other edge to a
    receiver-sorted COO remainder. Returns ``(DiaMatrix, DiaRemainder)``, or
    None when no diagonal is kept, nothing is left over, or the remainder
    exceeds ``rem_frac``·E. The JAX package's numpy code, so the arrays are
    identical."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    E = senders.shape[0]
    if E == 0:
        return None
    w = (np.ones(E, np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32).reshape(-1))
    d = senders - receivers
    offsets, inv, counts = np.unique(d, return_inverse=True,
                                     return_counts=True)
    good = (np.abs(offsets) <= bw_limit) & (counts >= min_fill * num_nodes)
    if good.sum() > max_diags:
        # most populous first among the eligible
        order = np.argsort(np.where(good, counts, -1))[::-1][:max_diags]
        good = np.zeros_like(good)
        good[order] = True
    if not good.any():
        return None
    keep_edge = good[inv.reshape(-1)]
    rem = ~keep_edge
    n_rem = int(rem.sum())
    if n_rem == 0 or n_rem > rem_frac * E:
        return None
    dm = build_dia(senders[keep_edge], receivers[keep_edge], num_nodes,
                   edge_weight=w[keep_edge], max_diags=max_diags, tile=tile,
                   dtype=dtype)
    if dm is None:
        return None
    rs, rr, rw = senders[rem], receivers[rem], w[rem]
    order = np.argsort(rr, kind="stable")
    return dm, DiaRemainder(
        torch.from_numpy(rs[order].astype(np.int32)),
        torch.from_numpy(rr[order].astype(np.int32)),
        torch.from_numpy(rw[order].astype(np.float32)))


def dia_remainder_spmm(rem: DiaRemainder, x: torch.Tensor,
                       num_nodes: int) -> torch.Tensor:
    """The remainder term ``Σ_{e ∉ DIA} w_e · x[s_e] → r_e``: a gather and
    an ``index_add_``, differentiated by autograd (JAX differentiates its
    gather + segment-sum the same way)."""
    rs, rr, rw = rem
    msgs = rw[:, None].to(x.dtype) * x.index_select(0, rs)
    out = msgs.new_zeros((num_nodes, x.shape[1]))
    return out.index_add_(0, rr, msgs)


def transpose_dia(dm: DiaMatrix) -> DiaMatrix:
    """Aᵀ: offset ``−d`` holds the values of offset ``d`` shifted by ``d``
    rows (``valuesᵀ[j] = values[j − d]``)."""
    K = len(dm.offsets)
    n_pad = dm.padded_nodes
    offs = [-d for d in dm.offsets]
    order = sorted(range(K), key=lambda i: offs[i])
    cols = []
    for i in order:
        d = dm.offsets[i]
        src = dm.values[:, i]
        zeros = src.new_zeros(abs(d))
        if d > 0:
            col = torch.cat([zeros, src[: n_pad - d]])
        elif d < 0:
            col = torch.cat([src[-d:], zeros])
        else:
            col = src
        cols.append(col)
    return DiaMatrix(values=torch.stack(cols, dim=1),
                     offsets=tuple(offs[i] for i in order),
                     num_nodes=dm.num_nodes)


def stencil_f32(dm: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """``Σ_k values[:, k] · x[i + offsets[k]]`` over the ``num_nodes`` rows,
    accumulated in f32; neighbours outside ``[0, num_nodes)`` contribute
    nothing."""
    n = dm.num_nodes
    vals = dm.values[:n].float()
    xf = x.float()
    acc = xf.new_zeros((n, x.shape[1]))
    for k, d in enumerate(dm.offsets):
        lo, hi = max(0, -d), min(n, n - d)
        if lo < hi:
            acc[lo:hi] += vals[lo:hi, k:k + 1] * xf[lo + d:hi + d]
    return acc


def dia_spmm(dm: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain stencil SpMM ``A @ x`` in x's dtype (f32 accumulation)."""
    return stencil_f32(dm, x).to(x.dtype)
