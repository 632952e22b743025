"""K1: receiver segment-SpMM ``out[i] = Σ_{e: r_e = i} w_e · x[s_e]``, and
K6: receiver segment-max ``out[i] = max_{e: r_e = i} m_e``.

K1 replaces ``neuralgraphpde/kernels/segment_kernels.py::
_tiled_segment_spmm_fwd`` (the Pallas one-hot MXU kernel behind
``tiled_segment_spmm``). CUDA source:
``neuralgraphpde_torch/csrc/segment_spmm.cu``. ``segment_spmm`` is
differentiable: its backward is the same kernel on the transposed layout
(``_spmm_bwd`` in the JAX package).

What bounds it on the H100: bytes. Each edge reads one sender row of x
(F·itemsize bytes, a random row: the gather), its index and weight (8 bytes);
each row writes F·out_itemsize bytes once. There are 2 flops per gathered
element, far below the ridge point, so the kernel is a gather at memory
speed. The TPU kernel's one-hot matrices exist to feed the MXU; on Hopper
there is nothing to feed, so the layout is a plain receiver-sorted CSR:

- one warp per receiver row; its lanes split the row's features in 16-byte
  vectors (4 f32 or 8 bf16), so one edge's row read is coalesced;
- when a row has fewer vectors than 32, the warp's lanes split into groups
  that take every ``groups``-th edge, and a shuffle tree adds the groups;
- f32 accumulation in registers, one store per row, no atomics: the result
  is deterministic.

``compute_dtype=torch.bfloat16`` halves the gather bytes (bf16 reads, f32
accumulate); the output keeps x's dtype. This argument replaces the JAX
package's process-global ``set_kernel_compute_dtype``.

K6 replaces ``segment_kernels.py::_tiled_segment_max_fwd`` (the Pallas
segmented max-scan behind ``tiled_segment_max``). CUDA source:
``neuralgraphpde_torch/csrc/segment_max.cu``, one warp per receiver row of
the edge-id layout (``tcsr_edges``), a running max in registers, no
atomics: max is order-free, so the kernel equals its plain version exactly.
Empty rows get ``-inf``; a NaN message makes its row's entry NaN (the
``xla`` path's ``scatter_reduce_`` amax does the same).

- ``segment_max``: the kernel wrapper (forward, outside autograd); CPU
  tensors take ``segment_max_plain`` (``scatter_reduce_`` amax).
- ``segment_max_aggregate``: the differentiable call, a
  ``torch.autograd.Function`` on every device. Its backward is the JAX
  custom VJP's rule (``segment_kernels.py:456-462``), computed with torch
  ops as JAX computes it outside Pallas: the full cotangent goes to every
  edge whose message equals its receiver's maximum, ties included
  (``scatter_reduce_``'s own gradient, like ``jax.ops.segment_max``'s,
  splits it among ties instead).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import _build


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentCSR:
    """Receiver-sorted CSR: row ``i`` sums ``weight[e] * x[col[e]]`` over
    ``row_ptr[i] <= e < row_ptr[i + 1]``; within a row, slots are sorted by
    column for gather locality."""

    row_ptr: torch.Tensor  # (num_rows + 1,) int32
    col: torch.Tensor  # (E,) int32: the x row each slot reads
    weight: torch.Tensor  # (E,) f32
    rows: torch.Tensor  # (E,) int64: the output row of each slot
    num_rows: int  # output rows
    num_cols: int  # rows of x

    def to(self, device) -> "SegmentCSR":
        return SegmentCSR(self.row_ptr.to(device), self.col.to(device),
                          self.weight.to(device), self.rows.to(device),
                          self.num_rows, self.num_cols)


def build_segment_csr(senders: np.ndarray, receivers: np.ndarray,
                      num_rows: int, *, num_cols: Optional[int] = None,
                      edge_weight: Optional[np.ndarray] = None) -> SegmentCSR:
    """Host build of the K1 layout for edges ``senders -> receivers``.
    ``num_cols`` (rows of x) defaults to ``num_rows``."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    w = (np.ones(len(s), np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32).reshape(-1))
    order = np.lexsort((s, r))
    s, r, w = s[order], r[order], w[order]
    counts = np.bincount(r, minlength=num_rows)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return SegmentCSR(
        row_ptr=torch.from_numpy(row_ptr),
        col=torch.from_numpy(s.astype(np.int32)),
        weight=torch.from_numpy(np.ascontiguousarray(w)),
        rows=torch.from_numpy(r),
        num_rows=num_rows,
        num_cols=num_rows if num_cols is None else num_cols)


def segment_spmm_plain(x: torch.Tensor, csr: SegmentCSR) -> torch.Tensor:
    """Plain PyTorch version of K1: gather, weight, ``index_add_``; f32
    result."""
    msgs = x.index_select(0, csr.col).float() * csr.weight[:, None]
    out = msgs.new_zeros((csr.num_rows, x.shape[1]))
    return out.index_add_(0, csr.rows, msgs)


_DTYPES = (torch.float32, torch.bfloat16)


def _segment_spmm_launch(x: torch.Tensor, csr: SegmentCSR,
                         out_dtype: torch.dtype,
                         backward: bool = False) -> torch.Tensor:
    """One K1 call outside autograd (CPU tensors: the plain version)."""
    if x.dim() != 2 or x.shape[0] != csr.num_cols:
        raise ValueError(f"x must be ({csr.num_cols}, F), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"segment_spmm takes f32/bf16, got {x.dtype} -> "
                        f"{out_dtype}")
    if x.device.type == "cpu":
        return segment_spmm_plain(x, csr).to(out_dtype)
    _check_cuda_inputs(x, csr.row_ptr, csr.col, csr.weight)
    F = x.shape[1]
    out = torch.empty((csr.num_rows, F), dtype=out_dtype, device=x.device)
    vec = 16 // x.element_size()
    if F % vec or x.data_ptr() % 16:
        vec = 1
    lib = _build.library()
    err = lib.ngpde_segment_spmm(
        csr.row_ptr.data_ptr(), csr.col.data_ptr(), csr.weight.data_ptr(),
        x.data_ptr(), out.data_ptr(), csr.num_rows, F,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "segment_spmm")
    segment_spmm.launches += 1
    segment_spmm.backward_launches += int(backward)
    return out


class _SegmentSpmm(torch.autograd.Function):
    """K1 under autograd. The backward is K1 on the transposed layout
    (``tcsr_rev``), as ``_spmm_bwd`` in the JAX package; without one (the
    edge-id layout) it is the gather ``w_e · g[r_e]`` summed onto the
    columns, which JAX also computes outside its kernel."""

    @staticmethod
    def forward(ctx, x, csr, csr_rev, compute_dtype):
        ctx.csr, ctx.csr_rev = csr, csr_rev
        return _segment_spmm_launch(x.to(compute_dtype or x.dtype), csr,
                                    x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        csr, csr_rev = ctx.csr, ctx.csr_rev
        g = g.contiguous()
        if csr_rev is not None:
            gx = _segment_spmm_launch(g, csr_rev, g.dtype, backward=True)
        else:
            msgs = g.index_select(0, csr.rows).float() * csr.weight[:, None]
            gx = msgs.new_zeros((csr.num_cols, g.shape[1])).index_add_(
                0, csr.col.to(torch.int64), msgs).to(g.dtype)
        return gx, None, None, None


def segment_spmm(x: torch.Tensor, csr: SegmentCSR,
                 compute_dtype: Optional[torch.dtype] = None,
                 csr_rev: Optional[SegmentCSR] = None) -> torch.Tensor:
    """``out[i] = Σ_{e in row i} w_e · x[col_e]`` as ``(num_rows, F)`` in
    x's dtype. ``compute_dtype`` is the dtype x is read in (default: x's).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Differentiable: when x requires grad the call is an
    ``autograd.Function`` whose backward is K1 on ``csr_rev`` (the
    transposed layout, ``cache['tcsr_rev']``)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SegmentSpmm.apply(x, csr, csr_rev, compute_dtype)
    out_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    return _segment_spmm_launch(x, csr, out_dtype)


segment_spmm.launches = 0
segment_spmm.backward_launches = 0


def segment_max_plain(m: torch.Tensor, csr: SegmentCSR) -> torch.Tensor:
    """Plain PyTorch version of K6: every slot's message row, then
    ``scatter_reduce_`` amax onto a ``-inf`` output (include_self)."""
    vals = m.index_select(0, csr.col)
    out = vals.new_full((csr.num_rows, m.shape[1]), float("-inf"))
    idx = csr.rows.reshape(-1, 1).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, "amax", include_self=True)


def segment_max(m: torch.Tensor, csr: SegmentCSR) -> torch.Tensor:
    """``out[i] = max_{s in row i} m[col_s]`` as ``(num_rows, F)`` in m's
    dtype (f32 or bf16: bf16 messages are compared in f32, exactly) over
    the edge-id layout ``csr``, outside autograd; ``-inf`` for a row with
    no slot. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if m.dim() != 2 or m.shape[0] != csr.num_cols:
        raise ValueError(f"m must be ({csr.num_cols}, F), got "
                         f"{tuple(m.shape)}")
    if m.dtype not in _DTYPES:
        raise TypeError(f"segment_max takes f32 or bf16, got {m.dtype}")
    if m.device.type == "cpu":
        return segment_max_plain(m, csr)
    _check_cuda_inputs(m, csr.row_ptr, csr.col)
    F = m.shape[1]
    out = torch.empty((csr.num_rows, F), dtype=m.dtype, device=m.device)
    vec = 16 // m.element_size()
    if F % vec or m.data_ptr() % 16:
        vec = 1
    bf16 = m.dtype == torch.bfloat16
    err = _build.library().ngpde_segment_max(
        csr.row_ptr.data_ptr(), csr.col.data_ptr(), m.data_ptr(),
        out.data_ptr(), csr.num_rows, F, int(bf16), vec,
        torch.cuda.current_stream(m.device).cuda_stream)
    _build.check(err, "segment_max")
    segment_max.launches += 1
    segment_max.bf16_launches += int(bf16)
    return out


segment_max.launches = 0
segment_max.bf16_launches = 0


def segment_max_bwd(m: torch.Tensor, out: torch.Tensor,
                    receivers: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The VJP of the segment max: ``g[r_e]`` for every edge ``e`` whose
    message equals its receiver's maximum (every tied edge gets all of it),
    0 elsewhere."""
    recv = receivers.to(torch.int64)
    winners = m == out.index_select(0, recv)
    return torch.where(winners, g.index_select(0, recv),
                       torch.zeros((), dtype=g.dtype, device=g.device))


class _SegmentMax(torch.autograd.Function):
    """K6 (or its plain version on the CPU) under autograd, with the JAX
    kernel's tie rule in the backward."""

    @staticmethod
    def forward(ctx, m, csr, receivers):
        out = segment_max(m, csr)
        ctx.save_for_backward(m, out, receivers)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        m, out, receivers = ctx.saved_tensors
        return segment_max_bwd(m, out, receivers, g), None, None


def segment_max_aggregate(m: torch.Tensor, csr: SegmentCSR,
                          receivers: torch.Tensor) -> torch.Tensor:
    """Differentiable ``out[i] = max_{e: r_e = i} m_e`` over the edge-id
    layout ``csr`` (``g.cache['tcsr_edges']`` of a receiver-sorted graph);
    ``receivers`` is the graph's ``(E,)`` receiver array, which routes the
    cotangent to the arg-max edges."""
    return _SegmentMax.apply(m, csr, receivers)


def _check_cuda_inputs(x: torch.Tensor, *tensors: torch.Tensor) -> None:
    """A CUDA call takes contiguous tensors on one card, outside autograd
    (each differentiable wrapper launches from an ``autograd.Function``,
    whose forward runs with grad off; ``segment_max`` alone is
    forward-only)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    for t in (x,) + tensors:
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("this CUDA kernel wrapper is forward-only: "
                               "call its autograd function, or run under "
                               "torch.no_grad()")
