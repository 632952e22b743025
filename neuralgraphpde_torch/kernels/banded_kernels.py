"""K4 and K7: block-band SpMM and the fused GCN right-hand side.

Replaces four Pallas kernels of ``neuralgraphpde/kernels/banded_kernels.py``
that share one body: ``_banded_spmm_fwd`` and ``_banded_rhs_fwd`` (dense
block diagonals, K7) and ``_pbanded_spmm_fwd`` and ``_pbanded_rhs_fwd``
(packed block bands, K4). They differ only in where a slot's x block comes
from (the diagonal ``clip(i + offsets[k])`` or the packed ``cols[i, s]``);
both storages carry a ``cols`` table here (``ops/bsr.py``), so one CUDA
body serves all four: ``neuralgraphpde_torch/csrc/banded.cu``. It walks the
storage's ``SubTileIndex`` (``st.tiles``), its occupied 32 × 32 sub-tiles
only; a CUDA storage without one raises.

- ``banded_spmm_pallas`` / ``pbanded_spmm_pallas``: ``A @ x`` in x's
  dtype.
- ``banded_gcn_rhs`` / ``pbanded_gcn_rhs``: ``act((Ĉ x) · W + b)`` with Ĉ
  the degree-normalized storage (``cache['banded_norm']`` /
  ``['pbanded_norm']``); ``W`` and ``b`` may be None (the out < in
  pre-multiply passes ``x @ W`` and no W); f32 out.

Each is an ``autograd.Function`` with the JAX package's VJPs: the SpMM's
backward is the kernel on the transposed storage (``*_rev``); the fused
right-hand side's saves y, recomputes the aggregate with the SpMM kernel for
``dW = aggᵀ dz``, and runs the SpMM kernel on ``*_norm_rev`` for ``dx``
(both SpMM launches, counted on the SpMM wrapper as backward launches).
The packed backward raises without its transpose, as JAX's does; the dense
one transposes the bands on the fly. CPU tensors take the plain version
(``ops.bsr.block_spmm_f32``); a CUDA tensor launches the kernel or raises.

What bounds the kernel on the H100, and its design: ``csrc/banded.cu``.
bf16 storage reads x in bf16 and W in bf16 and accumulates in f32, as the
TPU kernels do; the aggregate is rounded to bf16 before the W product.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.bsr import (BandedMatrix, PackedBanded, block_spmm_f32,
                       transpose_banded)
from . import _build
from .dia_kernels import (_ACT_CODES, _ACTS, act_grad_from_y,
                          epilogue_supported, needs_grad)
from .segment_kernels import _check_cuda_inputs

TF_MAX = 512  # widest fused input the kernel's shared-memory rows hold


def block_rhs_plain(st, x: torch.Tensor, w: Optional[torch.Tensor],
                    b: Optional[torch.Tensor], act,
                    fused: bool) -> torch.Tensor:
    """Plain PyTorch version of K4/K7 with the kernel's rounding points (x
    and W already in the storage's dtype); f32 out."""
    h = block_spmm_f32(st, x)
    if not fused:
        return h
    if w is not None:
        h = h.to(w.dtype).float() @ w.float()
    if b is not None:
        h = h + b.float()
    return _ACTS[act](h)


def _check_index(st, idx) -> None:
    """Raise unless ``idx`` has the shape of an index of ``st``'s blocks
    (O(1): the kernel reads ``ptr`` at every output tile and takes each
    entry as a slot and chunk of these blocks)."""
    S, nb, tbr, tb = st.blocks.shape
    tiles = -(-tbr // idx.rows)
    listable = nb * tiles * S * -(-tb // idx.cols)
    if (idx.ptr.dtype != torch.int32 or idx.ent.dtype != torch.int32
            or idx.ptr.shape != (nb * tiles + 1,)
            or idx.ent.dim() != 1 or idx.ent.numel() > listable):
        raise ValueError(
            f"sub-tile index (ptr {tuple(idx.ptr.shape)}, ent "
            f"{tuple(idx.ent.shape)}) was not made for blocks "
            f"{tuple(st.blocks.shape)}")


def _block_call(st, x: torch.Tensor, w: Optional[torch.Tensor],
                b: Optional[torch.Tensor], act, fused: bool, owner,
                backward: bool = False) -> torch.Tensor:
    """One K4/K7 call outside autograd, counted on ``owner``; f32 out."""
    n = st.num_nodes
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"x must be ({n}, F), got {tuple(x.shape)}")
    bdt = st.blocks.dtype
    if bdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block values must be f32 or bf16, got {bdt}")
    x = x.to(bdt).contiguous()
    F = x.shape[1]
    out_w = F
    if fused:
        if F > TF_MAX:
            raise ValueError(f"fused block-band kernel takes F ≤ {TF_MAX}, "
                             f"got {F}")
        if not epilogue_supported(act):
            raise ValueError(f"no fused epilogue for activation {act!r}")
        if w is not None:
            if w.dim() != 2 or w.shape[0] != F:
                raise ValueError(f"W must be ({F}, out), got {tuple(w.shape)}")
            w = (w.to(torch.bfloat16) if bdt == torch.bfloat16
                 else w.float()).contiguous()
            out_w = w.shape[1]
        if b is not None:
            b = b.float().reshape(-1).contiguous()
            if b.shape[0] != out_w:
                raise ValueError(f"b must have {out_w} entries")
    idx = st.tiles
    if idx is not None:
        _check_index(st, idx)
    if x.device.type == "cpu":
        return block_rhs_plain(st, x, w, b, act, fused)
    if idx is None:
        raise ValueError("block-band storage without its sub-tile index "
                         "(tiles): make it with ops.bsr.build_banded, "
                         "build_packed_banded or transpose_banded")
    _check_cuda_inputs(x, st.blocks, st.cols, idx.ptr, idx.ent,
                       *[t for t in (w, b) if t is not None])
    out = torch.empty((n, out_w), dtype=torch.float32, device=x.device)
    band = (st.blocks.data_ptr(), st.cols.data_ptr(), idx.ptr.data_ptr(),
            idx.ent.data_ptr(), idx.rows, idx.cols, st.blocks.shape[0], st.nb,
            st.row_height, st.tb, x.data_ptr())
    code = _ACT_CODES[act] if fused else 0
    bf16 = int(bdt == torch.bfloat16)
    b_ptr = None if b is None else b.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.library()
    if w is None:
        err = lib.ngpde_block_spmm(*band, n, F, b_ptr, out.data_ptr(), code,
                                   bf16, stream)
    else:
        err = lib.ngpde_block_gcn_rhs(*band, w.data_ptr(), b_ptr,
                                      out.data_ptr(), n, F, out_w, code, bf16,
                                      stream)
    _build.check(err, owner.__name__)
    owner.launches += 1
    owner.backward_launches += int(backward)
    return out


def _transpose(st, st_rev):
    """Aᵀ for a backward: the prebuilt transpose, else the dense bands
    transposed on the fly; packed bands have no on-the-fly transpose."""
    if st_rev is not None:
        return st_rev
    if isinstance(st, PackedBanded):
        raise NotImplementedError(
            "pbanded backward needs the prebuilt transpose (pb_rev); "
            "ops.precompute stores cache['pbanded_rev']")
    return transpose_banded(st)


class _BlockSpmm(torch.autograd.Function):
    """``A @ x``; the backward is the same kernel on Aᵀ."""

    @staticmethod
    def forward(ctx, x, st, st_rev, owner):
        ctx.st, ctx.st_rev, ctx.owner = st, st_rev, owner
        return _block_call(st, x, None, None, None, False, owner).to(x.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        stt = _transpose(ctx.st, ctx.st_rev)
        gx = _block_call(stt, g, None, None, None, False, ctx.owner, True)
        return gx.to(g.dtype), None, None, None


class _BlockGcnRhs(torch.autograd.Function):
    """Fused ``act((Ĉ x) · W + b)``; the backward is ``_rhs_vjp_bwd`` /
    ``_prhs_vjp_bwd`` of the JAX package."""

    @staticmethod
    def forward(ctx, x, w, b, st, st_rev, act, owner):
        y = _block_call(st, x, w, b, act, True, owner)
        ctx.save_for_backward(x, w, b, y)
        ctx.st, ctx.st_rev, ctx.act = st, st_rev, act
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, b, y = ctx.saved_tensors
        st = ctx.st
        dz = g.float() * act_grad_from_y(ctx.act, y)
        db = None if b is None else dz.sum(0).reshape(b.shape).to(b.dtype)
        # the backward's products are SpMM launches, counted on the SpMM
        spmm_owner = (pbanded_spmm_pallas if isinstance(st, PackedBanded)
                      else banded_spmm_pallas)
        dw = None
        gup = dz
        if w is not None:
            # the aggregate again (one more pass) for dW
            agg = _block_call(st, x, None, None, None, False, spmm_owner, True)
            dw = (agg.t() @ dz).to(w.dtype)
            gup = dz @ w.float().t()
        stt = _transpose(st, ctx.st_rev)
        dx = _block_call(stt, gup, None, None, None, False, spmm_owner, True)
        return dx.to(x.dtype), dw, db, None, None, None, None


def _spmm(x, st, st_rev, owner):
    if needs_grad(x):
        return _BlockSpmm.apply(x, st, st_rev, owner)
    return _block_call(st, x, None, None, None, False, owner).to(x.dtype)


def _rhs(act, x, w, b, st, st_rev, owner):
    if needs_grad(x, w, b):
        return _BlockGcnRhs.apply(x, w, b, st, st_rev, act, owner)
    return _block_call(st, x, w, b, act, True, owner)


def banded_spmm_pallas(x: torch.Tensor, bm: BandedMatrix,
                       bm_rev: Optional[BandedMatrix] = None) -> torch.Tensor:
    """Dense block-band SpMM ``A @ x`` (K7), in x's dtype; ``bm_rev`` (Aᵀ,
    ``cache['banded_rev']``) makes the backward a second kernel pass."""
    return _spmm(x, bm, bm_rev, banded_spmm_pallas)


def pbanded_spmm_pallas(x: torch.Tensor, pb: PackedBanded,
                        pb_rev: Optional[PackedBanded] = None
                        ) -> torch.Tensor:
    """Packed block-band SpMM ``A @ x`` (K4), in x's dtype; the backward
    needs ``pb_rev`` (Aᵀ, ``cache['pbanded_rev']``)."""
    return _spmm(x, pb, pb_rev, pbanded_spmm_pallas)


def banded_gcn_rhs(act, x: torch.Tensor, w: Optional[torch.Tensor],
                   b: Optional[torch.Tensor], bm: BandedMatrix,
                   bm_rev: Optional[BandedMatrix] = None) -> torch.Tensor:
    """Fused GCN right-hand side on dense block bands (K7), f32 out."""
    return _rhs(act, x, w, b, bm, bm_rev, banded_gcn_rhs)


def pbanded_gcn_rhs(act, x: torch.Tensor, w: Optional[torch.Tensor],
                    b: Optional[torch.Tensor], pb: PackedBanded,
                    pb_rev: Optional[PackedBanded] = None) -> torch.Tensor:
    """Fused GCN right-hand side on packed block bands (K4), f32 out; the
    backward needs ``pb_rev`` (``cache['pbanded_norm_rev']``)."""
    return _rhs(act, x, w, b, pb, pb_rev, pbanded_gcn_rhs)


for _fn in (banded_spmm_pallas, pbanded_spmm_pallas, banded_gcn_rhs,
            pbanded_gcn_rhs):
    _fn.launches = 0
    _fn.backward_launches = 0
