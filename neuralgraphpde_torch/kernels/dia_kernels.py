"""K2: DIA stencil SpMM and the fused GCN right-hand side.

Replaces ``neuralgraphpde/kernels/dia_kernels.py::_dia_rhs_fwd`` (the Pallas
kernel behind ``dia_spmm_pallas`` and ``dia_gcn_rhs``). CUDA source:
``neuralgraphpde_torch/csrc/dia_stencil.cu``.

- ``dia_spmm_stencil``: ``out[i] = Σ_k values[i, k] · x[i + offsets[k]]``.
- ``dia_gcn_rhs``: ``act((Ĉ x) · W + b)`` with Ĉ = C·Ã·C stored as the DIA
  values (``cache['dia_norm']``): the whole GCN ODE right-hand side in one
  kernel; ``W`` and ``b`` may be None.

Both are differentiable (``autograd.Function``s whose backward runs the
stencil kernel on the transposed values, ``dia_rev`` / ``dia_norm_rev``, as
the JAX package's custom VJPs do; those launches count on
``dia_spmm_stencil`` as backward launches).

What bounds it on the H100: the stencil reads x about once from device
memory (the ±bandwidth rows a block touches stay in L2), K values per row
and writes one output row: bytes, at a few flops per byte. The fused W
product adds 2·F·out flops per row on the CUDA cores (f32: the tensor cores
would round to TF32). The TPU kernel assembled a VMEM window of x from
halo blocks and relied on zero-padded values at the boundary; here each
block reads x in place and masks neighbours outside ``[0, N)`` itself, so x
is never padded or copied. A thread aggregates a few consecutive rows (4
in the stencil, 8 in the fused form) of one 16-byte feature vector, and
loads the x rows of each run of consecutive offsets (``offset_runs``) once
for all of them. The fused form is
persistent: each block stages W once in shared memory (or streams it in
k-tiles when it does not fit), aggregates 64-row tiles into shared memory
and multiplies them by W with 8 × 8 outputs a thread, so the aggregate
never goes to device memory.

bf16 follows the TPU kernel: x is read in the values' dtype, W is cast to
bf16 when the values are bf16, the f32 accumulator is rounded to bf16 before
the W product, and the output is bf16 when the caller's x is bf16.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..ops.dia import DiaMatrix, stencil_f32, transpose_dia
from . import _build
from .segment_kernels import _check_cuda_inputs

TF_MAX = 512  # widest fused input (a 64-row tile of it in shared memory)
MAX_DIAGS = 32
MAX_BANDWIDTH = 8192
RUN_MAX = 4  # longest offset run the kernel reads at once (kLmax there)

_ACTS = {
    None: lambda h: h,
    "identity": lambda h: h,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}
_ACT_CODES = {None: 0, "identity": 0, "tanh": 1, "relu": 2, "sigmoid": 3}


def epilogue_supported(act) -> bool:
    """Activations the fused kernel applies (a callable takes the exact
    path)."""
    return act is None or (isinstance(act, str) and act in _ACT_CODES)


def offset_runs(offsets, max_len: int = RUN_MAX) -> tuple:
    """Cut the offsets into runs of consecutive values, each at most
    ``max_len`` long, in their order: ``((k0, length), ...)``, run ``q``
    covering ``offsets[k0 : k0 + length]``. An offset with no neighbour in
    its run is a run of length 1. The 8-neighbour grid's 9 offsets make 3
    runs: (−w−1, −w, −w+1), (−1, 0, 1), (w−1, w, w+1)."""
    runs = []
    for k, d in enumerate(offsets):
        if runs and d == offsets[k - 1] + 1 and runs[-1][1] < max_len:
            runs[-1][1] += 1
        else:
            runs.append([k, 1])
    return tuple(tuple(run) for run in runs)


@functools.lru_cache(maxsize=256)
def _runs_arg(offsets: tuple):
    """``offset_runs`` as the kernel's host argument: a C int array of
    (k0, length) pairs and their count."""
    flat = [v for run in offset_runs(offsets) for v in run]
    return (ctypes.c_int * max(len(flat), 1))(*flat), len(flat) // 2


def dia_rhs_plain(dm: DiaMatrix, x: torch.Tensor, w: Optional[torch.Tensor],
                  b: Optional[torch.Tensor], act, fused: bool,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of K2 with the kernel's rounding points (x
    already in the values' dtype, W already cast)."""
    acc = stencil_f32(dm, x)
    if not fused:
        return acc.to(out_dtype)
    h = acc
    if w is not None:
        h = h.to(w.dtype).float() @ w.float()
    if b is not None:
        h = h + b.float()
    return _ACTS[act](h).to(out_dtype)


def act_grad_from_y(act, y: torch.Tensor):
    """The activation's derivative from its output (the VJPs save only y):
    tanh' = 1 − y², sigmoid' = y(1 − y), relu' = [y > 0]."""
    if act in (None, "identity"):
        return 1.0
    if act == "tanh":
        return 1.0 - y * y
    if act == "sigmoid":
        return y * (1.0 - y)
    if act == "relu":
        return (y > 0).to(y.dtype)
    raise ValueError(act)


def needs_grad(*tensors) -> bool:
    """Whether a call must go through its ``autograd.Function``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _dia_rhs(dm: DiaMatrix, x: torch.Tensor, w: Optional[torch.Tensor],
             b: Optional[torch.Tensor], act, fused: bool,
             out_dtype: torch.dtype, owner, backward: bool = False
             ) -> torch.Tensor:
    """One K2 call outside autograd, counted on ``owner`` (CPU tensors:
    the plain version)."""
    n, K = dm.num_nodes, len(dm.offsets)
    if x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"x must be ({n}, F), got {tuple(x.shape)}")
    if K > MAX_DIAGS or dm.bandwidth > MAX_BANDWIDTH:
        raise ValueError(f"DIA kernel takes ≤{MAX_DIAGS} diagonals of "
                         f"bandwidth ≤{MAX_BANDWIDTH}, got {K} and "
                         f"{dm.bandwidth}")
    vdt = dm.values.dtype
    if vdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"DIA values must be f32 or bf16, got {vdt}")
    x = x.to(vdt).contiguous()
    F = x.shape[1]
    out_w = F
    if fused:
        if F > TF_MAX:
            raise ValueError(f"fused DIA kernel takes F ≤ {TF_MAX}, got {F}")
        if not epilogue_supported(act):
            raise ValueError(f"no fused epilogue for activation {act!r}")
        if w is not None:
            if w.dim() != 2 or w.shape[0] != F:
                raise ValueError(f"W must be ({F}, out), got {tuple(w.shape)}")
            w = (w.to(torch.bfloat16) if vdt == torch.bfloat16
                 else w.float()).contiguous()
            out_w = w.shape[1]
        if b is not None:
            b = b.float().reshape(-1).contiguous()
            if b.shape[0] != out_w:
                raise ValueError(f"b must have {out_w} entries")
    if x.device.type == "cpu":
        return dia_rhs_plain(dm, x, w, b, act, fused, out_dtype)
    extra = [t for t in (w, b) if t is not None]
    _check_cuda_inputs(x, dm.values, dm.offsets_t, *extra)
    out = torch.empty((n, out_w), dtype=out_dtype, device=x.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    in_bf16 = int(vdt == torch.bfloat16)
    out_bf16 = int(out_dtype == torch.bfloat16)
    b_ptr = None if b is None else b.data_ptr()
    code = _ACT_CODES[act] if fused else 0
    runs, n_runs = _runs_arg(dm.offsets)
    if w is None:
        err = lib.ngpde_dia_stencil(
            dm.values.data_ptr(), dm.offsets_t.data_ptr(), K, runs, n_runs,
            x.data_ptr(), b_ptr, out.data_ptr(), n, F, code, in_bf16,
            out_bf16, stream)
    else:
        err = lib.ngpde_dia_gcn_rhs(
            dm.values.data_ptr(), dm.offsets_t.data_ptr(), K, runs, n_runs,
            x.data_ptr(), w.data_ptr(), b_ptr, out.data_ptr(), n, F, out_w,
            code, in_bf16, out_bf16, stream)
    _build.check(err, owner.__name__)
    owner.launches += 1
    owner.backward_launches += int(backward)
    return out


def _stencil(dm: DiaMatrix, x: torch.Tensor, owner,
             backward: bool = False) -> torch.Tensor:
    """``A @ x`` as f32 (the VJPs' products)."""
    return _dia_rhs(dm, x, None, None, None, False, torch.float32, owner,
                    backward)


class _DiaSpmm(torch.autograd.Function):
    """The plain stencil under autograd: the backward is the stencil on
    ``dia_rev`` (Aᵀ), as ``_spmm_bwd`` in the JAX package."""

    @staticmethod
    def forward(ctx, x, dm, dm_rev):
        ctx.dm, ctx.dm_rev = dm, dm_rev
        return _dia_rhs(dm, x, None, None, None, False, x.dtype,
                        dia_spmm_stencil)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        dmt = ctx.dm_rev if ctx.dm_rev is not None else transpose_dia(ctx.dm)
        return (_stencil(dmt, g, dia_spmm_stencil, True).to(g.dtype), None,
                None)


class _DiaGcnRhs(torch.autograd.Function):
    """The fused right-hand side under autograd, the VJP of the JAX
    package's ``_rhs_bwd``: ``dz = g · act'(y)``, ``db = Σ dz``, the
    aggregate recomputed by the stencil kernel, ``dW = aggᵀ dz`` and
    ``dz Wᵀ`` as f32 matrix products, then ``dx`` = the stencil on
    ``dia_norm_rev``."""

    @staticmethod
    def forward(ctx, x, w, b, dm, dm_rev, act):
        out_dtype = (torch.bfloat16 if x.dtype == torch.bfloat16
                     else torch.float32)
        y = _dia_rhs(dm, x, w, b, act, True, out_dtype, dia_gcn_rhs)
        ctx.save_for_backward(x, w, b, y)
        ctx.dm, ctx.dm_rev, ctx.act = dm, dm_rev, act
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, b, y = ctx.saved_tensors
        dm, act = ctx.dm, ctx.act
        dz = g.float() * act_grad_from_y(act, y.float())
        db = None if b is None else dz.sum(0).reshape(b.shape).to(b.dtype)
        dw = None
        gup = dz
        # both products are stencil launches, counted on the stencil
        if w is not None:
            agg = _stencil(dm, x, dia_spmm_stencil, True)
            dw = (agg.t() @ dz).to(w.dtype)
            gup = dz @ w.float().t()
        dmt = ctx.dm_rev if ctx.dm_rev is not None else transpose_dia(dm)
        dx = _stencil(dmt, gup, dia_spmm_stencil, True).to(x.dtype)
        return dx, dw, db, None, None, None


def dia_spmm_stencil(x: torch.Tensor, dm: DiaMatrix,
                     dm_rev: Optional[DiaMatrix] = None) -> torch.Tensor:
    """Stencil SpMM ``A @ x`` in x's dtype (f32 accumulation). CPU tensors
    take the plain version; CUDA tensors launch the kernel. Differentiable:
    the backward is the stencil on ``dm_rev`` (Aᵀ; transposed on the fly
    when None)."""
    if needs_grad(x):
        return _DiaSpmm.apply(x, dm, dm_rev)
    return _dia_rhs(dm, x, None, None, None, False, x.dtype,
                    dia_spmm_stencil)


def dia_gcn_rhs(act, x: torch.Tensor, w: Optional[torch.Tensor],
                b: Optional[torch.Tensor], dm: DiaMatrix,
                dm_rev: Optional[DiaMatrix] = None) -> torch.Tensor:
    """Fused ``act((Ĉ x) · W + b)``; f32 out, or bf16 when x is bf16. CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    Differentiable in x, W and b; ``dm_rev`` (``cache['dia_norm_rev']``)
    is Ĉᵀ for the backward."""
    if needs_grad(x, w, b):
        return _DiaGcnRhs.apply(x, w, b, dm, dm_rev, act)
    out_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    return _dia_rhs(dm, x, w, b, act, True, out_dtype, dia_gcn_rhs)


dia_spmm_stencil.launches = 0
dia_spmm_stencil.backward_launches = 0
dia_gcn_rhs.launches = 0
dia_gcn_rhs.backward_launches = 0
