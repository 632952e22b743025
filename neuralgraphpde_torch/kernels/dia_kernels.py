"""K2: DIA stencil SpMM and the fused GCN right-hand side.

Replaces ``neuralgraphpde/kernels/dia_kernels.py::_dia_rhs_fwd`` (the Pallas
kernel behind ``dia_spmm_pallas`` and ``dia_gcn_rhs``). CUDA source:
``neuralgraphpde_torch/csrc/dia_stencil.cu``.

- ``dia_spmm_stencil``: ``out[i] = Σ_k values[i, k] · x[i + offsets[k]]``.
- ``dia_gcn_rhs``: ``act((Ĉ x) · W + b)`` with Ĉ = C·Ã·C stored as the DIA
  values (``cache['dia_norm']``): the whole GCN ODE right-hand side in one
  kernel; ``W`` and ``b`` may be None.

Both are differentiable. The stencil's backward is the stencil kernel on
the transposed values (``dia_rev``), as the JAX package's custom VJP. The
fused form's backward is the JAX package's ``_rhs_bwd`` reassociated: with
``dz = g · act'(y)`` and ``u = Ĉᵀ dz`` (``dia_norm_rev``), ``dx = u Wᵀ``,
``dW = xᵀ u`` and ``db = Σ dz``, so the aggregate is never recomputed and
one stencil a call is left. On the card it is one kernel pass in f32 and a
fixed-order sum of the blocks' dW and db partials (counted on
``dia_gcn_rhs`` as one launch and one backward launch). The CPU, bf16 and
widths past ``TF_MAX`` take the same algebra unfused
(``dia_gcn_bwd_plain``: the stencil, then two products), counted on
``dia_gcn_rhs.backward_eager``; on the card its stencil counts on
``dia_spmm_stencil`` as a backward launch.

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

The fused backward (``_gcn_bwd``) is built like the fused forward:
persistent, 64-row tiles of ``Ĉᵀ``. Its prologue is the stencil, each
neighbour row's ``dz`` formed from ``g`` and ``y`` in registers as it
loads, into a shared tile of u; the tile's own rows' ``dz`` go to the
thread's ``db`` sums; ``dx = u Wᵀ`` is register-tiled (8 × 4 outputs a
thread, 64 columns a pass) against ``Wᵀ`` staged once per block; and where
F and out are at most 64, ``dW += xᵀ u`` from x's rows staged beside u,
held in registers over the block's tiles. Neither ``dz`` nor u goes to
device memory (wider: u is written and dW is one f32 product ``xᵀ u``).
A block copies its next tile's vals and x rows by ``cp.async`` while the
current tile's products run. A second launch adds the blocks' dW and db
partials in a fixed order. True f32 on the CUDA cores; the same inputs
give the same bits.

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
DW_TILE = 64  # widest F and out whose dW the fused backward keeps per block
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


def dia_gcn_bwd_plain(dm_rev: DiaMatrix, x: torch.Tensor,
                      w: Optional[torch.Tensor], y: torch.Tensor,
                      g: torch.Tensor, act) -> tuple:
    """K2's backward without its fused kernel, in f32: ``dz = g ·
    act'(y)``, ``u = Ĉᵀ dz`` (the stencil on ``dm_rev``: the kernel on the
    card, counted on ``dia_spmm_stencil`` as a backward launch; the plain
    version on the CPU), then ``(dx, dW, db) = (u Wᵀ, xᵀ u, Σ dz)``; with
    ``w`` None, ``dx = u`` and ``dW`` is None. ``Ĉᵀ(dz Wᵀ) = (Ĉᵀ dz) Wᵀ``
    and ``(Ĉ x)ᵀ dz = xᵀ(Ĉᵀ dz)``, so the aggregate is never recomputed."""
    dz = g.float() * act_grad_from_y(act, y.float())
    u = _stencil(dm_rev, dz, dia_spmm_stencil, True)
    if w is None:
        return u, None, dz.sum(0)
    return u @ w.float().t(), x.float().t() @ u, dz.sum(0)


@functools.lru_cache(maxsize=64)
def _bwd_blocks(K: int, n: int, F: int, O: int, dw: bool, has_w: bool,
                act_code: int, device: int) -> int:
    """The blocks the fused backward launches at these widths on the
    current card (``device``, its index), so the rows of its partials: the
    launcher's own plan, asked once a shape."""
    blocks = ctypes.c_int(0)
    err = _build.library().ngpde_dia_gcn_bwd_blocks(
        K, n, F, O, int(dw), int(has_w), act_code, ctypes.byref(blocks))
    _build.check(err, "dia_gcn_rhs")
    return blocks.value


def _gcn_bwd(dmt: DiaMatrix, x: torch.Tensor, w: Optional[torch.Tensor],
             y: torch.Tensor, g: torch.Tensor, act, need_x: bool,
             need_w: bool, need_b: bool) -> tuple:
    """K2's fused backward on the card (f32): one pass over the tiles of
    ``Ĉᵀ`` (``dmt``) and, for its dW and db, a fixed-order sum of the
    blocks' partials. ``(dx, dW, db)``, each None where not needed. dW comes
    from the kernel's tiles where F and out are at most ``DW_TILE``, else
    from one f32 product ``xᵀ u`` on the u the kernel writes."""
    n, O = g.shape
    F = x.shape[1]
    K = len(dmt.offsets)
    g, y = g.float().contiguous(), y.float().contiguous()
    dw_inline = need_w and F <= DW_TILE and O <= DW_TILE
    dev = g.device
    dx = u = wk = None
    if w is None:
        u = torch.empty((n, O), device=dev) if need_x else None
    else:
        if need_x:
            dx = torch.empty((n, F), device=dev)
            wk = w.float().contiguous()
        if need_w and not dw_inline:
            u = torch.empty((n, O), device=dev)
    xk = x.float().contiguous() if dw_inline else None
    n_params = (F * O if dw_inline else 0) + (O if need_b else 0)
    grads = partial = None
    blocks = 0
    if n_params:
        blocks = max(1, _bwd_blocks(K, n, F, O, dw_inline, wk is not None,
                                    _ACT_CODES[act], dev.index))
        grads = torch.empty(n_params, device=dev)
        partial = torch.empty((blocks, n_params), device=dev)
    _check_cuda_inputs(g, y, dmt.values, dmt.offsets_t,
                       *[t for t in (xk, wk) if t is not None])
    runs, n_runs = _runs_arg(dmt.offsets)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _build.library().ngpde_dia_gcn_bwd(
        dmt.values.data_ptr(), dmt.offsets_t.data_ptr(), K, runs, n_runs,
        g.data_ptr(), y.data_ptr(), ptr(xk), ptr(wk), ptr(dx), ptr(u),
        ptr(grads), ptr(partial), blocks, n, F, O, _ACT_CODES[act],
        int(need_b), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dia_gcn_rhs")
    dia_gcn_rhs.launches += 1
    dia_gcn_rhs.backward_launches += 1
    if w is None:
        dx, dw = u, None
    elif dw_inline:
        dw = grads[:F * O].view(F, O)
    else:
        dw = x.float().t() @ u if need_w else None
    return dx, dw, grads[-O:] if need_b else None


def _fused_backward_fits(dmt: DiaMatrix, x: torch.Tensor,
                         y: torch.Tensor) -> bool:
    """Whether the fused backward kernel takes this call: on the card, a
    forward computed in f32 (f32 values and output; x and W were cast to
    f32 for it), widths within ``TF_MAX``."""
    f32 = torch.float32
    return (x.is_cuda and dmt.values.dtype == f32 and y.dtype == f32
            and len(dmt.offsets) <= MAX_DIAGS
            and max(x.shape[1], y.shape[1]) <= TF_MAX)


class _DiaGcnRhs(torch.autograd.Function):
    """The fused right-hand side under autograd. Its backward is the JAX
    package's ``_rhs_bwd`` reassociated: on the card, for a forward in f32
    within ``TF_MAX``, one kernel pass (``_gcn_bwd``); otherwise (the CPU,
    bf16, a width the kernel refuses) ``dia_gcn_bwd_plain``, counted on
    ``dia_gcn_rhs.backward_eager``."""

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
        dmt = ctx.dm_rev if ctx.dm_rev is not None else transpose_dia(dm)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        need_w, need_b = need_w and w is not None, need_b and b is not None
        if _fused_backward_fits(dmt, x, y):
            dx, dw, db = _gcn_bwd(dmt, x, w, y, g, act, need_x, need_w,
                                  need_b)
        else:
            dia_gcn_rhs.backward_eager += 1
            dx, dw, db = dia_gcn_bwd_plain(dmt, x, w, y, g, act)
        return (None if dx is None or not need_x else dx.to(x.dtype),
                None if dw is None or not need_w else dw.to(w.dtype),
                db.reshape(b.shape).to(b.dtype) if need_b else None,
                None, None, None)


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
dia_gcn_rhs.backward_eager = 0
