"""K3: fused edge-MLP + receiver reduce, forward and backward,
``out[i] = Σ_{s in row i} w_s · MLP(feats[col_s])``.

Replaces ``neuralgraphpde/kernels/fused_mlp_kernels.py::_fused_mlp_fwd``
and ``::_fused_mlp_bwd_pallas`` (the Pallas pair behind
``fused_mlp_aggregate``). CUDA source: ``neuralgraphpde_torch/csrc/
fused_mlp.cu``, whose header says what bounds it on the H100 and how its
blocks are laid out.

The layout is the ``tcsr_edges`` ``SegmentCSR`` that ``precompute``
attaches: receiver-sorted, ``col`` holding edge ids, each edge once. The
MLP has at most four Dense layers with activations from ``supported_
activation`` (the JAX kernel's set; ``gelu`` is the tanh form, as
``jax.nn.gelu``'s default), computed in true f32.

Dtypes, as the JAX kernels take them: feats in f32 or bf16, the weights and
biases in one of the two (the precision policy gives bf16 weights, and bf16
or f32 features). Every operand is read as f32; the forward's output and
``dfeats`` come back in feats' dtype, ``dW`` and ``db`` in the weights'
(summed in f32, rounded once). The output cotangent has the output's dtype.

- ``fused_mlp_fwd`` / ``fused_mlp_bwd``: the kernels (the backward returns
  ``dfeats``, ``dW`` and ``db`` of every layer for an output cotangent).
  CPU tensors take the plain versions; CUDA tensors launch the kernel or
  raise, whatever the dtypes. On the card both hold the MLP to the kernels'
  envelope (1 to 4 layers of widths 1 to 1024, worked out by the CUDA
  source) and raise ``ValueError`` outside it. Inside it the CUDA launcher
  picks one of two variants from the widths: ``resident`` (every weight in
  shared memory) where that fits, else ``streamed`` (W through a shared
  tile); ``fused_mlp_variant`` says which.
- ``fused_mlp_plain`` / ``fused_mlp_bwd_plain``: the plain PyTorch versions,
  a per-edge MLP in f32 then ``index_add_``, and autograd through it (the
  saved-activation path, the JAX package's ``xla`` backend).
- ``fused_mlp_aggregate``: the differentiable call. On the card it is a
  ``torch.autograd.Function`` whose forward and backward are the two
  kernels; on the CPU it is the plain forward under autograd.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build
from .segment_kernels import SegmentCSR

_DTYPES = (torch.float32, torch.bfloat16)

# activation name -> the kernel's code (csrc/fused_mlp.cu ``Act``)
_ACT_CODES = {
    "identity": 0, "relu": 1, "tanh": 2, "sigmoid": 3, "softplus": 4,
    "elu": 5, "gelu": 6, "swish": 7, "silu": 7,
}
_PLAIN_ACTS = {
    "identity": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
    "silu": F.silu,
}

# resident forward: receiver rows per block, chosen so a block's edges fill
# about this many chunk slots on average (at most csrc/fused_mlp.cu
# kMaxFwdRows): every block stages all the weights once
# (scripts/fused_mlp_variants.py times other values)
_FWD_SLOTS = 56
_MAX_FWD_ROWS = 64
# what the CUDA launchers return for an MLP outside the envelope
_OUTSIDE_ENVELOPE = -1
_VARIANTS = ("resident", "streamed")


def supported_activation(name) -> bool:
    return name is None or (isinstance(name, str) and name in _ACT_CODES)


def _act_name(name: Optional[str]) -> str:
    return "identity" if name is None else name


def _dims(feats: torch.Tensor, ws: Sequence[torch.Tensor]) -> tuple:
    return (feats.shape[1],) + tuple(w.shape[1] for w in ws)


def _check(acts, csr: SegmentCSR, feats, ws, bs) -> None:
    n = len(ws)
    if not (len(acts) == len(bs) == n >= 1):
        raise ValueError(f"{len(acts)} activations, {n} weights and "
                         f"{len(bs)} biases: one of each per layer")
    for a in acts:
        if not supported_activation(a):
            raise ValueError(f"activation {a!r} has no kernel form")
    if feats.dim() != 2 or feats.shape[0] != csr.num_cols:
        raise ValueError(f"feats must be ({csr.num_cols}, Fin), got "
                         f"{tuple(feats.shape)}")
    width = feats.shape[1]
    for w, b in zip(ws, bs):
        if w.dim() != 2 or w.shape[0] != width:
            raise ValueError(f"weight {tuple(w.shape)} does not take width "
                             f"{width}")
        width = w.shape[1]
        if b.numel() != width:
            raise ValueError(f"bias of {b.numel()} entries for width {width}")
    if feats.dtype not in _DTYPES or ws[0].dtype not in _DTYPES:
        raise TypeError(f"the fused MLP kernels take f32 or bf16, got feats "
                        f"{feats.dtype}, weights {ws[0].dtype}")
    if any(t.dtype != ws[0].dtype for t in (*ws, *bs)):
        raise TypeError("the fused MLP kernels take every weight and bias "
                        f"in one dtype, got {[t.dtype for t in (*ws, *bs)]}")


def _check_launch(err: int, what: str, dims) -> None:
    """Raise if a K3 launcher refused the MLP or reported a CUDA error."""
    if err == _OUTSIDE_ENVELOPE:
        raise ValueError(f"{what}: MLP widths {dims} are outside the fused "
                         "MLP kernels' envelope: 1 to 4 layers of widths 1 "
                         "to 1024")
    _build.check(err, what)


def fused_mlp_variant(dims: Sequence[int], backward: bool = False) -> str:
    """The variant the card's launcher takes for an MLP of widths ``dims``
    (``(K_0, ..., K_n)``): ``"resident"`` or ``"streamed"``; ``ValueError``
    outside the envelope. Needs the kernel library (the card's machine)."""
    dims = tuple(int(d) for d in dims)
    code = _build.library().ngpde_fused_mlp_variant(
        len(dims) - 1, (ctypes.c_int * len(dims))(*dims), int(backward))
    if code == _OUTSIDE_ENVELOPE:
        _check_launch(code, "fused_mlp_variant", dims)
    return _VARIANTS[code]


def fused_mlp_plain(acts, csr: SegmentCSR, feats: torch.Tensor,
                    ws: Sequence[torch.Tensor],
                    bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the forward: the MLP on every edge slot in
    f32, weighted, ``index_add_`` onto the rows; ``(num_rows, K_n)`` in
    feats' dtype, under autograd (the casts' VJPs round each gradient to
    its input's dtype once)."""
    h = feats.float().index_select(0, csr.col)
    for w, b, act in zip(ws, bs, acts):
        h = _PLAIN_ACTS[_act_name(act)](h @ w.float()
                                        + b.float().reshape(1, -1))
    msgs = h * csr.weight[:, None]
    out = msgs.new_zeros((csr.num_rows, msgs.shape[1]))
    return out.index_add_(0, csr.rows, msgs).to(feats.dtype)


def fused_mlp_bwd_plain(acts, csr: SegmentCSR, feats, ws, bs,
                        g_out: torch.Tensor):
    """Plain PyTorch version of the backward: autograd through
    ``fused_mlp_plain``. Returns ``(dfeats, dws, dbs)``, each bias gradient
    shaped like its bias."""
    n = len(ws)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (feats, *ws, *bs)]
        out = fused_mlp_plain(acts, csr, leaves[0], leaves[1:n + 1],
                              leaves[n + 1:])
        grads = torch.autograd.grad(out, leaves, g_out)
    return grads[0], tuple(grads[1:n + 1]), tuple(grads[n + 1:])


def _check_cuda(csr: SegmentCSR, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    for t in tensors + (csr.row_ptr, csr.col, csr.weight, csr.rows):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if csr.col.shape[0] != csr.num_cols:
        raise ValueError("the fused MLP kernels take the edge-id layout "
                         "(tcsr_edges): one slot per feats row")


def _layer_args(acts, dims, ws, bs):
    n = len(ws)
    return (n, (ctypes.c_int * (n + 1))(*dims),
            (ctypes.c_int * n)(*(_ACT_CODES[_act_name(a)] for a in acts)),
            (ctypes.c_void_p * n)(*(w.data_ptr() for w in ws)),
            (ctypes.c_void_p * n)(*(b.data_ptr() for b in bs)))


def _rows_rule(n_rows: int, n_slots: int, sms: int, streamed: bool,
               backward: bool) -> tuple:
    """``(rows, slots)``: receiver rows per block and the edge slots a block
    holds on average, for ``n_rows`` receivers, ``n_slots`` edge slots and
    ``sms`` SMs. A resident forward block stages every weight, so it takes
    about ``_FWD_SLOTS`` slots; a resident backward block also keeps every
    dW in shared memory and writes them once, so the backward spreads the
    rows over at most one block per SM (fewer partials to add) unless the
    forward's share is larger. A streamed block reads W once per chunk
    whatever its size, so both directions spread the rows over about one
    block per SM: a small graph (the MP-PDE chain: 256 rows) gets 128
    blocks instead of 19. More rows a streamed backward block write fewer
    dW partials, but 2 and 4 times as many ran slower on the H100
    (``scripts/fused_mlp_variants.py``)."""
    n_rows = max(n_rows, 1)
    per_sm = math.ceil(n_rows / sms)
    avg_degree = n_slots / n_rows
    fwd = max(1, min(_MAX_FWD_ROWS, int(_FWD_SLOTS / max(avg_degree, 1e-9))))
    if streamed:
        rows = per_sm if backward else min(_MAX_FWD_ROWS, per_sm)
    else:
        rows = max(fwd, per_sm) if backward else fwd
    return rows, max(1, math.ceil(avg_degree * rows))


def _block_rows(csr: SegmentCSR, dims, backward: bool, dev) -> tuple:
    """``_rows_rule`` for ``csr`` on the card of ``dev``, in the variant
    the launcher takes for ``dims``."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _rows_rule(csr.num_rows, csr.col.shape[0], sms,
                      fused_mlp_variant(dims, backward) == "streamed",
                      backward)


def _bf16_flags(feats: torch.Tensor, ws) -> tuple:
    return int(feats.dtype == torch.bfloat16), int(ws[0].dtype ==
                                                   torch.bfloat16)


def fused_mlp_fwd(acts, csr: SegmentCSR, feats: torch.Tensor,
                  ws: Sequence[torch.Tensor],
                  bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``out[i] = Σ_{s in row i} w_s · MLP(feats[col_s])`` as
    ``(num_rows, K_n)`` in feats' dtype, outside autograd. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    _check(acts, csr, feats, ws, bs)
    if feats.device.type == "cpu":
        with torch.no_grad():
            return fused_mlp_plain(acts, csr, feats, ws, bs)
    dims = _dims(feats, ws)
    _check_cuda(csr, feats, *ws, *bs)
    out = torch.empty((csr.num_rows, dims[-1]), dtype=feats.dtype,
                      device=feats.device)
    rows, slots = _block_rows(csr, dims, False, feats.device)
    flags = _bf16_flags(feats, ws)
    lib = _build.library()
    err = lib.ngpde_fused_mlp_fwd(
        csr.row_ptr.data_ptr(), csr.col.data_ptr(), csr.weight.data_ptr(),
        feats.data_ptr(), out.data_ptr(), csr.num_rows, rows, slots,
        *_layer_args(acts, dims, ws, bs), *flags,
        torch.cuda.current_stream(feats.device).cuda_stream)
    _check_launch(err, "fused_mlp_fwd", dims)
    fused_mlp_fwd.launches += 1
    fused_mlp_fwd.bf16_launches += int(any(flags))
    return out


fused_mlp_fwd.launches = 0
fused_mlp_fwd.bf16_launches = 0


def fused_mlp_bwd(acts, csr: SegmentCSR, feats: torch.Tensor,
                  ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                  g_out: torch.Tensor):
    """VJP of ``fused_mlp_fwd`` for the cotangent ``g_out``
    ``(num_rows, K_n)`` in feats' dtype: ``(dfeats, dws, dbs)`` in the
    dtypes of feats and the weights, each bias gradient shaped like its
    bias. CPU tensors take the plain version; CUDA tensors launch the
    kernel (and the small kernel that adds its per-block dW/db)."""
    _check(acts, csr, feats, ws, bs)
    dims = _dims(feats, ws)
    if (tuple(g_out.shape) != (csr.num_rows, dims[-1])
            or g_out.dtype != feats.dtype):
        raise ValueError(f"g_out must be ({csr.num_rows}, {dims[-1]}) "
                         f"{feats.dtype}, got {tuple(g_out.shape)} "
                         f"{g_out.dtype}")
    if feats.device.type == "cpu":
        return fused_mlp_bwd_plain(acts, csr, feats, ws, bs, g_out)
    _check_cuda(csr, feats, g_out, *ws, *bs)
    dev = feats.device
    rows, slots = _block_rows(csr, dims, True, dev)
    blocks = math.ceil(csr.num_rows / rows)
    sizes = [(dims[l], dims[l + 1]) for l in range(len(ws))]
    n_params = sum(a * b + b for a, b in sizes)
    dfeats = torch.zeros_like(feats)
    grads = torch.empty(n_params, dtype=ws[0].dtype, device=dev)
    partial = torch.empty((max(blocks, 1), n_params), dtype=torch.float32,
                          device=dev)
    flags = _bf16_flags(feats, ws)
    lib = _build.library()
    err = lib.ngpde_fused_mlp_bwd(
        csr.row_ptr.data_ptr(), csr.col.data_ptr(), csr.weight.data_ptr(),
        csr.rows.data_ptr(), feats.data_ptr(), g_out.data_ptr(),
        dfeats.data_ptr(), grads.data_ptr(), partial.data_ptr(),
        csr.num_rows, rows, slots, *_layer_args(acts, dims, ws, bs), *flags,
        torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(err, "fused_mlp_bwd", dims)
    fused_mlp_bwd.launches += 1
    fused_mlp_bwd.bf16_launches += int(any(flags))
    dws, dbs, off = [], [], 0
    for (a, b), bias in zip(sizes, bs):
        dws.append(grads[off:off + a * b].view(a, b))
        off += a * b
        dbs.append(grads[off:off + b].view(bias.shape))
        off += b
    return dfeats, tuple(dws), tuple(dbs)


fused_mlp_bwd.launches = 0
fused_mlp_bwd.bf16_launches = 0


class _FusedMLP(torch.autograd.Function):
    """The kernel pair under autograd: K3 forward, K3 backward."""

    @staticmethod
    def forward(ctx, acts, csr, feats, *params):
        n = len(acts)
        ctx.acts, ctx.csr = acts, csr
        ctx.save_for_backward(feats, *params)
        return fused_mlp_fwd(acts, csr, feats, params[:n], params[n:])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        feats, *params = ctx.saved_tensors
        n = len(ctx.acts)
        dfeats, dws, dbs = fused_mlp_bwd(ctx.acts, ctx.csr, feats,
                                         params[:n], params[n:],
                                         g_out.contiguous())
        return (None, None, dfeats) + tuple(dws) + tuple(dbs)


def fused_mlp_aggregate(acts, feats: torch.Tensor,
                        ws: Sequence[torch.Tensor],
                        bs: Sequence[torch.Tensor],
                        csr: SegmentCSR) -> torch.Tensor:
    """Differentiable ``out[i] = Σ_{e: recv_e = i} w_e · MLP(feats_e)``
    over the edge-id layout ``csr`` (``g.cache['tcsr_edges']``), as
    ``(num_nodes, K_n)``. ``acts``: per-layer activation names;
    ``ws``/``bs``: ``(K_{l-1}, K_l)`` weights and ``(1, K_l)`` biases
    (zeros for a bias-free layer)."""
    acts = tuple(acts)
    if feats.device.type == "cpu":
        _check(acts, csr, feats, ws, bs)
        return fused_mlp_plain(acts, csr, feats, ws, bs)
    return _FusedMLP.apply(acts, csr, feats, *ws, *bs)
