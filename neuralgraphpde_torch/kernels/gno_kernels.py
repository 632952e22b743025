"""K5: the GNO kernel-network matvec fused with the receiver sum, forward
and backward,
``out[n] = Σ_{e→n} w_e · reshape(ph_e @ Wl + bl, in×out)ᵀ · h[s_e]``.

Replaces ``neuralgraphpde/kernels/gno_kernels.py::_fused_gno_fwd`` and
``::_fused_gno_bwd_pallas`` (the Pallas pair behind ``fused_gno_aggregate``).
CUDA source: ``neuralgraphpde_torch/csrc/gno.cu``, whose header says what
bounds it on the H100 and why it reduces over each receiver's edges before
it contracts with the last layer's weight.

The layout is the ``tcsr_edges`` ``SegmentCSR`` that ``precompute``
attaches (receiver-sorted, ``col`` holding edge ids, each edge once) plus
the graph's ``senders``: edge ``e`` reads ``ph[e]`` and ``h[senders[e]]``.
``wl`` is ϕ's last Dense weight in the kernel's ``(IN, K, OUT)`` layout and
``bl`` its bias as ``(IN, 1, OUT)`` or None (``pack_last_layer``); the
kernels compute in true f32.

Dtypes, as the JAX kernels take them: ``ph``, ``h`` and the pair ``wl``/
``bl`` each in f32 or bf16 (the precision policy gives bf16 weights, and
bf16 or f32 activations). Every operand is read as f32; the forward's
output comes back in ph's dtype, and ``dph``, ``dh``, ``dwl`` and ``dbl``
each in its input's (summed in f32, rounded once). The output cotangent has
the output's dtype.

- ``fused_gno_fwd`` / ``fused_gno_bwd``: the kernels (the backward returns
  ``dph``, ``dh``, ``dwl`` and ``dbl`` for an output cotangent). CPU tensors
  take the plain versions; CUDA tensors launch the kernels or raise,
  whatever the dtypes. On the card both hold the widths to the kernels'
  envelope (worked out by the CUDA source: K and OUT up to 4,096, IN up to
  1,444) and raise ``ValueError`` outside it.
- ``fused_gno_plain`` / ``fused_gno_bwd_plain``: the plain PyTorch versions,
  the per-edge kernel matrices ``ph @ W + b`` as one ``(E, IN, OUT)``
  tensor, the per-edge matvec, then ``index_add_``, all in f32 (the JAX
  package's ``xla`` formulation), and autograd through it.
- ``fused_gno_aggregate``: the differentiable call. On the card it is a
  ``torch.autograd.Function`` whose forward and backward are the two
  kernels; on the CPU it is the plain forward under autograd.
- ``gno_plan``: how the kernels run at given widths (the reduce's passes
  over a row, the per-edge backward's slices of k), as the CUDA source
  works it out; None outside the envelope.

Counters, of launches on the card (the plain versions count nothing):
``fused_gno_fwd.launches`` and ``fused_gno_bwd.launches`` (of them
``bf16_launches`` with a bf16 operand), and ``reduce_passes`` on each, the
reduce's passes over every receiver row that those launches made (one a
launch at the Darcy widths, six at K 1024, IN 64).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build
from .segment_kernels import SegmentCSR

_DTYPES = (torch.float32, torch.bfloat16)

# what the CUDA launchers return for widths outside the envelope
_OUTSIDE_ENVELOPE = -1
# the products' output tile, rows by columns (csrc/gno.cu kBM, kBN)
_TILE_M = 128
_TILE_N = 64
# a product with few output tiles is split along its inner dimension into
# about this many blocks per SM, each split at least _MIN_SPLIT deep
_BLOCKS_PER_SM = 2
_MIN_SPLIT = 256


def pack_last_layer(weight: torch.Tensor, bias: Optional[torch.Tensor],
                    in_chs: int, out_chs: int):
    """A Dense last layer ``(K, in*out)`` (and bias ``(1, in*out)``) as the
    kernel's ``(IN, K, OUT)`` / ``(IN, 1, OUT)``, with ``GNOConv``'s
    row-major reshape (``w[:, i*out + o] ≡ W[i, o]``). Views, so gradients
    flow back to the Dense parameters."""
    K = weight.shape[0]
    wl = weight.reshape(K, in_chs, out_chs).permute(1, 0, 2)
    bl = None if bias is None else bias.reshape(in_chs, out_chs)[:, None, :]
    return wl, bl


def _check(csr: SegmentCSR, senders, ph, h, wl, bl) -> None:
    if ph.dim() != 2 or ph.shape[0] != csr.num_cols:
        raise ValueError(f"ph must be ({csr.num_cols}, K), got "
                         f"{tuple(ph.shape)}")
    if tuple(senders.shape) != (csr.num_cols,):
        raise ValueError(f"senders must be ({csr.num_cols},), got "
                         f"{tuple(senders.shape)}")
    if h.dim() != 2:
        raise ValueError(f"h must be (nodes, IN), got {tuple(h.shape)}")
    if wl.dim() != 3 or tuple(wl.shape[:2]) != (h.shape[1], ph.shape[1]):
        raise ValueError(f"wl {tuple(wl.shape)} must be (IN={h.shape[1]}, "
                         f"K={ph.shape[1]}, OUT)")
    if bl is not None and tuple(bl.shape) != (wl.shape[0], 1, wl.shape[2]):
        raise ValueError(f"bl {tuple(bl.shape)} must be ({wl.shape[0]}, 1, "
                         f"{wl.shape[2]})")
    for t in (ph, h, wl):
        if t.dtype not in _DTYPES:
            raise TypeError(f"the GNO kernels take f32 or bf16, got "
                            f"{t.dtype}")
    if bl is not None and bl.dtype != wl.dtype:
        raise TypeError(f"bl ({bl.dtype}) must have wl's dtype "
                        f"({wl.dtype})")


def _check_cuda(csr: SegmentCSR, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"no kernel for device {dev}")
    for t in tensors + (csr.row_ptr, csr.col, csr.weight):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if csr.col.shape[0] != csr.num_cols:
        raise ValueError("the GNO kernels take the edge-id layout "
                         "(tcsr_edges): one slot per ph row")
    if tensors[1].dtype != torch.int32:
        raise TypeError(f"senders must be int32, got {tensors[1].dtype}")


def _check_launch(err: int, what: str, widths) -> None:
    """Raise if a K5 launcher refused the widths or reported a CUDA
    error."""
    if err == _OUTSIDE_ENVELOPE:
        raise ValueError(f"{what}: widths (K, IN, OUT) = {widths} are "
                         "outside the GNO kernels' envelope: K and OUT from "
                         "1 to 4096, IN from 1 to 1444 (the per-edge "
                         "backward's block at its narrowest slice of k "
                         "within the card's 227 KB of shared memory)")
    _build.check(err, what)


@functools.lru_cache(maxsize=None)
def gno_plan(k: int, in_chs: int, out_chs: int,
             has_bias: bool) -> Optional[dict]:
    """How K5 runs at the widths ``(K, IN, OUT)`` on the card
    (``csrc/gno.cu``'s ``reduce_shape`` and ``edge_shape``): the reduce's
    ``reduce_passes`` over a row, its ``reduce_threads`` a block and
    ``reduce_buffers``; the per-edge backward's ``edge_slices`` of k,
    ``edge_slice`` columns each (the last runs to KP) and its block's
    ``edge_smem`` bytes. None outside the envelope. Builds the kernels."""
    plan = (ctypes.c_int * 6)()
    err = _build.library().ngpde_gno_plan(k, in_chs, out_chs, int(has_bias),
                                          plan)
    if err == _OUTSIDE_ENVELOPE:
        return None
    _build.check(err, "ngpde_gno_plan")
    names = ("reduce_passes", "reduce_threads", "reduce_buffers",
             "edge_slices", "edge_slice", "edge_smem")
    return dict(zip(names, plan))


def _plan(what: str, k: int, wlb: torch.Tensor, has_bias: bool) -> dict:
    """``gno_plan`` for the packed ``Wl'``, raising outside the envelope
    before anything is allocated."""
    in_chs, _, out_chs = wlb.shape
    plan = gno_plan(k, in_chs, out_chs, has_bias)
    if plan is None:
        _check_launch(_OUTSIDE_ENVELOPE, what, (k, in_chs, out_chs))
    return plan


def _packed(wl: torch.Tensor, bl: Optional[torch.Tensor]) -> torch.Tensor:
    """``Wl' = [Wl; bl]`` along k, contiguous ``(IN, KP, OUT)``: its KB
    rows padded with zero rows to KP, a multiple of 4, so that every row
    of ``Wl'``, S and dS starts 16-byte aligned."""
    in_chs, k, out_chs = wl.shape
    kb = k + (bl is not None)
    parts = [wl] if bl is None else [wl, bl]
    if kb % 4:
        parts.append(wl.new_zeros((in_chs, 4 - kb % 4, out_chs)))
    return torch.cat(parts, dim=1)


def _splits(m: int, n: int, inner: int, sms: int) -> int:
    """Inner-dimension splits of an ``(m × inner) · (inner × n)`` product
    on a card of ``sms`` SMs: about ``_BLOCKS_PER_SM`` blocks per SM, each
    split ``_MIN_SPLIT`` deep at least."""
    tiles = math.ceil(m / _TILE_M) * math.ceil(n / _TILE_N)
    return max(1, min(math.ceil(_BLOCKS_PER_SM * sms / max(tiles, 1)),
                      math.ceil(inner / _MIN_SPLIT)))


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_gno_plain(csr: SegmentCSR, senders: torch.Tensor, ph: torch.Tensor,
                    h: torch.Tensor, wl: torch.Tensor,
                    bl: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the forward: every edge slot's kernel matrix
    ``ph_e @ W + b`` as an ``(E, IN, OUT)`` tensor, the matvec with
    ``h[s_e]``, weighted, ``index_add_`` onto the rows, all in f32;
    ``(num_rows, OUT)`` in ph's dtype, under autograd (the casts' VJPs
    round each gradient to its input's dtype once)."""
    in_chs, k, out_chs = wl.shape
    eid = csr.col.long()
    php = ph.float().index_select(0, eid)
    hs = h.float().index_select(0, senders.long().index_select(0, eid))
    w = (php @ wl.float().permute(1, 0, 2).reshape(
        k, in_chs * out_chs)).reshape(-1, in_chs, out_chs)
    if bl is not None:
        w = w + bl.float().reshape(1, in_chs, out_chs)
    msgs = torch.einsum("sio,si->so", w, hs) * csr.weight[:, None]
    out = msgs.new_zeros((csr.num_rows, out_chs))
    return out.index_add_(0, csr.rows, msgs).to(ph.dtype)


def fused_gno_bwd_plain(csr: SegmentCSR, senders, ph, h, wl, bl,
                        g_out: torch.Tensor):
    """Plain PyTorch version of the backward: autograd through
    ``fused_gno_plain``. Returns ``(dph, dh, dwl, dbl)``, ``dbl`` None
    without a bias."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (ph, h, wl) + (() if bl is None else (bl,))]
        out = fused_gno_plain(csr, senders, leaves[0], leaves[1], leaves[2],
                              None if bl is None else leaves[3])
        grads = torch.autograd.grad(out, leaves, g_out)
    return grads[0], grads[1], grads[2], (None if bl is None else grads[3])


def _bf16_flags(ph, h, wlb) -> tuple:
    return tuple(int(t.dtype == torch.bfloat16) for t in (ph, h, wlb))


def _launch_fwd(csr: SegmentCSR, senders: torch.Tensor, ph: torch.Tensor,
                h: torch.Tensor, wlb: torch.Tensor, k: int,
                has_bias: bool) -> torch.Tensor:
    """K5 forward on the card, from the packed ``Wl'`` (``_packed``)."""
    _check_cuda(csr, ph, senders, h, wlb)
    plan = _plan("fused_gno_fwd", k, wlb, has_bias)
    dev = ph.device
    in_chs, kp, out_chs = wlb.shape
    n, j = csr.num_rows, in_chs * kp
    splits = _splits(n, out_chs, j, _sms(dev))
    flags = _bf16_flags(ph, h, wlb)
    out = torch.empty((n, out_chs), dtype=ph.dtype, device=dev)
    s_buf = torch.empty((n, j), dtype=torch.float32, device=dev)
    partial = torch.empty((splits * n * out_chs if splits > 1 else 0,),
                          dtype=torch.float32, device=dev)
    err = _build.library().ngpde_gno_fwd(
        csr.row_ptr.data_ptr(), csr.col.data_ptr(), csr.weight.data_ptr(),
        senders.data_ptr(), ph.data_ptr(), h.data_ptr(), wlb.data_ptr(),
        out.data_ptr(), s_buf.data_ptr(), partial.data_ptr(), n, k, in_chs,
        out_chs, int(has_bias), splits, *flags,
        torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(err, "fused_gno_fwd", (k, in_chs, out_chs))
    fused_gno_fwd.launches += 1
    fused_gno_fwd.bf16_launches += int(any(flags))
    fused_gno_fwd.reduce_passes += plan["reduce_passes"]
    return out


def _launch_bwd(csr: SegmentCSR, senders: torch.Tensor, ph: torch.Tensor,
                h: torch.Tensor, wlb: torch.Tensor, k: int, has_bias: bool,
                g_out: torch.Tensor):
    """K5 backward on the card, from the packed ``Wl'``: ``(dph, dh,
    dWl')`` (``dWl'`` padded as ``Wl'``), the per-edge ``dh`` rows summed
    onto the senders in f32, then rounded to h's dtype."""
    _check_cuda(csr, ph, senders, h, wlb, g_out)
    plan = _plan("fused_gno_bwd", k, wlb, has_bias)
    dev = ph.device
    in_chs, kp, out_chs = wlb.shape
    n, j = csr.num_rows, in_chs * kp
    splits = _splits(j, out_chs, n, _sms(dev))
    flags = _bf16_flags(ph, h, wlb)
    f32 = dict(dtype=torch.float32, device=dev)
    dph = torch.zeros_like(ph)
    dh_edge = torch.zeros((csr.num_cols, in_chs), **f32)
    dwlb = torch.empty((in_chs, kp, out_chs), dtype=wlb.dtype, device=dev)
    s_buf = torch.empty((n, j), **f32)
    ds_buf = torch.empty((n, j), **f32)
    partial = torch.empty((splits * j * out_chs if splits > 1 else 0,),
                          **f32)
    err = _build.library().ngpde_gno_bwd(
        csr.row_ptr.data_ptr(), csr.col.data_ptr(), csr.weight.data_ptr(),
        senders.data_ptr(), ph.data_ptr(), h.data_ptr(), wlb.data_ptr(),
        g_out.data_ptr(), dph.data_ptr(), dh_edge.data_ptr(),
        dwlb.data_ptr(), s_buf.data_ptr(), ds_buf.data_ptr(),
        partial.data_ptr(), n, k, in_chs, out_chs, int(has_bias),
        splits, *flags, torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(err, "fused_gno_bwd", (k, in_chs, out_chs))
    fused_gno_bwd.launches += 1
    fused_gno_bwd.bf16_launches += int(any(flags))
    fused_gno_bwd.reduce_passes += plan["reduce_passes"]
    dh = torch.zeros((h.shape[0], in_chs), **f32).index_add_(
        0, senders.long(), dh_edge)
    return dph, dh.to(h.dtype), dwlb


def _check_g_out(csr: SegmentCSR, ph: torch.Tensor, wl: torch.Tensor,
                 g_out: torch.Tensor):
    if (tuple(g_out.shape) != (csr.num_rows, wl.shape[2])
            or g_out.dtype != ph.dtype):
        raise ValueError(f"g_out must be ({csr.num_rows}, {wl.shape[2]}) "
                         f"{ph.dtype}, got {tuple(g_out.shape)} "
                         f"{g_out.dtype}")


def fused_gno_fwd(csr: SegmentCSR, senders: torch.Tensor, ph: torch.Tensor,
                  h: torch.Tensor, wl: torch.Tensor,
                  bl: Optional[torch.Tensor]) -> torch.Tensor:
    """``out[n] = Σ_{e→n} w_e · (ph_e Wl + bl)ᵀ h[s_e]`` as
    ``(num_rows, OUT)`` in ph's dtype, outside autograd. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    _check(csr, senders, ph, h, wl, bl)
    if ph.device.type == "cpu":
        with torch.no_grad():
            return fused_gno_plain(csr, senders, ph, h, wl, bl)
    return _launch_fwd(csr, senders, ph, h, _packed(wl, bl), wl.shape[1],
                       bl is not None)


fused_gno_fwd.launches = 0
fused_gno_fwd.bf16_launches = 0
fused_gno_fwd.reduce_passes = 0


def fused_gno_bwd(csr: SegmentCSR, senders: torch.Tensor, ph: torch.Tensor,
                  h: torch.Tensor, wl: torch.Tensor,
                  bl: Optional[torch.Tensor], g_out: torch.Tensor):
    """VJP of ``fused_gno_fwd`` for the cotangent ``g_out``
    ``(num_rows, OUT)``: ``(dph, dh, dwl, dbl)`` shaped like their inputs,
    ``dbl`` None without a bias. CPU tensors take the plain version; CUDA
    tensors launch the kernel, and the per-edge ``dh`` rows go onto the
    senders with ``index_add_``."""
    _check(csr, senders, ph, h, wl, bl)
    _check_g_out(csr, ph, wl, g_out)
    if ph.device.type == "cpu":
        return fused_gno_bwd_plain(csr, senders, ph, h, wl, bl, g_out)
    k = wl.shape[1]
    dph, dh, dwlb = _launch_bwd(csr, senders, ph, h, _packed(wl, bl), k,
                                bl is not None, g_out)
    return dph, dh, dwlb[:, :k], (None if bl is None else dwlb[:, k:k + 1])


fused_gno_bwd.launches = 0
fused_gno_bwd.bf16_launches = 0
fused_gno_bwd.reduce_passes = 0


class _FusedGNO(torch.autograd.Function):
    """The kernel pair under autograd: K5 forward, K5 backward. ``Wl'`` is
    packed once per call and kept for the backward."""

    @staticmethod
    def forward(ctx, csr, senders, ph, h, wl, bl):
        _check(csr, senders, ph, h, wl, bl)
        wlb = _packed(wl, bl)
        ctx.csr, ctx.k, ctx.has_bias = csr, wl.shape[1], bl is not None
        ctx.save_for_backward(senders, ph, h, wlb)
        return _launch_fwd(csr, senders, ph, h, wlb, ctx.k, ctx.has_bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        senders, ph, h, wlb = ctx.saved_tensors
        k = ctx.k
        dph, dh, dwlb = _launch_bwd(ctx.csr, senders, ph, h, wlb, k,
                                    ctx.has_bias, g_out.contiguous())
        dbl = dwlb[:, k:k + 1] if ctx.has_bias else None
        return None, None, dph, dh, dwlb[:, :k], dbl


def fused_gno_aggregate(ph: torch.Tensor, h: torch.Tensor, wl: torch.Tensor,
                        bl: Optional[torch.Tensor], csr: SegmentCSR,
                        senders: torch.Tensor) -> torch.Tensor:
    """Differentiable ``out[n] = Σ_{e→n} w_e · reshape(ph_e @ W + b,
    in×out)ᵀ h[s_e]`` over the edge-id layout ``csr``
    (``g.cache['tcsr_edges']``) and the graph's ``senders``, as
    ``(num_nodes, OUT)``. ``wl``/``bl`` from ``pack_last_layer``."""
    if ph.device.type == "cpu":
        _check(csr, senders, ph, h, wl, bl)
        return fused_gno_plain(csr, senders, ph, h, wl, bl)
    return _FusedGNO.apply(csr, senders, ph, h, wl, bl)
