"""K8: multi-head attention restricted to each node's neighbourhood on a
mesh, ``o_i = Σ_{j ∈ N(i)} softmax_j(q_i · k_j / √d) v_j`` per head, with
``N(i)`` given as a block-sparse layout of 64 × 64 tiles of the node order,
each tile with a bit mask of the pairs that attend (GenCast's processor,
Price et al., arXiv:2312.15796: every mesh node attends to itself and to
every node within its k-hop neighbourhood on M6).

It replaces no TPU kernel: the JAX package has no attention. It was added
because nothing in the port computes attention and it cannot be composed
from the port's gathers: at k = 32 on M6 a node has ~3,169 neighbours,
~130 M (query, key) pairs a layer, and gathering K and V per pair would
move ~530 GB a layer.

What bounds it on the H100: operations. A pair costs ``4·d`` operations a
head forward (``q·k`` and ``p·v``), 14·d backward in this design (the
scores and ``dO·v`` again in each of the two backward passes, ``dV``,
``dK`` and ``dQ``), against Q, K, V and O read and written once
(``3·d`` + ``d`` floats a node a head): thousands of operations a byte at
the published neighbourhoods. Its bound is taken at the CUDA cores'
float32 rate, 67 TFLOP/s. What the design does about it:

- flash-style: one thread block a (64-query block, head); K and V tiles stream
  through while the scores, the online softmax (a running max and sum a
  row) and the output stay in registers; the forward writes O and one
  log-sum-exp a (node, head), nothing of size pairs;
- block-sparse: a block walks only the tiles that hold a pair, its
  row of the layout (CSR over 64-node blocks); inside a tile one 64-bit
  word a row says which keys attend. The tiles are full only where the
  node order is local (``graph.sphere.mesh_order``); the share of computed
  pairs that attend is the layout's ``fill``;
- the backward recomputes the probabilities from the saved log-sum-exp:
  one block a (key block, head) walks its row of tiles, whose masks,
  the relation being symmetric, are the transposed tiles' (``dK``,
  ``dV``), and one block a (query block, head) walks its row again for
  ``dQ``: no atomics, deterministic bits;
- CUDA C++ (``csrc/mesh_attention.cu``), every product a register tile
  of ``fmaf``'s on the CUDA cores: true float32, as the configurations
  state it, under the bound it is measured against. Heads of 64 or 128.

- ``AttentionLayout`` / ``build_attention_layout``: the tile layout from
  the packed neighbourhood bits (``graph.sphere.khop_bits``).
- ``mesh_attention_plain``: the plain PyTorch version, block row by block
  row (each query block against the keys of its row's tiles), autograd
  through PyTorch; CPU tensors take it.
- ``mesh_attention``: the wrapper; CUDA tensors launch the kernels (an
  ``autograd.Function``, forward and backward) or raise. Counters
  ``launches`` (forward and backward kernels), ``backward_launches`` and
  ``pairs`` (each launch's tiles × 64², the scores it computes a head).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import _build

BLOCK = 64  # nodes a block: one int64 mask word a tile row
_POPCOUNT = torch.tensor([bin(b).count("1") for b in range(256)],
                         dtype=torch.int64)


@dataclasses.dataclass(frozen=True, eq=False)
class AttentionLayout:
    """The pairs that attend, as tiles of 64 × 64 nodes: row block ``i``'s
    tiles are ``cols[row_ptr[i]:row_ptr[i + 1]]`` (column blocks,
    ascending); ``masks[t, r]`` holds bit ``c`` where node ``64·i + r``
    attends to node ``64·cols[t] + c``. The relation is symmetric, so row
    ``j``'s tiles are also column ``j``'s, and a tile's mask, transposed,
    is its mirror's. ``pairs``: the pairs that attend (bits set)."""

    row_ptr: torch.Tensor  # (blocks + 1,) int32
    cols: torch.Tensor  # (tiles,) int32
    masks: torch.Tensor  # (tiles, 64) int64
    num_nodes: int
    pairs: int

    @property
    def blocks(self) -> int:
        return self.row_ptr.numel() - 1

    @property
    def tiles(self) -> int:
        return self.cols.numel()

    @property
    def fill(self) -> float:
        """Pairs that attend over pairs a pass computes."""
        return self.pairs / max(1, self.tiles * BLOCK * BLOCK)

    def to(self, device) -> "AttentionLayout":
        return dataclasses.replace(self, row_ptr=self.row_ptr.to(device),
                                   cols=self.cols.to(device),
                                   masks=self.masks.to(device))


def build_attention_layout(bits: torch.Tensor,
                           num_nodes: int) -> AttentionLayout:
    """The layout of ``bits`` (``(64·blocks, blocks)`` int64, row ``i``'s
    word ``w`` bit ``c``: node ``i`` attends to node ``64·w + c``; rows
    past ``num_nodes`` empty), on ``bits``' device. The relation must be
    symmetric."""
    nb = bits.shape[1]
    if bits.shape[0] != nb * BLOCK or nb != -(-num_nodes // BLOCK):
        raise ValueError(f"bits must be ({BLOCK}·blocks, blocks) for "
                         f"{num_nodes} nodes, got {tuple(bits.shape)}")
    tiled = bits.view(nb, BLOCK, nb)
    occupied = (tiled != 0).any(dim=1)  # (row block, column block)
    rows, cols = occupied.nonzero(as_tuple=True)  # row-major
    masks = tiled[rows, :, cols].contiguous()  # (tiles, 64)
    counts = torch.bincount(rows, minlength=nb)
    row_ptr = torch.zeros(nb + 1, dtype=torch.int64, device=bits.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    pop = _POPCOUNT.to(bits.device)
    pairs = int(pop[masks.view(torch.uint8).long()].sum())
    return AttentionLayout(row_ptr.to(torch.int32), cols.to(torch.int32),
                           masks, num_nodes, pairs)


def _bit_mask(words: torch.Tensor) -> torch.Tensor:
    """``(..., 64)`` bool of each int64 word's bits, bit ``c`` at ``c``."""
    shifts = torch.arange(BLOCK, device=words.device)
    return ((words[..., None] >> shifts) & 1).bool()


def mesh_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         layout: AttentionLayout,
                         heads: int) -> torch.Tensor:
    """Plain PyTorch version of K8: for each block of 64 queries, the keys
    of its row's tiles gathered, the scores masked by the tiles' bits, a
    softmax, the values; ``(nodes, heads · d)`` in and out, head ``h`` in
    columns ``h·d … (h + 1)·d``."""
    n, width = q.shape
    d = width // heads
    scale = 1.0 / math.sqrt(d)
    row_ptr = layout.row_ptr.tolist()
    offs = torch.arange(BLOCK, device=q.device)
    qh, kh, vh = (t.reshape(n, heads, d) for t in (q, k, v))
    out = []
    for i in range(layout.blocks):
        t0, t1 = row_ptr[i], row_ptr[i + 1]
        q_rows = min(BLOCK, n - i * BLOCK)
        keys = (layout.cols[t0:t1].long()[:, None] * BLOCK + offs).reshape(-1)
        mask = _bit_mask(layout.masks[t0:t1, :q_rows])  # (tiles, q, 64)
        mask = mask.permute(1, 0, 2).reshape(q_rows, -1)
        real = keys < n
        keys, mask = keys[real], mask[:, real]
        qb = qh[i * BLOCK:i * BLOCK + q_rows]
        s = torch.einsum("qhd,khd->hqk", qb, kh[keys]) * scale
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", p, vh[keys]))
    return torch.cat(out).reshape(n, width)


def _check(layout: AttentionLayout, heads: int, *tensors: torch.Tensor):
    x = tensors[0]
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    n, width = x.shape
    d = width // heads
    if width != heads * d or d not in (64, 128):
        raise ValueError(f"mesh_attention takes heads of 64 or 128, got "
                         f"{width} / {heads}")
    if n != layout.num_nodes:
        raise ValueError(f"{n} rows for a layout of {layout.num_nodes} "
                         "nodes")
    for t in tensors + (layout.row_ptr, layout.cols, layout.masks):
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")
    for t in tensors:
        if t.dtype != torch.float32 or t.shape != x.shape:
            raise TypeError("mesh_attention takes float32 q, k, v of one "
                            "shape")


def _layout_args(layout: AttentionLayout) -> tuple:
    return (layout.row_ptr.data_ptr(), layout.cols.data_ptr(),
            layout.masks.data_ptr())


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _count(launches: int, layout: AttentionLayout, backward: bool) -> None:
    mesh_attention.launches += launches
    mesh_attention.backward_launches += launches * int(backward)
    mesh_attention.pairs += launches * layout.tiles * BLOCK * BLOCK


def _forward(q, k, v, layout, heads):
    _check(layout, heads, q, k, v)
    n, width = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((n, heads), dtype=torch.float32, device=q.device)
    err = _build.library().ngpde_mesh_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_layout_args(layout), n, layout.blocks, heads,
        width // heads, 1.0 / math.sqrt(width // heads), _stream(q))
    _build.check(err, "mesh_attention forward")
    _count(1, layout, False)
    return o, lse


def _backward(q, k, v, o, lse, do, layout, heads):
    do = do.contiguous()
    _check(layout, heads, q, k, v, o, do)
    n, width = q.shape
    d = width // heads
    delta = (do.view(n, heads, d) * o.view(n, heads, d)).sum(-1)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    err = _build.library().ngpde_mesh_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_layout_args(layout), n, layout.blocks, heads, d,
        1.0 / math.sqrt(d), _stream(q))
    _build.check(err, "mesh_attention backward")
    _count(2, layout, True)
    return dq, dk, dv


class _MeshAttention(torch.autograd.Function):
    """K8 under autograd: the forward saves q, k, v, the output and the
    log-sum-exp; the backward is the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, layout, heads):
        o, lse = _forward(q, k, v, layout, heads)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.layout, ctx.heads = layout, heads
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, ctx.layout, ctx.heads)
        return dq, dk, dv, None, None


def mesh_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   layout: AttentionLayout, heads: int) -> torch.Tensor:
    """``(nodes, heads · d)`` attention over ``layout``'s pairs. CPU
    tensors take the plain version; CUDA tensors launch the kernels
    (differentiable) or raise."""
    if q.device.type == "cpu":
        return mesh_attention_plain(q, k, v, layout, heads)
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _MeshAttention.apply(q, k, v, layout, heads)


mesh_attention.launches = 0
mesh_attention.backward_launches = 0
mesh_attention.pairs = 0

