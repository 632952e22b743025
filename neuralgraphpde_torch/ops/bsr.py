"""Structured storage selection and block storage (counterpart of
``neuralgraphpde.ops.bsr``).

``precompute_bsr`` picks, in the JAX package's order: hybrid DIA (stencil +
COO remainder), full DIA, packed block bands, dense block bands, and
block-sparse rows under a density gate. The builders are the JAX package's
numpy code, so the arrays are bit-equal to its CPU build.

- ``BandedMatrix`` (dense block diagonals): band ``k`` holds block ``(i,
  i + offsets[k])`` of every block-row ``i``, zero where absent.
- ``PackedBanded`` (row-packed block bands): block-row ``i`` holds its
  nonzero ``tb_rows × tb`` blocks only, slot ``s`` reading x block
  ``cols[i, s]``.

Both are ``blocks (S, nb, tbr, tb)`` with a ``cols (nb, S)`` table of x
blocks (for dense bands ``cols[i, k] = clip(i + offsets[k], 0, nb − 1)``;
the clipped slots hold zero blocks), so one kernel
(``kernels/banded_kernels.py``) reads both. Each also carries the
``SubTileIndex`` of its occupied sub-tiles, the list that kernel walks
(the JAX package's storages have no such field). ``bsr_spmm`` stays plain
torch: the JAX package computes it outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graph.gnngraph import GnnGraph
from ..graph.transforms import host_edges
from .dia import build_dia, build_dia_hybrid, plan_dia, transpose_dia

# Widest stencil the DIA kernel takes (the JAX package's gate).
DIA_MAX_BANDWIDTH = 8192
# Packed block bands: tall 512 × 128 blocks (narrow x blocks, few rows).
PACKED_TB, PACKED_TB_ROWS, PACKED_MAX_SLOTS = 128, 512, 32
# Nominal feature width of the packed-vs-dense traffic rule.
F_NOM = 128
# The block-band kernel's sub-tile: rows of an output tile × columns of a
# chunk (x rows). ``csrc/banded.cu`` is built for these and raises on an
# index made for others.
SUBTILE_ROWS, SUBTILE_COLS = 32, 32


def _weights(edge_weight, E: int) -> np.ndarray:
    return (np.ones(E, np.float32) if edge_weight is None
            else np.asarray(edge_weight, np.float32).reshape(-1))


def _store(host: np.ndarray, shape, dtype) -> torch.Tensor:
    return torch.from_numpy(host.reshape(shape)).to(dtype)


# ------------------------------------------------------------ block-sparse
@dataclasses.dataclass(frozen=True, eq=False)
class BsrMatrix:
    """Packed nonzero ``tb × tb`` blocks of the (receiver, sender)
    adjacency."""

    blocks: torch.Tensor  # (nnzb, tb, tb)
    col_blocks: torch.Tensor  # (nnzb,) int32: sender block of each block
    row_blocks: torch.Tensor  # (nnzb,) int32: receiver block (sorted)
    num_row_blocks: int
    num_col_blocks: int
    tb: int
    num_nodes: int
    density: float  # nonzero blocks / all blocks

    def to(self, device) -> "BsrMatrix":
        return dataclasses.replace(self, blocks=self.blocks.to(device),
                                   col_blocks=self.col_blocks.to(device),
                                   row_blocks=self.row_blocks.to(device))


def build_bsr(senders, receivers, num_nodes: int, *, tb: int = 256,
              edge_weight=None, dtype=torch.float32) -> BsrMatrix:
    """Host block packing, ``A[r, s] += w`` per edge ``s -> r``."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    E = senders.shape[0]
    w = _weights(edge_weight, E)
    nb = -(-num_nodes // tb)
    rb = receivers // tb
    cb = senders // tb
    key = rb * nb + cb
    order = np.argsort(key, kind="stable")
    uniq, starts = np.unique(key[order], return_index=True)
    nnzb = len(uniq)
    blocks = np.zeros((nnzb, tb, tb), np.float32)
    row_blocks = (uniq // nb).astype(np.int32)
    col_blocks = (uniq % nb).astype(np.int32)
    bounds = np.concatenate([starts, [E]])
    for k in range(nnzb):
        idx = order[bounds[k]:bounds[k + 1]]
        rr = receivers[idx] - row_blocks[k] * tb
        cc = senders[idx] - col_blocks[k] * tb
        np.add.at(blocks[k], (rr, cc), w[idx])
    return BsrMatrix(
        blocks=torch.from_numpy(blocks).to(dtype),
        col_blocks=torch.from_numpy(col_blocks),
        row_blocks=torch.from_numpy(row_blocks),
        num_row_blocks=nb, num_col_blocks=nb, tb=tb, num_nodes=num_nodes,
        density=nnzb / float(nb * nb))


def bsr_spmm(bsr: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` over the packed blocks (a batched product and a sum over
    block rows, f32 accumulation); ``(num_nodes, F)`` in x's dtype."""
    tb = bsr.tb
    n_pad = bsr.num_col_blocks * tb
    cdt = torch.bfloat16 if bsr.blocks.dtype == torch.bfloat16 else x.dtype
    xp = torch.nn.functional.pad(x, (0, 0, 0, n_pad - x.shape[0]))
    xb = xp.to(cdt).reshape(bsr.num_col_blocks, tb, x.shape[1])
    gathered = xb.index_select(0, bsr.col_blocks.to(torch.int64))
    prods = torch.bmm(bsr.blocks.float(), gathered.float())
    out = prods.new_zeros((bsr.num_row_blocks, tb, x.shape[1]))
    out.index_add_(0, bsr.row_blocks.to(torch.int64), prods)
    return out.to(x.dtype).reshape(-1, x.shape[1])[: bsr.num_nodes]


# ------------------------------------------------------- block bands
@dataclasses.dataclass(frozen=True, eq=False)
class SubTileIndex:
    """The occupied sub-tiles of a block-band storage ``(S, nb, tbr, tb)``:
    a CSR over its output tiles (block-row ``i``, rows ``[t·rows, (t + 1)·
    rows)`` is tile ``i·ceil(tbr / rows) + t``) listing, in ascending order,
    each ``(slot s, column chunk k)`` whose ``rows × cols`` sub-tile holds a
    stored nonzero, as ``s·ceil(tb / cols) + k``.

    It describes the storage's sparsity pattern: ``dataclasses.replace``
    on a storage may change the dtype of its blocks (a value rounded to
    zero only leaves a listed sub-tile that costs work), never where its
    nonzeros are; a nonzero outside the listed sub-tiles is left out of
    the kernel's sum. The wrapper checks only the index's shape."""

    ptr: torch.Tensor  # (nb·tiles + 1,) int32
    ent: torch.Tensor  # (occupied sub-tiles,) int32
    rows: int = SUBTILE_ROWS
    cols: int = SUBTILE_COLS

    def to(self, device) -> "SubTileIndex":
        return dataclasses.replace(self, ptr=self.ptr.to(device),
                                   ent=self.ent.to(device))


def subtile_index(shape, flat: torch.Tensor) -> SubTileIndex:
    """The ``SubTileIndex`` of a storage of ``shape (S, nb, tbr, tb)``
    whose stored nonzeros sit at the flat positions ``flat`` (int64, any
    order, repeats allowed), on ``flat``'s device."""
    S, nb, tbr, tb = shape
    tiles = -(-tbr // SUBTILE_ROWS)
    chunks = -(-tb // SUBTILE_COLS)
    rest, c = flat // tb, flat % tb
    rest, r = rest // tbr, rest % tbr
    s, i = rest // nb, rest % nb
    per_tile = max(S * chunks, 1)  # entries a tile can list
    tile = i * tiles + r // SUBTILE_ROWS
    key = torch.unique(tile * per_tile + s * chunks + c // SUBTILE_COLS)
    counts = torch.bincount(key // per_tile, minlength=nb * tiles)
    ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return SubTileIndex(ptr=ptr.to(torch.int32),
                        ent=(key % per_tile).to(torch.int32))


def _host_index(host: np.ndarray, shape, flat: np.ndarray) -> SubTileIndex:
    """The index of a host-built storage from its edges' flat positions
    (those whose summed value is zero left out)."""
    return subtile_index(shape, torch.from_numpy(flat[host[flat] != 0]))


@dataclasses.dataclass(frozen=True, eq=False)
class BandedMatrix:
    """Dense block-diagonal storage: band ``k`` holds block ``(i, i +
    offsets[k])`` of every block-row ``i`` (zero where absent)."""

    bands: torch.Tensor  # (n_bands, nb, tb, tb)
    offsets: tuple  # band offsets d (column block − row block), ascending
    nb: int
    tb: int
    num_nodes: int
    # (nb, n_bands) int32: x block of each band, clip(i + d, 0, nb − 1)
    cols: Optional[torch.Tensor] = None
    tiles: Optional[SubTileIndex] = None  # the occupied sub-tiles

    def __post_init__(self):
        if self.cols is None:
            i = np.arange(self.nb, dtype=np.int64)[:, None]
            cols = np.clip(i + np.asarray(self.offsets, np.int64)[None, :],
                           0, self.nb - 1).astype(np.int32)
            object.__setattr__(self, "cols", torch.from_numpy(
                cols.reshape(self.nb, len(self.offsets))).to(
                    self.bands.device))

    blocks = property(lambda self: self.bands)
    row_height = property(lambda self: self.tb)
    num_col_blocks = property(lambda self: self.nb)

    def to(self, device) -> "BandedMatrix":
        return dataclasses.replace(
            self, bands=self.bands.to(device), cols=self.cols.to(device),
            tiles=None if self.tiles is None else self.tiles.to(device))


def build_banded(senders, receivers, num_nodes: int, *, tb: int = 256,
                 edge_weight=None, max_bands: int = 16,
                 dtype=torch.float32) -> Optional[BandedMatrix]:
    """Dense block-diagonal storage; None when the graph needs more than
    ``max_bands`` distinct block diagonals, or half of all of them."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    w = _weights(edge_weight, senders.shape[0])
    nb = -(-num_nodes // tb)
    rb = receivers // tb
    cb = senders // tb
    offsets = np.unique(cb - rb)
    if not _bands_fit(len(offsets), nb, max_bands):
        return None
    k_of_edge = np.searchsorted(offsets, cb - rb)
    rloc = receivers - rb * tb
    cloc = senders - cb * tb
    flat = ((k_of_edge * nb + rb) * tb + rloc) * tb + cloc
    shape = (len(offsets), nb, tb, tb)
    host = np.zeros((int(np.prod(shape)),), np.float32)
    np.add.at(host, flat, w)
    return BandedMatrix(bands=_store(host, shape, dtype),
                        offsets=tuple(int(d) for d in offsets),
                        nb=nb, tb=tb, num_nodes=num_nodes,
                        tiles=_host_index(host, shape, flat))


def transpose_banded(bm: BandedMatrix) -> BandedMatrix:
    """Aᵀ of a banded matrix, for a backward without a prebuilt
    ``banded_rev``: band ``d`` becomes band ``−d``, its block-rows shifted
    by ``d`` and each block transposed."""
    tr = []
    for k, d in enumerate(bm.offsets):
        blk = bm.bands[k].transpose(-1, -2)
        zeros = blk.new_zeros((abs(d),) + tuple(blk.shape[1:]))
        if d > 0:
            blk = torch.cat([zeros, blk[:-d]], 0)
        elif d < 0:
            blk = torch.cat([blk[-d:], zeros], 0)
        tr.append(blk)
    offsets = tuple(-d for d in bm.offsets)
    order = sorted(range(len(offsets)), key=lambda i: offsets[i])
    bands = torch.stack([tr[i] for i in order]).contiguous()
    return BandedMatrix(
        bands=bands, offsets=tuple(offsets[i] for i in order), nb=bm.nb,
        tb=bm.tb, num_nodes=bm.num_nodes, tiles=subtile_index(
            bands.shape, torch.nonzero(bands.reshape(-1)).reshape(-1)))


@dataclasses.dataclass(frozen=True, eq=False)
class PackedBanded:
    """Row-packed block bands: block-row ``i`` holds its nonzero blocks
    only, slot ``s`` reading x block ``cols[i, s]`` (unused slots point at
    the row's own column block and hold zero)."""

    blocks: torch.Tensor  # (S, nb, tb_rows, tb), slot-major
    cols: torch.Tensor  # (nb, S) int32 x block of each slot
    nb: int  # row blocks, ceil(num_nodes / tb_rows)
    tb: int  # block column width (x block height)
    num_nodes: int
    tb_rows: int = 0  # block row height; 0 = square (tb)
    tiles: Optional[SubTileIndex] = None  # the occupied sub-tiles

    @property
    def row_height(self) -> int:
        return self.tb_rows or self.tb

    @property
    def num_col_blocks(self) -> int:
        return -(-self.num_nodes // self.tb)

    def to(self, device) -> "PackedBanded":
        return dataclasses.replace(
            self, blocks=self.blocks.to(device), cols=self.cols.to(device),
            tiles=None if self.tiles is None else self.tiles.to(device))


def build_packed_banded(senders, receivers, num_nodes: int, *, tb: int = 128,
                        tb_rows: Optional[int] = None, edge_weight=None,
                        max_slots: int = 32, dtype=torch.float32
                        ) -> Optional[PackedBanded]:
    """Row-packed ``tb_rows × tb`` block storage; None when some block-row
    needs more than ``max_slots`` nonzero blocks."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    tbr = tb_rows or tb
    w = _weights(edge_weight, senders.shape[0])
    nb = -(-num_nodes // tbr)
    nbc = -(-num_nodes // tb)
    rb = receivers // tbr
    cb = senders // tb
    key = rb * nbc + cb
    uniq, inv = np.unique(key, return_inverse=True)
    if len(uniq) == 0:
        return None
    inv = inv.reshape(-1)
    u_r = uniq // nbc
    u_c = uniq % nbc
    first = np.concatenate([[0], np.flatnonzero(np.diff(u_r)) + 1])
    gid = np.searchsorted(first, np.arange(len(uniq)), side="right") - 1
    rank = np.arange(len(uniq)) - first[gid]
    per_row = np.diff(np.concatenate([first, [len(uniq)]]))
    S = int(per_row.max())
    if S > max_slots:
        return None
    own = np.minimum(np.arange(nb, dtype=np.int64) * (tbr // tb)
                     if tbr >= tb else np.arange(nb, dtype=np.int64),
                     nbc - 1)
    cols = np.tile(own[:, None], (1, S))
    cols[u_r, rank] = u_c
    slot_of_edge = rank[inv]
    rloc = receivers - rb * tbr
    cloc = senders - cb * tb
    flat = ((slot_of_edge * nb + rb) * tbr + rloc) * tb + cloc
    shape = (S, nb, tbr, tb)
    host = np.zeros((int(np.prod(shape)),), np.float32)
    np.add.at(host, flat, w)
    return PackedBanded(blocks=_store(host, shape, dtype),
                        cols=torch.from_numpy(cols.astype(np.int32)),
                        nb=nb, tb=tb, num_nodes=num_nodes, tb_rows=tbr,
                        tiles=_host_index(host, shape, flat))


def block_spmm_f32(st, x: torch.Tensor) -> torch.Tensor:
    """``out[i] = Σ_s blocks[s, i] @ x_block(cols[i, s])`` over either
    block-band storage, f32 accumulation and output, ``(num_nodes, F)``;
    x blocks past ``num_nodes`` read zero rows. bf16 storage reads x in
    bf16."""
    tb, nb, tbr = st.tb, st.nb, st.row_height
    nbc = st.num_col_blocks
    cdt = torch.bfloat16 if st.blocks.dtype == torch.bfloat16 else x.dtype
    xp = torch.nn.functional.pad(x.to(cdt), (0, 0, 0, nbc * tb - x.shape[0]))
    xb = xp.float().reshape(nbc, tb, x.shape[1])
    out = xb.new_zeros((nb, tbr, x.shape[1]))
    cols = st.cols.to(torch.int64)
    for s in range(st.blocks.shape[0]):
        out += torch.bmm(st.blocks[s].float(), xb.index_select(0, cols[:, s]))
    return out.reshape(nb * tbr, -1)[: st.num_nodes]


# ------------------------------------------------------------ selection
def _bands_fit(n_bands: int, nb: int, max_bands: int) -> bool:
    """Dense bands' acceptance: at most ``max_bands`` block diagonals, and
    fewer than half of all of them."""
    return n_bands <= max_bands and n_bands < max((2 * nb - 1) // 2, 2)


def dense_band_gate(s, r, n: int, tb: int, max_bands: int = 16) -> tuple:
    """``(fits, n_bands)``: whether ``build_banded`` accepts the graph at
    ``tb × tb`` blocks, and its number of block diagonals."""
    n_bands = len(np.unique(np.asarray(s, np.int64) // tb
                            - np.asarray(r, np.int64) // tb))
    return _bands_fit(n_bands, -(-n // tb), max_bands), n_bands


def packed_gate(s, r, n: int) -> tuple:
    """``(fits, slots, row blocks)`` of the packed storage: it fits when
    each of at least 4 ``PACKED_TB_ROWS``-row block-rows is covered by at
    most ``PACKED_MAX_SLOTS`` nonzero ``PACKED_TB``-column blocks, and by
    fewer than half of all column blocks."""
    nbr = -(-n // PACKED_TB_ROWS)
    nbc = -(-n // PACKED_TB)
    pairs = np.unique((np.asarray(r, np.int64) // PACKED_TB_ROWS) * nbc
                      + np.asarray(s, np.int64) // PACKED_TB)
    per_row = np.bincount(pairs // nbc, minlength=nbr)
    slots = int(per_row.max()) if len(pairs) else 0
    fits = 0 < slots <= min(PACKED_MAX_SLOTS, (nbc - 1) // 2) and nbr >= 4
    return fits, slots, nbr


def structured_storages(s, r, n: int, tb: int, max_bands: int = 16,
                        dia: bool = True):
    """The structured storages whose gates these edges pass, lazily (a
    gate runs only when the ones before it gave no storage), in the JAX
    package's order: ``"hybrid"`` DIA, full ``"dia"``, ``"pbanded"``, dense
    ``"banded"`` bands."""
    plan = plan_dia(s, r, n) if dia else None
    if plan is not None:
        full = plan.full_ok and plan.full_bw <= DIA_MAX_BANDWIDTH
        if plan.hybrid_ok and (not full or 4 * plan.hybrid_bw <= plan.full_bw):
            yield "hybrid"
        if full:
            yield "dia"
    # packed bands when their traffic per pass (values + one x block per
    # slot, at a nominal F) is ≤ 0.9 of the dense bands', or dense bands
    # do not fit
    packed_fits, S_est, nb_pr = packed_gate(s, r, n)
    dense_fits, n_offs_dense = dense_band_gate(s, r, n, tb, max_bands)
    packed_traffic = S_est * nb_pr * PACKED_TB * (PACKED_TB_ROWS + F_NOM)
    dense_traffic = n_offs_dense * (-(-n // tb) * tb * tb + n * F_NOM)
    if packed_fits and (not dense_fits
                        or 10 * packed_traffic <= 9 * dense_traffic):
        yield "pbanded"
    if dense_fits:
        yield "banded"


def precompute_bsr(g: GnnGraph, *, tb: int = 256, edge_weight=None,
                   max_density: float = 0.25, dtype=torch.float32,
                   dia: bool = True, max_bands: int = 16) -> GnnGraph:
    """Attach the first structured storage that fits, in the order of
    ``structured_storages`` (``dia``/``dia_rev``/``dia_rem``, ``dia``/
    ``dia_rev``, ``pbanded``/``pbanded_rev``, ``banded``/``banded_rev``),
    else block-sparse rows (``bsr``) at density ≤ ``max_density``, else
    return ``g`` unchanged. The packed branch is taken only when both
    orientations pack: JAX caches ``pbanded_rev = None`` where the reverse
    does not (a reference fault)."""
    s, r = host_edges(g)
    n = g.num_nodes
    kw = dict(edge_weight=edge_weight, dtype=dtype)
    for kind in structured_storages(s, r, n, tb, max_bands, dia):
        if kind == "hybrid":
            hyb = build_dia_hybrid(s, r, n, **kw)
            if hyb is not None:
                dm, rem = hyb
                return g.copy(cache={**g.cache, "dia": dm,
                                     "dia_rev": transpose_dia(dm),
                                     "dia_rem": rem})
        elif kind == "dia":
            dm = build_dia(s, r, n, **kw)
            if dm is not None:
                return g.copy(cache={**g.cache, "dia": dm,
                                     "dia_rev": transpose_dia(dm)})
        elif kind == "pbanded":
            kw_p = dict(tb=PACKED_TB, tb_rows=PACKED_TB_ROWS, **kw)
            pb = build_packed_banded(s, r, n, **kw_p)
            pb_rev = None if pb is None else build_packed_banded(r, s, n,
                                                                 **kw_p)
            if pb_rev is not None:
                return g.copy(cache={**g.cache, "pbanded": pb,
                                     "pbanded_rev": pb_rev})
        else:
            kw_b = dict(tb=tb, max_bands=max_bands, **kw)
            return g.copy(cache={**g.cache,
                                 "banded": build_banded(s, r, n, **kw_b),
                                 "banded_rev": build_banded(r, s, n, **kw_b)})
    # the density gate before the build: ``build_bsr`` allocates every
    # occupied block (106 GiB on an ogbn-arxiv-sized graph, where JAX's
    # order gates after the allocation)
    nb = -(-n // tb)
    nnzb = len(np.unique(np.asarray(r, np.int64) // tb * nb
                         + np.asarray(s, np.int64) // tb))
    if nnzb / float(nb * nb) > max_density:
        return g
    bsr = build_bsr(s, r, n, tb=tb, edge_weight=edge_weight, dtype=dtype)
    return g.copy(cache={**g.cache, "bsr": bsr})
