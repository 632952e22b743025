"""Block bands (K4 packed, K7 dense), the hybrid DIA, RCM and
``precompute(auto_reorder=True)``: the port against the JAX package on the
CPU.

Host builds must be bit-equal (both run the same numpy code); orders and
permutations integer-equal. The plain K4/K7 versions (which CPU tensors
take) are held to JAX's Pallas kernels in interpret mode on one small case
and to JAX's XLA formulations (``packed_banded_spmm`` / ``banded_spmm``)
otherwise, forward within rtol 1e-5 (sums in another order); the VJPs of
the port's ``autograd.Function``s against ``jax.vjp`` of the JAX custom
VJPs within 1e-4 of each gradient's largest entry.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per process: the suite runs in several pytest-xdist
# workers at once, and many small ops gain nothing from more threads
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import neuralgraphpde as J  # noqa: E402
import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde.graph import reorder as jro  # noqa: E402
from neuralgraphpde.kernels import banded_kernels as jbk  # noqa: E402
from neuralgraphpde.ops import bsr as jbsr  # noqa: E402
from neuralgraphpde.ops import dia as jdia  # noqa: E402
from neuralgraphpde_torch.kernels import banded_kernels as pbk  # noqa: E402
from neuralgraphpde_torch.ops import bsr as pbsr  # noqa: E402
from neuralgraphpde_torch.ops import dia as pdia  # noqa: E402

port_spmm = importlib.import_module("neuralgraphpde_torch.ops.spmm")
port_fused = importlib.import_module("neuralgraphpde_torch.ops.fused")
F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rcm_mesh(n=700, seed=2):
    """An RCM-relabeled Delaunay mesh (as ``tests/test_pbanded.py`` builds
    it) and per-edge weights."""
    rng = np.random.default_rng(seed)
    g = J.delaunay_graph(rng.uniform(size=(n, 2)).astype(np.float32))
    s = np.asarray(g.senders).astype(np.int64)
    r = np.asarray(g.receivers).astype(np.int64)
    order = jro.rcm_order(s, r, n)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    return inv[s], inv[r], n, rng.uniform(0.5, 1.5, len(s)).astype(
        np.float32), rng


def _stores(kind, s, r, n, w):
    """The same storage from both packages: (JAX, port, port transpose)."""
    if kind == "pbanded":
        kw = dict(tb=128, tb_rows=512 if n > 1536 else None, edge_weight=w)
        return (jbsr.build_packed_banded(s, r, n, **kw),
                pbsr.build_packed_banded(s, r, n, **kw),
                pbsr.build_packed_banded(r, s, n, **kw))
    kw = dict(tb=64, edge_weight=w, max_bands=24)
    return (jbsr.build_banded(s, r, n, **kw), pbsr.build_banded(s, r, n, **kw),
            pbsr.build_banded(r, s, n, **kw))


# -------------------------------------------------------------- builders
@pytest.mark.parametrize("builder", ["packed", "packed_tall", "banded",
                                     "bsr", "dia_hybrid"])
@pytest.mark.parametrize("weighted", [False, True])
def test_builders_bit_equal(builder, weighted):
    s, r, n, w, _ = _rcm_mesh()
    w = w if weighted else None
    if builder == "dia_hybrid":
        g = J.add_self_loops(J.grid_graph_2d(24, 20, periodic=True,
                                             diagonals=True))
        s, r = np.asarray(g.senders), np.asarray(g.receivers)
        n = g.num_nodes
        w = (np.random.default_rng(3).random(len(s)).astype(np.float32)
             if weighted else None)
        (dj, *rem_j) = jdia.build_dia_hybrid(s, r, n, edge_weight=w)
        dp, rem_p = pdia.build_dia_hybrid(s, r, n, edge_weight=w)
        assert dp.offsets == dj.offsets
        np.testing.assert_array_equal(dp.values.numpy(), np.asarray(dj.values))
        for a, b in zip(rem_p, rem_j):
            np.testing.assert_array_equal(a.numpy(), b)
        return
    if builder.startswith("packed"):
        kw = dict(tb=32, tb_rows=128 if builder == "packed_tall" else None)
        j = jbsr.build_packed_banded(s, r, n, edge_weight=w, **kw)
        p = pbsr.build_packed_banded(s, r, n, edge_weight=w, **kw)
        pairs = [(p.blocks, j.blocks), (p.cols, j.cols)]
        assert (p.nb, p.tb, p.row_height, p.num_col_blocks) == (
            j.nb, j.tb, j.row_height, j.num_col_blocks)
    elif builder == "banded":
        j = jbsr.build_banded(s, r, n, tb=64, edge_weight=w, max_bands=24)
        p = pbsr.build_banded(s, r, n, tb=64, edge_weight=w, max_bands=24)
        assert p.offsets == j.offsets and (p.nb, p.tb) == (j.nb, j.tb)
        i = np.arange(p.nb)[:, None]
        cols = np.clip(i + np.asarray(p.offsets)[None, :], 0, p.nb - 1)
        pairs = [(p.bands, j.bands), (p.cols, cols)]
    else:
        j = jbsr.build_bsr(s, r, n, tb=64, edge_weight=w)
        p = pbsr.build_bsr(s, r, n, tb=64, edge_weight=w)
        assert p.density == j.density
        pairs = [(p.blocks, j.blocks), (p.col_blocks, j.col_blocks),
                 (p.row_blocks, j.row_blocks)]
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rcm_and_reorder_graph_match_jax():
    """RCM and Morton orders, the relabeled graph and its edge permutation,
    and ``permute_nodes`` / ``unpermute_nodes`` on numpy and torch."""
    pts = np.random.default_rng(4).random((500, 2)).astype(np.float32)
    gj, gp = J.delaunay_graph(pts), P.delaunay_graph(pts)
    s, r = np.asarray(gj.senders), np.asarray(gj.receivers)
    oj, op = jro.rcm_order(s, r, 500), P.rcm_order(s, r, 500)
    np.testing.assert_array_equal(op, oj)
    np.testing.assert_array_equal(P.morton_order(pts), jro.morton_order(pts))
    assert P.bandwidth(s, r) == jro.bandwidth(s, r)
    rj, ej = jro.reorder_graph(gj, oj, return_edge_perm=True)
    rp, ep = P.reorder_graph(gp, op, return_edge_perm=True)
    np.testing.assert_array_equal(ep, ej)
    np.testing.assert_array_equal(rp.senders.numpy(), np.asarray(rj.senders))
    np.testing.assert_array_equal(rp.receivers.numpy(),
                                  np.asarray(rj.receivers))
    assert rp.receivers_sorted and P.bandwidth(*rp.host_coo) < P.bandwidth(
        s, r)
    x = np.random.default_rng(5).normal(size=(500, 3)).astype(np.float32)
    np.testing.assert_array_equal(P.permute_nodes(x, op),
                                  np.asarray(jro.permute_nodes(x, oj)))
    xt = P.permute_nodes(torch.from_numpy(x), op)
    np.testing.assert_array_equal(xt.numpy(), x[op])
    np.testing.assert_array_equal(P.unpermute_nodes(xt, op).numpy(), x)
    np.testing.assert_array_equal(P.unpermute_nodes(x[op], op), x)
    # the convenience forms, positions carried in ndata
    for fj, fp in ((jro.rcm_reorder, P.rcm_reorder),
                   (jro.spatial_reorder, P.spatial_reorder)):
        (gj2, oj2) = fj(gj.replace(ndata={"x": pts}))
        (gp2, op2) = fp(gp.replace(ndata={"x": pts}))
        np.testing.assert_array_equal(op2, oj2)
        np.testing.assert_array_equal(gp2.senders.numpy(),
                                      np.asarray(gj2.senders))
        np.testing.assert_array_equal(gp2.ndata["x"].numpy(),
                                      np.asarray(gj2.ndata["x"]))


# ------------------------------------------------- plain kernels vs JAX
@pytest.mark.parametrize("kind", ["pbanded", "banded"])
def test_plain_matches_interpret_kernel(kind):
    """One small case against the Pallas kernels in interpret mode: the
    SpMM and the fused tanh right-hand side with W and b."""
    s, r, n, w_e, rng = _rcm_mesh(n=300, seed=7)
    j, p, _ = _stores(kind, s, r, n, w_e)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    w = (rng.normal(size=(8, 5)) / 3).astype(np.float32)
    b = (rng.normal(size=(1, 5)) / 10).astype(np.float32)
    spmm_fwd, rhs_fwd = ((jbk._pbanded_spmm_fwd, jbk._pbanded_rhs_fwd)
                         if kind == "pbanded" else
                         (jbk._banded_spmm_fwd, jbk._banded_rhs_fwd))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(spmm_fwd(j, jnp.asarray(x), interpret=True))
        want_r = np.asarray(rhs_fwd(j, jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), act="tanh",
                                    interpret=True))
    t = torch.from_numpy
    spmm_p, rhs_p = ((pbk.pbanded_spmm_pallas, pbk.pbanded_gcn_rhs)
                     if kind == "pbanded" else
                     (pbk.banded_spmm_pallas, pbk.banded_gcn_rhs))
    np.testing.assert_allclose(spmm_p(t(x), p).numpy(), want, **F32)
    np.testing.assert_allclose(rhs_p("tanh", t(x), t(w), t(b), p).numpy(),
                               want_r, **F32)


def _jax_rhs_ref(kind, j, x, w, b, act):
    """The fused right-hand side in XLA: the reference formulation."""
    agg = (jbsr.packed_banded_spmm if kind == "pbanded"
           else jbsr.banded_spmm)(j, x)
    h = agg
    if w is not None:
        h = jnp.dot(h, w, precision=jax.lax.Precision.HIGHEST)
    if b is not None:
        h = h + b
    return jbk._EPILOGUE_ACTS["identity" if act is None else act](h)


_RHS_CASES = [("tanh", True, True), ("relu", True, False),
              ("sigmoid", True, True), (None, True, True),
              ("identity", False, True), ("tanh", False, False)]


@pytest.mark.parametrize("kind", ["pbanded", "banded"])
@pytest.mark.parametrize("act,has_w,has_b", _RHS_CASES)
def test_plain_rhs_matches_jax(kind, act, has_w, has_b):
    """Every epilogue activation, with and without W and b; without W the
    input is the pre-multiplied ``x @ W`` (the out < in convention)."""
    s, r, n, w_e, rng = _rcm_mesh(n=2000 if kind == "pbanded" else 700)
    j, p, _ = _stores(kind, s, r, n, w_e)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    w = (rng.normal(size=(12, 7)) / 3).astype(np.float32)
    if not has_w:
        x = x @ w
    b = (rng.normal(size=(1, 7)) / 10).astype(np.float32) if has_b else None
    w = w if has_w else None
    want = _jax_rhs_ref(kind, j, jnp.asarray(x),
                        None if w is None else jnp.asarray(w),
                        None if b is None else jnp.asarray(b), act)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    rhs = pbk.pbanded_gcn_rhs if kind == "pbanded" else pbk.banded_gcn_rhs
    got = rhs(act, t(x), t(w), t(b), p)
    assert got.dtype == torch.float32 and got.shape == (n, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    spmm = (pbk.pbanded_spmm_pallas if kind == "pbanded"
            else pbk.banded_spmm_pallas)
    want_s = (jbsr.packed_banded_spmm if kind == "pbanded"
              else jbsr.banded_spmm)(j, jnp.asarray(x))
    np.testing.assert_allclose(spmm(t(x), p).numpy(), np.asarray(want_s),
                               **F32)


@pytest.mark.parametrize("kind", ["pbanded", "banded"])
def test_plain_bf16_matches_jax(kind):
    """bf16 storage: x read in bf16, W cast to bf16, the aggregate rounded
    to bf16 before the W product, f32 accumulation and output."""
    s, r, n, w_e, rng = _rcm_mesh(n=2000 if kind == "pbanded" else 700)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    w = (rng.normal(size=(16, 16)) / 4).astype(np.float32)
    b = rng.normal(size=(1, 16)).astype(np.float32)
    if kind == "pbanded":
        kw = dict(tb=128, tb_rows=512, edge_weight=w_e)
        j = jbsr.build_packed_banded(s, r, n, dtype=jnp.bfloat16, **kw)
        p = pbsr.build_packed_banded(s, r, n, dtype=torch.bfloat16, **kw)
    else:
        kw = dict(tb=64, edge_weight=w_e, max_bands=24)
        j = jbsr.build_banded(s, r, n, dtype=jnp.bfloat16, **kw)
        p = pbsr.build_banded(s, r, n, dtype=torch.bfloat16, **kw)
    agg = (jbsr.packed_banded_spmm if kind == "pbanded"
           else jbsr.banded_spmm)(j, jnp.asarray(x))  # bf16 reads
    want = jnp.tanh(jnp.dot(agg.astype(jnp.bfloat16),
                            jnp.asarray(w).astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
                    + jnp.asarray(b))
    rhs = pbk.pbanded_gcn_rhs if kind == "pbanded" else pbk.banded_gcn_rhs
    got = rhs("tanh", torch.from_numpy(x), torch.from_numpy(w),
              torch.from_numpy(b), p)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(want)) < 2e-2


@pytest.mark.parametrize("kind", ["pbanded", "banded"])
@pytest.mark.parametrize("act,has_w,has_b", [("tanh", True, True),
                                             ("relu", True, False),
                                             ("sigmoid", False, True)])
def test_vjps_match_jax(kind, act, has_w, has_b):
    """The port's backward (the kernel's plain version on the transposed
    storage, the aggregate recomputed for dW) against ``jax.vjp`` of the
    JAX custom VJPs (Pallas in interpret mode); the SpMM's backward too."""
    s, r, n, w_e, rng = _rcm_mesh(n=300, seed=8)
    j, p, p_rev = _stores(kind, s, r, n, w_e)
    j_rev = (jbsr.build_packed_banded(r, s, n, tb=128, edge_weight=w_e)
             if kind == "pbanded" else
             jbsr.build_banded(r, s, n, tb=64, edge_weight=w_e, max_bands=24))
    x = rng.normal(size=(n, 6)).astype(np.float32)
    w = (rng.normal(size=(6, 6)) / 3).astype(np.float32) if has_w else None
    b = (rng.normal(size=(1, 6)) / 10).astype(np.float32) if has_b else None
    g = rng.normal(size=(n, 6)).astype(np.float32)
    jrhs, jspmm = ((jbk.pbanded_gcn_rhs, jbk.pbanded_spmm_pallas)
                   if kind == "pbanded" else
                   (jbk.banded_gcn_rhs, jbk.banded_spmm_pallas))
    args = [jnp.asarray(a) for a in (x, w, b) if a is not None]

    def jfn(*a):
        it = iter(a)
        xx = next(it)
        ww = next(it) if has_w else None
        bb = next(it) if has_b else None
        return jrhs(act, xx, ww, bb, j, j_rev)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jfn, *args)
        want = vjp(jnp.asarray(g))
        _, vjp_s = jax.vjp(lambda xx: jspmm(xx, j, j_rev), jnp.asarray(x))
        want_s = vjp_s(jnp.asarray(g))[0]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)
              if a is not None]
    it = iter(leaves)
    xt = next(it)
    wt = next(it) if has_w else None
    bt = next(it) if has_b else None
    rhs = pbk.pbanded_gcn_rhs if kind == "pbanded" else pbk.banded_gcn_rhs
    rhs(act, xt, wt, bt, p, p_rev).backward(torch.from_numpy(g))
    for leaf, ref in zip(leaves, want):
        assert leaf.grad.shape == tuple(ref.shape)
        assert _rel(leaf.grad.numpy(), np.asarray(ref)) <= GRAD
    spmm = (pbk.pbanded_spmm_pallas if kind == "pbanded"
            else pbk.banded_spmm_pallas)
    xs = torch.from_numpy(x).requires_grad_()
    spmm(xs, p, p_rev).backward(torch.from_numpy(g))
    assert _rel(xs.grad.numpy(), np.asarray(want_s)) <= GRAD
    if kind == "banded":  # no prebuilt transpose: bands transposed on the fly
        xs.grad = None
        spmm(xs, p, None).backward(torch.from_numpy(g))
        assert _rel(xs.grad.numpy(), np.asarray(want_s)) <= GRAD
    else:  # the packed backward needs its transpose, as in JAX
        with pytest.raises(NotImplementedError, match="pb_rev"):
            spmm(xs, p, None).backward(torch.from_numpy(g))


# ------------------------------------------------------------- precompute
def _mesh_pair(points):
    if points == "periodic":
        return (J.grid_graph_2d(40, 40, periodic=True, diagonals=True),
                P.grid_graph_2d(40, 40, periodic=True, diagonals=True))
    pts = np.random.default_rng(0).random((points, 2)).astype(np.float32)
    return J.delaunay_graph(pts), P.delaunay_graph(pts)


_STORE_KEYS = {
    "banded": ("banded", "banded_rev", "banded_norm", "banded_norm_rev"),
    "pbanded": ("pbanded", "pbanded_rev", "pbanded_norm", "pbanded_norm_rev"),
    "dia": ("dia", "dia_rev")}


@pytest.mark.parametrize("points,storage", [
    (1200, "banded"), (2000, "pbanded"), (3000, "banded"), (6000, "pbanded"),
    ("periodic", "dia")])
def test_precompute_auto_reorder_matches_jax(points, storage):
    """Scrambled-label Delaunay meshes (``default_rng(0)`` points) and a
    periodic 40×40 grid: the same cache keys, ``node_order``,
    ``orig_edge_pos``, edges, and storage arrays as JAX."""
    gj, gp = _mesh_pair(points)
    kw = dict(add_self_loops=True, dense=False, auto_reorder=True)
    cj, cp = J.precompute(gj, **kw), P.precompute(gp, **kw)
    assert sorted(cp.cache) == sorted(cj.cache)
    np.testing.assert_array_equal(cp.senders.numpy(), np.asarray(cj.senders))
    np.testing.assert_array_equal(cp.receivers.numpy(),
                                  np.asarray(cj.receivers))
    for key in ("node_order", "orig_edge_pos", "in_degree"):
        if key in cj.cache:
            np.testing.assert_array_equal(cp.cache[key].numpy(),
                                          np.asarray(cj.cache[key]))
    assert ("node_order" in cp.cache) == (points != "periodic")
    for key in _STORE_KEYS[storage]:
        sj, sp = cj.cache[key], cp.cache[key]
        if storage == "pbanded":
            np.testing.assert_array_equal(sp.cols.numpy(), np.asarray(sj.cols))
        vals = {"banded": "bands", "pbanded": "blocks", "dia": "values"}
        np.testing.assert_array_equal(
            getattr(sp, vals[storage]).numpy(),
            np.asarray(getattr(sj, vals[storage])))
    if storage == "dia":
        assert "dia_rem" in cp.cache and "dia_norm" not in cp.cache
        for a, b in zip(cp.cache["dia_rem"], cj.cache["dia_rem"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_auto_reorder_edge_weights_follow_the_relabeling():
    """Runtime edge weights given in the original edge order are realigned
    by the reorder and the receiver sort: the weighted degree and SpMM of
    the relabeled graph equal the original graph's, relabeled."""
    pts = np.random.default_rng(1).random((1500, 2)).astype(np.float32)
    g = P.delaunay_graph(pts)
    w = np.random.default_rng(2).random(g.num_edges).astype(np.float32)
    c = P.precompute(g, dense=False, auto_reorder=True, edge_weight=w)
    order = c.cache["node_order"].numpy()
    want_deg = np.bincount(g.host_coo[1], weights=w, minlength=1500)
    np.testing.assert_allclose(
        P.unpermute_nodes(c.cache["in_degree"].numpy(), order), want_deg,
        rtol=1e-5)
    x = np.random.default_rng(3).normal(size=(1500, 4)).astype(np.float32)
    want = port_spmm.spmm_xla(g, torch.from_numpy(x),
                              torch.from_numpy(w)).numpy()
    got = port_spmm.spmm_pallas(c, torch.from_numpy(P.permute_nodes(x, order)))
    np.testing.assert_allclose(P.unpermute_nodes(got.numpy(), order), want,
                               rtol=1e-5, atol=1e-5)


def test_packed_gate_needs_both_orientations():
    """A fan-out graph: each 512-row block-row receives from one 128-column
    block, but the 40 senders sit in one column block, so the transpose
    needs 40 slots in one block-row (more than 32). JAX attaches
    ``pbanded`` with ``pbanded_rev = None`` (a reference fault); the port
    takes the packed branch only when both orientations pack and falls
    through (here to block-sparse rows), and its SpMM stays exact."""
    n = 512 * 40
    i = np.arange(40)
    s, r = i.astype(np.int32), (512 * i).astype(np.int32)
    gj = J.GnnGraph.from_coo(s, r, num_nodes=n)
    gp = P.GnnGraph.from_coo(s, r, num_nodes=n)
    cj, cp = J.precompute(gj, dense=False), P.precompute(gp, dense=False)
    assert "pbanded" in cj.cache and cj.cache["pbanded_rev"] is None
    assert "pbanded" not in cp.cache and "pbanded_rev" not in cp.cache
    assert "bsr" in cp.cache
    x = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    P.set_spmm_mode("bsr")
    try:
        got = P.spmm(cp, torch.from_numpy(x)).numpy()
    finally:
        P.set_spmm_mode("auto")
    want = port_spmm.spmm_xla(cp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **F32)


def test_normalized_bands_keep_the_cap_that_chose_the_bands(monkeypatch):
    """A Delaunay mesh on a 2 × 1 strip, 500 points, 8 × 8 blocks: after
    the RCM relabeling its dense bands take 19 block diagonals, which only
    the raised cap after a reorder (24) admits, and it is too small to
    pack. The degree-normalized bands are built at that cap, so the fused
    GCN right-hand side (K7's plain version on the CPU) runs and equals
    the exact path. JAX rebuilds them at its default cap of 16 and caches
    ``banded_norm = None`` (a reference fault); the keys and the other
    storage are JAX's."""
    pts = (np.random.default_rng(0).random((500, 2))
           * np.array([2.0, 1.0])).astype(np.float32)
    kw = dict(add_self_loops=True, dense=False, auto_reorder=True, bsr_tb=8)
    cj = J.precompute(J.delaunay_graph(pts), **kw)
    cp = P.precompute(P.delaunay_graph(pts), **kw)
    assert sorted(cp.cache) == sorted(cj.cache)
    assert "node_order" in cp.cache and "pbanded" not in cp.cache
    assert cj.cache["banded_norm"] is None  # the reference fault
    for key in ("banded", "banded_rev"):
        assert cp.cache[key].offsets == cj.cache[key].offsets
        np.testing.assert_array_equal(cp.cache[key].bands.numpy(),
                                      np.asarray(cj.cache[key].bands))
    band = cp.cache["banded"]
    assert 16 < len(band.offsets) <= port_spmm.AUTO_REORDER_MAX_BANDS
    for key in ("banded_norm", "banded_norm_rev"):
        assert cp.cache[key].offsets == cp.cache[
            key.replace("_norm", "")].offsets
    assert cp.cache["banded_norm"].tb == band.tb == 8
    conv = P.GCNConv(6, 5, "tanh", generator=torch.Generator().manual_seed(1))
    P.update_graph(conv, cp)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(500, 6)).astype(np.float32))
    calls = []
    orig = port_fused.banded_gcn_rhs
    monkeypatch.setattr(port_fused, "banded_gcn_rhs",
                        lambda *a: calls.append(1) or orig(*a))
    try:
        P.set_spmm_mode("bsr")
        got = conv(x)
        P.set_spmm_mode("xla")
        want = conv(x)
    finally:
        P.set_spmm_mode("auto")
    assert calls == [1]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **F32)


def test_dense_block_graph_skips_the_bsr_build(monkeypatch):
    """A random graph whose 256 × 256 blocks are nearly all occupied fails
    the block-sparse density gate: ``precompute`` returns without building
    ``build_bsr``'s ``(nnzb, tb, tb)`` blocks (JAX builds them first, then
    gates: a reference fault, 106 GiB on an ogbn-arxiv-sized graph) and
    with JAX's keys."""
    gj, gp = J.rand_graph(1100, 3000, seed=1), P.rand_graph(1100, 3000,
                                                            seed=1)
    def refuse(*a, **k):
        raise AssertionError("build_bsr ran above the density gate")

    monkeypatch.setattr(pbsr, "build_bsr", refuse)
    cj, cp = J.precompute(gj, dense=False), P.precompute(gp, dense=False)
    assert sorted(cp.cache) == sorted(cj.cache)
    assert "bsr" not in cp.cache


@pytest.mark.parametrize("graph", ["pbanded", "banded", "dia_rem", "bsr"])
def test_structured_spmm_matches_jax(graph):
    """``spmm`` in ``bsr`` mode on each structured storage equals the JAX
    package's on the same graph (its XLA formulations on the CPU), and its
    gradient equals the gather/scatter path's."""
    if graph == "dia_rem":
        gj = J.grid_graph_2d(40, 40, periodic=True, diagonals=True)
        gp = P.grid_graph_2d(40, 40, periodic=True, diagonals=True)
        kw = dict(dense=False, bsr=True)
    elif graph == "bsr":
        gj, gp = J.rand_graph(1100, 3000, seed=1), P.rand_graph(1100, 3000,
                                                                seed=1)
        kw = dict(dense=False, bsr=True)
    else:
        gj, gp = _mesh_pair(2000 if graph == "pbanded" else 1200)
        kw = dict(dense=False, auto_reorder=True)
    cj, cp = J.precompute(gj, **kw), P.precompute(gp, **kw)
    if graph == "bsr":  # a sparse random graph at the density gate
        cj = J.precompute(gj, dense=False, bsr=False)
        cj = cj.copy(cache={**cj.cache, "bsr": jbsr.build_bsr(
            np.asarray(cj.senders), np.asarray(cj.receivers), 1100, tb=256)})
        cp = cp.copy(cache={**cp.cache, "bsr": pbsr.build_bsr(
            *pbsr.host_edges(cp), 1100, tb=256)})
    key = "dia" if graph == "dia_rem" else graph
    assert key in cp.cache and key in cj.cache
    x = np.random.default_rng(6).normal(size=(gj.num_nodes, 5)).astype(
        np.float32)
    J.set_spmm_mode("bsr")
    P.set_spmm_mode("bsr")
    try:
        want = np.asarray(J.spmm(cj, jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_()
        got = P.spmm(cp, xt)
        gy = torch.from_numpy(np.random.default_rng(7).normal(
            size=got.shape).astype(np.float32))
        got.backward(gy)
    finally:
        J.set_spmm_mode("auto")
        P.set_spmm_mode("auto")
    np.testing.assert_allclose(got.detach().numpy(), want, **F32)
    xr = torch.from_numpy(x).requires_grad_()
    port_spmm.spmm_xla(cp, xr).backward(gy)
    assert _rel(xt.grad.numpy(), xr.grad.numpy()) <= GRAD


# ------------------------------------------------------- sub-tile index
def _index_case(case):
    """A port storage with its sub-tile index: packed (``tb`` 32 square and
    512 × 128 tall, whose block-rows use fewer slots than S) and dense
    bands on the RCM mesh, the dense bands' on-the-fly transpose, a bf16
    copy made with ``dataclasses.replace``, storages with no empty slot (a
    periodic chain packed, a block-diagonal graph banded), and storages
    with all-empty tiles (200 isolated nodes in the middle of the mesh)."""
    s, r, n, w, _ = _rcm_mesh()
    if case == "isolated_packed" or case == "isolated_banded":
        s, r, n = s + 200 * (s >= 300), r + 200 * (r >= 300), n + 200
    if case == "ring_packed":
        n = 2048
        i = np.arange(n)
        s = np.concatenate([i, i, (i + 1) % n])
        r = np.concatenate([i, (i + 1) % n, i])
        w = np.linspace(0.5, 1.5, len(s)).astype(np.float32)
    if case == "blockdiag_banded":
        n = 256
        i = np.arange(n)
        s = np.concatenate([i, i ^ 1, i ^ 7])
        r = np.concatenate([i, i, i])
        w = np.linspace(0.5, 1.5, len(s)).astype(np.float32)
    if case in ("packed", "isolated_packed", "ring_packed"):
        return pbsr.build_packed_banded(s, r, n, tb=32, edge_weight=w)
    if case == "packed_tall":
        n = 2000
        s, r, n, w, _ = _rcm_mesh(n=n)
        return pbsr.build_packed_banded(s, r, n, tb=128, tb_rows=512,
                                        edge_weight=w)
    bm = pbsr.build_banded(s, r, n, tb=64, edge_weight=w, max_bands=24)
    if case == "transposed":
        return pbsr.transpose_banded(bm)
    if case == "bf16":
        return dataclasses.replace(bm, bands=bm.bands.to(torch.bfloat16))
    return bm


_INDEX_CASES = ["packed", "packed_tall", "banded", "transposed", "bf16",
                "ring_packed", "blockdiag_banded", "isolated_packed",
                "isolated_banded"]


def _occupied(st):
    """(S, nb, tiles, chunks) bool: which sub-tiles hold a nonzero."""
    S, nb, tbr, tb = st.blocks.shape
    R, C = st.tiles.rows, st.tiles.cols
    tiles, chunks = -(-tbr // R), -(-tb // C)
    nz = torch.nn.functional.pad(st.blocks.float() != 0,
                                 (0, chunks * C - tb, 0, tiles * R - tbr))
    return nz.reshape(S, nb, tiles, R, chunks, C).any(5).any(3).numpy()


@pytest.mark.parametrize("case", _INDEX_CASES)
def test_subtile_index_lists_exactly_the_occupied(case):
    """Every stored nonzero lies in a listed sub-tile, no listed sub-tile is
    all zero, and each tile's entries ascend."""
    st = _index_case(case)
    idx = st.tiles
    assert (idx.rows, idx.cols) == (pbsr.SUBTILE_ROWS, pbsr.SUBTILE_COLS)
    assert idx.ptr.dtype == idx.ent.dtype == torch.int32
    occ = _occupied(st)
    S, nb, tiles, chunks = occ.shape
    ptr, ent = idx.ptr.numpy(), idx.ent.numpy()
    assert ptr.shape == (nb * tiles + 1,) and ptr[0] == 0
    assert ptr[-1] == len(ent) and (np.diff(ptr) >= 0).all()
    listed = np.zeros_like(occ)
    for t in range(nb * tiles):
        row = ent[ptr[t]:ptr[t + 1]]
        assert (np.diff(row) > 0).all()
        listed[row // chunks, t // tiles, t % tiles, row % chunks] = True
    np.testing.assert_array_equal(listed, occ)
    if case.startswith("isolated"):
        assert (np.diff(ptr) == 0).any()  # an all-empty tile
    empty_slots = ~(st.blocks.float() != 0).any(-1).any(-1).numpy()
    assert empty_slots.any() == (case not in ("ring_packed",
                                              "blockdiag_banded"))


def _walk_subtiles(st, x):
    """The kernel's walk in torch: each tile sums its listed sub-tiles'
    products with their x chunks, in list order; f32."""
    S, nb, tbr, tb = st.blocks.shape
    R, C = st.tiles.rows, st.tiles.cols
    tiles, chunks = -(-tbr // R), -(-tb // C)
    cdt = torch.bfloat16 if st.blocks.dtype == torch.bfloat16 else x.dtype
    xp = torch.nn.functional.pad(x.to(cdt).float(),
                                 (0, 0, 0, st.num_col_blocks * tb + C))
    out = torch.zeros(nb * tbr, x.shape[1])
    ptr, ent = st.tiles.ptr.tolist(), st.tiles.ent.tolist()
    for t in range(nb * tiles):
        i, r0 = t // tiles, (t % tiles) * R
        for e in ent[ptr[t]:ptr[t + 1]]:
            s, c0 = e // chunks, (e % chunks) * C
            a = st.blocks[s, i, r0:r0 + R, c0:c0 + C].float()
            x0 = int(st.cols[i, s]) * tb + c0
            out[i * tbr + r0:i * tbr + r0 + a.shape[0]] += a @ xp[
                x0:x0 + a.shape[1]]
    return out[:st.num_nodes]


@pytest.mark.parametrize("case", _INDEX_CASES)
def test_listed_subtiles_sum_to_block_spmm(case):
    """The listed sub-tiles' products alone give the plain version's
    ``A @ x`` (within 1e-6 of its largest entry): what the index leaves out
    is all zero."""
    st = _index_case(case)
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(st.num_nodes, 5)).astype(np.float32))
    want = pbsr.block_spmm_f32(st, x)
    assert _rel(_walk_subtiles(st, x).numpy(), want.numpy()) <= 1e-6


@pytest.mark.parametrize("wrong", ["other_storage", "ptr_int64",
                                   "ent_too_long"])
@pytest.mark.parametrize("kind", ["packed", "banded"])
def test_block_call_refuses_an_index_made_for_other_blocks(kind, wrong):
    """The K4/K7 wrappers check the index's shape against the blocks before
    any product (on the CPU too), and count no launch."""
    st = _index_case(kind)
    other = _index_case("packed_tall" if kind == "packed" else "transposed")
    idx = st.tiles
    bad = {"other_storage": other.tiles if kind == "packed" else
           dataclasses.replace(idx, ptr=idx.ptr[:-1]),
           "ptr_int64": dataclasses.replace(idx, ptr=idx.ptr.long()),
           "ent_too_long": dataclasses.replace(idx, ent=torch.zeros(
               st.blocks.numel(), dtype=torch.int32))}[wrong]
    bad_st = dataclasses.replace(st, tiles=bad)
    spmm = (pbk.pbanded_spmm_pallas if kind == "packed"
            else pbk.banded_spmm_pallas)
    x = torch.ones(st.num_nodes, 4)
    before = spmm.launches
    torch.testing.assert_close(spmm(x, st), pbsr.block_spmm_f32(st, x))
    with pytest.raises(ValueError, match="not made for blocks"):
        spmm(x, bad_st)
    assert spmm.launches == before
