"""K1 (segment SpMM), K2 (DIA stencil / fused GCN RHS) and K6 (segment
max): the port's plain versions against the JAX Pallas kernels in
interpret mode on the CPU, and the CUDA kernels (K1, K2, K6, K4 and K7, and
K3 and K5 forward and backward; K1, K2, K4 and K7 also under autograd)
against the plain versions on a card. K4/K7's CPU parity with JAX is in
``test_torch_banded.py``. K3's CPU
parity with JAX is in ``test_torch_vmh.py``, K5's in ``test_torch_gno.py``;
here K5's plain forward is also held to a per-edge numpy loop.

Tolerances: f32 rtol 1e-5 / atol 1e-6 (the sums are taken in another order);
bf16 2e-2 of the largest value (both sides read the same bf16 inputs; the
output rounds to bf16). K3 on the card: max |kernel − plain| ≤ 1e-5 of the
largest value for the forward and ``dfeats``, 1e-4 for ``dW``/``db``, which
are sums over every edge taken in another order; K5 the same: 1e-5 for the
forward, ``dph`` and ``dh``, 1e-4 for ``dWl``/``dbl``. K6: exact equality
everywhere (a max takes no rounding, whatever the order), and its backward
equal to the plain backward's bits. JAX is imported inside the
fixture and the card is looked for inside the test (the CUDA cases carry
the ``cuda`` marker), so this file also runs where only one of the two
exists: ``python -m pytest --noconftest tests/test_torch_kernels.py`` on a
machine with a GPU and no JAX runs the CUDA cases.
"""
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per process: the suite runs in several pytest-xdist
# workers at once, and many small ops gain nothing from more threads
torch.set_num_threads(1)

import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch import add_self_loops, grid_graph_2d  # noqa: E402
from neuralgraphpde_torch.kernels import banded_kernels as BK  # noqa: E402
from neuralgraphpde_torch.kernels import fused_mlp_kernels as K3  # noqa
from neuralgraphpde_torch.kernels import gno_kernels as K5  # noqa: E402
from neuralgraphpde_torch.kernels.dia_kernels import (  # noqa: E402
    RUN_MAX, dia_gcn_rhs, dia_rhs_plain, dia_spmm_stencil, offset_runs)
from neuralgraphpde_torch.kernels.segment_kernels import (  # noqa: E402
    build_segment_csr, segment_max, segment_max_aggregate, segment_max_plain,
    segment_spmm, segment_spmm_plain)
from neuralgraphpde_torch.ops.scatter import segment_reduce  # noqa: E402
from neuralgraphpde_torch.ops.dia import (  # noqa: E402
    build_dia, build_dia_hybrid, stencil_f32, transpose_dia)

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = 2e-2


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from neuralgraphpde.kernels import dia_kernels, segment_kernels
    from neuralgraphpde.ops import dia

    return types.SimpleNamespace(jnp=jnp, pltpu=pltpu, dia=dia,
                                 dk=dia_kernels, sk=segment_kernels)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _edges(n, e, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.normal(size=e).astype(np.float32), rng)


def _grid():
    g = add_self_loops(grid_graph_2d(20, 12, diagonals=True))
    return g.host_coo[0], g.host_coo[1], g.num_nodes


def _dia_graph(kind, weights=None, dtype=torch.float32):
    """K2's storages: ``grid`` (``_grid()``, 240 nodes), ``grid4`` (its
    4-neighbour form), ``large`` (a 161 × 130 8-neighbour grid: 20,930
    nodes, more 64-row tiles than a persistent grid has blocks) and
    ``periodic`` (the DIA part of the hybrid on a 32² periodic 8-neighbour
    grid). ``weights(E)`` gives the edge weights."""
    if kind == "grid":
        s, r, n = _grid()
    else:
        shape, extra = {"grid4": ((20, 12), dict(diagonals=False)),
                        "large": ((161, 130), dict(diagonals=True)),
                        "periodic": ((32, 32), dict(diagonals=True,
                                                    periodic=True))}[kind]
        g = add_self_loops(grid_graph_2d(*shape, **extra))
        (s, r), n = g.host_coo, g.num_nodes
    w = None if weights is None else weights(len(s))
    if kind == "periodic":
        return build_dia_hybrid(s, r, n, edge_weight=w, dtype=dtype)[0]
    return build_dia(s, r, n, edge_weight=w, dtype=dtype)


# ------------------------------------------------------------------- K1
@pytest.mark.parametrize("n,e,f,weighted", [
    (50, 200, 16, False), (100, 1000, 128, True), (33, 77, 24, True)])
def test_k1_matches_pallas(jx, n, e, f, weighted):
    s, r, w, rng = _edges(n, e, 0)
    w = w if weighted else None
    x = rng.normal(size=(n, f)).astype(np.float32)
    tcsr = jx.sk.build_tiled_csr(s, r, n, edge_weight=w, tn=16, te=32)
    want = np.asarray(jx.sk._tiled_segment_spmm_fwd(
        tcsr, jx.jnp.asarray(x), interpret=True))[:n]
    got = segment_spmm(torch.from_numpy(x),
                       build_segment_csr(s, r, n, edge_weight=w))
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_k1_bf16_matches_pallas(jx):
    """bf16 reads with f32 accumulation: ``compute_dtype`` on f32 x (f32
    out), and bf16 x (bf16 out)."""
    n, e, f = 40, 200, 16
    s, r, _, rng = _edges(n, e, 6)
    x = rng.normal(size=(n, f)).astype(np.float32)
    tcsr = jx.sk.build_tiled_csr(s, r, n, tn=8, te=32)
    csr = build_segment_csr(s, r, n)
    bf = jx.jnp.bfloat16
    want = jx.sk._tiled_segment_spmm_fwd(tcsr, jx.jnp.asarray(x),
                                         interpret=True, compute_dtype=bf)
    got = segment_spmm(torch.from_numpy(x), csr,
                       compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert _rel(got, np.asarray(want)[:n]) < BF16
    want16 = jx.sk._tiled_segment_spmm_fwd(tcsr, jx.jnp.asarray(x).astype(bf),
                                           interpret=True)
    got16 = segment_spmm(torch.from_numpy(x).to(torch.bfloat16), csr)
    assert got16.dtype == torch.bfloat16 and want16.dtype == bf
    assert _rel(got16.float(), np.asarray(want16, np.float32)[:n]) < BF16


# ------------------------------------------------------------------- K2
def test_dia_build_and_transpose_match_jax(jx):
    s, r, n = _grid()
    w = np.random.default_rng(2).random(len(s)).astype(np.float32)
    dj = jx.dia.build_dia(s, r, n, edge_weight=w)
    dp = build_dia(s, r, n, edge_weight=w)
    assert dp.offsets == dj.offsets and dp.padded_nodes % 512 == 0
    np.testing.assert_array_equal(dp.values.numpy(), np.asarray(dj.values))
    tj, tp = jx.dia.transpose_dia(dj), transpose_dia(dp)
    assert tp.offsets == tj.offsets
    np.testing.assert_array_equal(tp.values.numpy(), np.asarray(tj.values))


@pytest.mark.parametrize("act,has_w,has_b", [
    (False, False, False), ("tanh", True, True), ("relu", True, False),
    ("sigmoid", True, True), (None, True, True), ("tanh", False, True)])
def test_k2_f32_matches_pallas(jx, act, has_w, has_b):
    """Plain stencil (``act=False``) and the fused epilogue, W 12 → 7."""
    s, r, n = _grid()
    rng = np.random.default_rng(4)
    w_edge = rng.random(len(s)).astype(np.float32)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    w = rng.normal(size=(12, 7)).astype(np.float32) / 3 if has_w else None
    b_width = 7 if has_w else 12
    b = rng.normal(size=(1, b_width)).astype(np.float32) if has_b else None
    dj = jx.dia.build_dia(s, r, n, edge_weight=w_edge)
    dp = build_dia(s, r, n, edge_weight=w_edge)
    jnp = jx.jnp
    with jx.pltpu.force_tpu_interpret_mode():
        want = np.asarray(jx.dk._dia_rhs_fwd(
            dj, jnp.asarray(x), None if w is None else jnp.asarray(w),
            None if b is None else jnp.asarray(b), act=act,
            interpret=True))[:n]
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    if act is False:
        got = dia_spmm_stencil(t(x), dp)
    else:
        got = dia_gcn_rhs(act, t(x), t(w), t(b), dp)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("fused", [False, True])
def test_k2_bf16_matches_pallas(jx, fused):
    """bf16 values and x: W cast to bf16, the accumulator rounded to bf16
    before the W product, bf16 out."""
    s, r, n = _grid()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    w = rng.normal(size=(16, 16)).astype(np.float32) / 4
    b = rng.normal(size=(1, 16)).astype(np.float32)
    jnp = jx.jnp
    dj = jx.dia.build_dia(s, r, n, dtype=jnp.bfloat16)
    dp = build_dia(s, r, n, dtype=torch.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xp = torch.from_numpy(x).to(torch.bfloat16)
    with jx.pltpu.force_tpu_interpret_mode():
        if fused:
            want = jx.dk.dia_gcn_rhs("tanh", xj, jnp.asarray(w),
                                     jnp.asarray(b), dj, None)
            got = dia_gcn_rhs("tanh", xp, torch.from_numpy(w),
                              torch.from_numpy(b), dp)
        else:
            want = jx.dk.dia_spmm_pallas(xj, dj, None)
            got = dia_spmm_stencil(xp, dp)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got.float(), np.asarray(want, np.float32)) < BF16


def _stencil64(dm, x):
    """``stencil_f32``'s loop in x's dtype (float64 for the references)."""
    n = dm.num_nodes
    vals = dm.values[:n].to(x.dtype)
    acc = x.new_zeros((n, x.shape[1]))
    for k, d in enumerate(dm.offsets):
        lo, hi = max(0, -d), min(n, n - d)
        if lo < hi:
            acc[lo:hi] = acc[lo:hi] + vals[lo:hi, k:k + 1] * x[lo + d:hi + d]
    return acc


def _rhs64(dm, act, x, w, b, y):
    """``dia_rhs_plain``'s fused form in x's dtype: ``act((Ĉ x) W + b)``.
    Its relu keeps the entries where the f32 output ``y`` is positive, so
    that a pre-activation within rounding of 0 takes the VJP's side."""
    h = _stencil64(dm, x)
    if w is not None:
        h = h @ w
    if b is not None:
        h = h + b
    if act == "relu":
        return h * (y > 0).to(h.dtype)
    return {None: lambda v: v, "identity": lambda v: v, "tanh": torch.tanh,
            "sigmoid": torch.sigmoid}[act](h)


# the fused VJP's cases: (act, W 12 → 7, b); W None is the premultiplied
# encoder's form (relu), so out = F = 12
_K2_VJP_CASES = [("tanh", True, True), ("relu", True, False),
                 ("sigmoid", True, True), (None, True, True),
                 ("identity", True, False), ("tanh", False, True),
                 ("relu", False, True)]


@pytest.mark.parametrize("act,has_w,has_b", _K2_VJP_CASES)
@pytest.mark.parametrize("x_grad", [True, False])
def test_k2_backward_plain_matches_f64(act, has_w, has_b, x_grad):
    """On the CPU the fused VJP is its reassociated plain version
    (``dia_gcn_bwd_plain``: u = Ĉᵀ dz, dx = u Wᵀ, dW = xᵀ u, db = Σ dz):
    against autograd through the plain version in float64 on the 240-node
    grid (not a multiple of the card's 64-row tile), 1e-5 of the largest
    entry for dx, 1e-4 for dW and db. An x that needs no gradient gets
    none; each call counts one eager backward and no stencil launch."""
    s, r, n = _grid()
    rng = np.random.default_rng(31)
    dm = build_dia(s, r, n, edge_weight=rng.random(len(s)).astype(np.float32))
    f, o = 12, 7 if has_w else 12
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    w = (torch.from_numpy((rng.normal(size=(f, o)) / 3).astype(np.float32))
         if has_w else None)
    b = (torch.from_numpy(rng.normal(size=(1, o)).astype(np.float32))
         if has_b else None)
    g = torch.from_numpy(rng.normal(size=(n, o)).astype(np.float32))
    leaves = [None if t is None else t.clone().requires_grad_(grad)
              for t, grad in ((x, x_grad), (w, True), (b, True))]
    refs = [None if t is None else t.double().requires_grad_(grad)
            for t, grad in ((x, x_grad), (w, True), (b, True))]
    eager = dia_gcn_rhs.backward_eager
    stencil = dia_spmm_stencil.backward_launches
    y = dia_gcn_rhs(act, *leaves, dm, transpose_dia(dm))
    y.backward(g)
    assert dia_gcn_rhs.backward_eager == eager + 1
    assert dia_spmm_stencil.backward_launches == stencil
    _rhs64(dm, act, *refs, y.detach()).backward(g.double())
    for got, want, bound in zip(leaves, refs, (1e-5, 1e-4, 1e-4)):
        if got is None:
            continue
        if not got.requires_grad:
            assert got.grad is None
            continue
        assert _rel(got.grad, want.grad.float()) <= bound


@pytest.mark.parametrize("act,has_w,has_b", [
    (False, False, False), ("tanh", True, True), ("relu", True, False),
    ("sigmoid", True, True), (None, True, True), ("tanh", False, True)])
def test_k2_vjp_matches_pallas(jx, act, has_w, has_b):
    """The VJPs against the JAX package's custom VJPs through its Pallas
    kernel in interpret mode, on ``test_k2_f32_matches_pallas``'s cases:
    the stencil's (``act=False``) and the fused form's, whose port side is
    the reassociated ``dia_gcn_bwd_plain`` (JAX: the aggregate recomputed,
    ``dx`` = Ĉᵀ(dz Wᵀ)). 1e-5 of the largest entry for dx, 1e-4 for dW
    and db."""
    import jax

    s, r, n = _grid()
    rng = np.random.default_rng(4)
    w_edge = rng.random(len(s)).astype(np.float32)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    w = rng.normal(size=(12, 7)).astype(np.float32) / 3 if has_w else None
    o = 7 if has_w else 12
    b = rng.normal(size=(1, o)).astype(np.float32) if has_b else None
    g = rng.normal(size=(n, o)).astype(np.float32)
    dj = jx.dia.build_dia(s, r, n, edge_weight=w_edge)
    # Ĉᵀ built here: inside the VJP it would run eagerly between the
    # interpret-mode kernels' callbacks
    dj_rev = jax.block_until_ready(jx.dia.transpose_dia(dj))
    dp = build_dia(s, r, n, edge_weight=w_edge)
    jnp = jx.jnp
    given = [a for a in (x, w, b) if a is not None]

    def jax_fn(*args):
        it = iter(args)
        xa, wa, ba = (None if a is None else next(it) for a in (x, w, b))
        if act is False:
            return jx.dk.dia_spmm_pallas(xa, dj, dj_rev)
        return jx.dk.dia_gcn_rhs(act, xa, wa, ba, dj, dj_rev)

    with jx.pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, given))
        want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in given]
    it = iter(leaves)
    xt, wt, bt = (None if a is None else next(it) for a in (x, w, b))
    if act is False:
        dia_spmm_stencil(xt, dp, transpose_dia(dp)).backward(
            torch.from_numpy(g))
    else:
        dia_gcn_rhs(act, xt, wt, bt, dp, transpose_dia(dp)).backward(
            torch.from_numpy(g))
    for leaf, ref, bound in zip(leaves, want, (1e-5, 1e-4, 1e-4)):
        assert _rel(leaf.grad.numpy(), ref) <= bound


@pytest.mark.parametrize("kind", ["grid", "grid4", "periodic", "lone",
                                  "seven", "empty"])
def test_offset_runs(kind):
    """Every offset lies in one run, in ascending order; each run holds
    consecutive values, at most ``RUN_MAX`` of them. The grids' 9 offsets
    make three runs of 3."""
    offsets = {"grid": lambda: _dia_graph("grid").offsets,
               "grid4": lambda: _dia_graph("grid4").offsets,
               "periodic": lambda: _dia_graph("periodic").offsets,
               "lone": lambda: (5,), "seven": lambda: tuple(range(-3, 4)),
               "empty": lambda: ()}[kind]()
    runs = offset_runs(offsets)
    covered = [k for k0, length in runs for k in range(k0, k0 + length)]
    assert covered == list(range(len(offsets)))
    for k0, length in runs:
        assert 1 <= length <= RUN_MAX
        assert list(offsets[k0:k0 + length]) == list(
            range(offsets[k0], offsets[k0] + length))
    want = {"grid": ((0, 3), (3, 3), (6, 3)),
            "periodic": ((0, 3), (3, 3), (6, 3)),
            "grid4": ((0, 1), (1, 3), (4, 1)), "lone": ((0, 1),),
            "seven": ((0, 4), (4, 3)), "empty": ()}[kind]
    assert runs == want


def _run_schedule(dm, x, rows, max_len):
    """The kernel's aggregation schedule in torch: ``rows`` consecutive
    rows at a time; for each offset run, the ``rows + L − 1`` x rows it
    reads loaded once (zero outside ``[0, n)``), then ``vals[i, k] ·
    x[i + o_k]`` added for each row in ascending k."""
    n, F = x.shape
    vals = dm.values[:n].float()
    xf = x.float()
    out = torch.zeros(n, F)
    for row0 in range(0, n, rows):
        acc = torch.zeros(rows, F)
        for k0, length in offset_runs(dm.offsets, max_len):
            j = row0 + dm.offsets[k0] + torch.arange(rows + length - 1)
            ok = (j >= 0) & (j < n)
            xs = torch.where(ok[:, None], xf[j.clamp(0, n - 1)], 0.0)
            for r in range(min(rows, n - row0)):
                for ell in range(length):
                    acc[r] += vals[row0 + r, k0 + ell] * xs[r + ell]
        out[row0:row0 + rows] = acc[:n - row0]
    return out


@pytest.mark.parametrize("kind", ["grid", "grid4"])
@pytest.mark.parametrize("rows,max_len", [(4, RUN_MAX), (8, RUN_MAX),
                                          (7, RUN_MAX), (9, 2)])
def test_run_schedule_matches_stencil(kind, rows, max_len):
    """The run schedule equals ``stencil_f32`` within 1e-6 (n = 240 is not
    a multiple of 7 or 9)."""
    rng = np.random.default_rng(21)
    dm = _dia_graph(kind, lambda e: rng.random(e).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(dm.num_nodes, 6)).astype(
        np.float32))
    np.testing.assert_allclose(_run_schedule(dm, x, rows, max_len).numpy(),
                               stencil_f32(dm, x).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_wrappers_check_inputs():
    s, r, n = _grid()
    dm = build_dia(s, r, n)
    with pytest.raises(ValueError, match="F ≤ 512"):
        dia_gcn_rhs("tanh", torch.zeros(n, 513), None, None, dm)
    with pytest.raises(ValueError, match="must be"):
        dia_spmm_stencil(torch.zeros(n + 1, 4), dm)
    csr = build_segment_csr(s, r, n)
    with pytest.raises(ValueError, match="must be"):
        segment_spmm(torch.zeros(n, 4, 2), csr)
    # a tensor on neither the CPU nor the card takes no plain fallback
    with pytest.raises(RuntimeError, match="no kernel"):
        segment_spmm(torch.zeros(n, 4, device="meta"), csr)
    edges = build_segment_csr(np.arange(len(r)), r, n, num_cols=len(r))
    with pytest.raises(ValueError, match="must be"):
        segment_max(torch.zeros(len(r) + 1, 4), edges)
    with pytest.raises(TypeError, match="f32 or bf16"):
        segment_max(torch.zeros(len(r), 4, dtype=torch.float16), edges)
    with pytest.raises(RuntimeError, match="no kernel"):
        segment_max(torch.zeros(len(r), 4, device="meta"), edges)


# ------------------------------------------------------------------- K6
def _k6_case(n, e, f, seed=0):
    """``tests/test_kernels.py``'s segment-max problem: sorted random
    receivers (some rows receive none) and their edge-id layouts."""
    rng = np.random.default_rng(seed)
    r = np.sort(rng.integers(0, n, e))
    m = rng.normal(size=(e, f)).astype(np.float32)
    return r, m, build_segment_csr(np.arange(e), r, n, num_cols=e), rng


@pytest.mark.parametrize("n,e,f,tn,te", [
    (50, 300, 16, 8, 32), (96, 1000, 128, 16, 64), (33, 77, 24, 8, 16)])
def test_k6_plain_matches_pallas(jx, n, e, f, tn, te):
    """K6's plain version, which CPU tensors take, equals
    ``_tiled_segment_max_fwd`` in interpret mode exactly, −inf on the rows
    that receive no edge included."""
    r, m, csr, _ = _k6_case(n, e, f)
    tcsr = jx.sk.build_tiled_csr(np.arange(e), r, n, tn=tn, te=te)
    want = np.asarray(jx.sk._tiled_segment_max_fwd(
        tcsr, jx.jnp.asarray(m), interpret=True))[:n]
    got = segment_max(torch.from_numpy(m), csr)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.isneginf(got.numpy()).all(1),
                                  np.bincount(r, minlength=n) == 0)


def test_k6_tie_gradients_match_jax(jx):
    """Messages with ties (ReLU-like: many zeros, values on a 0.5 grid).
    The kernel path (``segment_max_aggregate``) gives every tied arg-max
    edge the full cotangent, as the JAX kernel's custom VJP does; the
    scatter path (``segment_reduce``) splits it among the ties, as
    ``jax.ops.segment_max``'s gradient does. Both equal JAX's exactly, and
    they differ from each other."""
    import jax

    jnp = jx.jnp
    n, e, f = 40, 200, 8
    r, _, csr, rng = _k6_case(n, e, f, seed=1)
    m = np.maximum(np.round(rng.normal(size=(e, f)) * 2) / 2, 0).astype(
        np.float32)
    g = rng.normal(size=(n, f)).astype(np.float32)
    tcsr = jx.sk.build_tiled_csr(np.arange(e), r, n, tn=8, te=32)
    recv = r.astype(np.int32)

    def jax_loss(reduce):
        def loss(mm):
            out = reduce(mm)[:n]
            return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * g)
        return loss

    with jx.pltpu.force_tpu_interpret_mode():
        want_k = jax.grad(jax_loss(lambda mm: jx.sk.tiled_segment_max(
            mm, tcsr, jnp.asarray(recv))))(jnp.asarray(m))
    want_x = jax.grad(jax_loss(lambda mm: jax.ops.segment_max(
        mm, jnp.asarray(recv), num_segments=n, indices_are_sorted=True)))(
        jnp.asarray(m))
    recv_t = torch.from_numpy(recv)
    # the kernel path's rule copies cotangents: exact; the split divides
    # by the tie count (g/k here, g·(1/k) in JAX): last-bit differences
    for reduce, want, rtol in (
            (lambda mm: segment_max_aggregate(mm, csr, recv_t), want_k, 0),
            (lambda mm: segment_reduce(mm, recv_t, n, "max"), want_x, 1e-6)):
        mt = torch.from_numpy(m).requires_grad_()
        out = reduce(mt)
        (torch.where(torch.isfinite(out), out, 0.0) * torch.from_numpy(g)
         ).sum().backward()
        np.testing.assert_allclose(mt.grad.numpy(), np.asarray(want),
                                   rtol=rtol, atol=0)
    assert np.abs(np.asarray(want_k) - np.asarray(want_x)).max() > 0.1


def test_k6_reference_quirks(jx):
    """Two points where the JAX kernel differs from a true segment max (a
    reference fault, ROADMAP Queue 3); the port keeps the true value, as
    the scatter path and ``jax.ops.segment_max`` do. (1) A row whose
    maximum is ``finfo(float32).min`` comes out −inf: the kernel's empty
    sentinel. (2) A NaN message reaches every row of its output tile
    through the one-hot product (``0·NaN``), not only its own row."""
    n, e, f = 33, 77, 24
    r, m, csr, _ = _k6_case(n, e, f)
    tcsr = jx.sk.build_tiled_csr(np.arange(e), r, n, tn=8, te=16)
    row = r[5]
    m_min = m.copy()
    m_min[r == row] = np.finfo(np.float32).min
    m_nan = m.copy()
    m_nan[5, 0] = np.nan
    for mm in (m_min, m_nan):
        want = np.asarray(jx.sk._tiled_segment_max_fwd(
            tcsr, jx.jnp.asarray(mm), interpret=True))[:n]
        got = segment_max(torch.from_numpy(mm), csr).numpy()
        true = segment_reduce(torch.from_numpy(mm), torch.from_numpy(r), n,
                              "max").numpy()
        np.testing.assert_array_equal(got, true)
        assert not np.array_equal(got, want)
    assert got[row, 0] != got[row, 0]  # NaN in the message's own row only
    assert np.isnan(got).sum() == 1 and np.isnan(want).sum() > 1


# ---------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,f", [(torch.float32, 64),
                                     (torch.float32, 30),
                                     (torch.bfloat16, 128)])
def test_k1_kernel_matches_plain_cuda(cuda, dtype, f):
    n, e = 3000, 40000
    s, r, w, rng = _edges(n, e, 7)
    csr = build_segment_csr(s, r, n, edge_weight=w).to(cuda)
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    x = x.to(cuda, dtype)
    launches = segment_spmm.launches
    got = segment_spmm(x, csr)
    torch.cuda.synchronize()
    assert segment_spmm.launches == launches + 1
    want = segment_spmm_plain(x, csr).to(dtype)
    bound = 1e-5 if dtype == torch.float32 else BF16
    assert _rel(got.cpu().float(), want.cpu().float()) <= bound


# K2 shapes on the card: (storage, F, W's output width). W 128 × 128 is
# staged whole; W 512 × 96 passes in k-tiles; F 300 is not a multiple of the
# 16-byte vector (plain loads); 240 and 20,930 nodes are not multiples of
# the 64-row tile
_K2_CASES = [("grid", 40, 70), ("grid", 128, 128), ("grid", 300, 96),
             ("grid", 512, 96), ("grid4", 128, 128), ("periodic", 128, 128),
             ("large", 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,f,o", _K2_CASES)
@pytest.mark.parametrize("act,has_w,dtype", [
    (False, False, torch.float32), ("tanh", True, torch.float32),
    ("relu", True, torch.float32), ("sigmoid", False, torch.float32),
    ("tanh", True, torch.bfloat16)])
def test_k2_kernel_matches_plain_cuda(cuda, act, has_w, dtype, kind, f, o):
    rng = np.random.default_rng(8)
    dm = _dia_graph(kind, rng.random, dtype).to(cuda)
    n = dm.num_nodes
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    x = x.to(cuda, dtype)
    w = torch.from_numpy(rng.normal(size=(f, o)).astype(np.float32)
                         / np.sqrt(f))
    w = w.to(cuda) if has_w else None
    b = torch.randn(1, o if has_w else f).to(cuda)
    launches = (dia_spmm_stencil.launches, dia_gcn_rhs.launches)
    if act is False:
        got = dia_spmm_stencil(x, dm)
        want = dia_rhs_plain(dm, x, None, None, None, False, dtype)
    else:
        got = dia_gcn_rhs(act, x, w, b, dm)
        wc = None if w is None else w.to(dtype)
        want = dia_rhs_plain(dm, x, wc, b, act, True, dtype)
    torch.cuda.synchronize()
    assert (dia_spmm_stencil.launches - launches[0]
            + dia_gcn_rhs.launches - launches[1]) == 1
    bound = 1e-5 if dtype == torch.float32 else BF16
    assert _rel(got.cpu().float(), want.cpu().float()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_nan_pattern_and_bits_cuda(cuda, dtype):
    """A NaN in x reaches the same outputs as in ``stencil_f32``: the rows
    with a stored value on its column, zeros at the grid's row ends
    included (0 · NaN, as in JAX), and through W the whole row of the fused
    form. Two runs give the same bits, and so does an x that is not 16-byte
    aligned (the same schedule with plain loads)."""
    rng = np.random.default_rng(23)
    dm = _dia_graph("grid", rng.random, dtype).to(cuda)
    n, f = dm.num_nodes, 128
    xs = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    # node 24 starts the grid's third row: the row ends before it (node 23,
    # 11, 35) hold stored zeros at its offset
    xs[24, 5] = float("nan")
    x = xs.to(cuda, dtype)
    w = torch.from_numpy(rng.normal(size=(f, f)).astype(np.float32)
                         / np.sqrt(f)).to(cuda)
    b = torch.randn(1, f, device=cuda)
    shifted = torch.empty(n * f + 1, device=cuda, dtype=dtype)[1:]
    x_odd = shifted.view(n, f).copy_(x)
    assert x_odd.data_ptr() % 16 != 0
    for kernel, plain in (
            (lambda xx: dia_spmm_stencil(xx, dm),
             lambda: stencil_f32(dm, x)),
            (lambda xx: dia_gcn_rhs("tanh", xx, w, b, dm),
             lambda: dia_rhs_plain(dm, x, w.to(dtype), b, "tanh", True,
                                   dtype))):
        got, again, odd = kernel(x), kernel(x), kernel(x_odd)
        want = plain()
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), want.isnan())
        assert int(got.isnan().sum()) > 0
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                    else torch.int32),
                           again.view(torch.int16 if dtype == torch.bfloat16
                                      else torch.int32))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(odd))
        bound = 1e-5 if dtype == torch.float32 else BF16
        assert _rel(torch.nan_to_num(got).cpu().float(),
                    torch.nan_to_num(want).cpu().float()) <= bound
    # the row ends' stored zeros read the NaN: out[23] is 0 · x[24]
    k_right = dm.offsets.index(1)
    assert float(dm.values[23, k_right]) == 0.0
    assert bool(dia_spmm_stencil(x, dm)[23, 5].isnan())


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,f", [(3000, 40000, 128), (3000, 40000, 30),
                                   (256, 1024, 128), (500, 3000, 3)])
def test_k6_kernel_matches_plain_cuda(cuda, n, e, f):
    """Forward (max, and min as −max(−m)) and backward equal the plain
    versions bit for bit, on messages with ties (a third rounded to a
    coarse grid, many zeros), rows that receive no edge, a NaN message and
    a row whose maximum is ``finfo(float32).min``; F = 30 and 3 take the
    scalar loads."""
    r, m, csr, rng = _k6_case(n - 1, e, f, seed=15)  # row n − 1: no edge
    csr = build_segment_csr(np.arange(e), r, n, num_cols=e).to(cuda)
    tie = rng.random(e) < 0.3
    m[tie] = np.maximum(np.round(m[tie] * 2) / 2, 0)
    m[r == r[7]] = np.finfo(np.float32).min
    m[11, f // 2] = np.nan
    mt = torch.from_numpy(m).to(cuda)
    recv = torch.from_numpy(r.astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(cuda)
    launches = segment_max.launches
    for sign in (1, -1):
        got = sign * segment_max(sign * mt, csr)
        want = sign * segment_max_plain(sign * mt, csr)
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        assert bool(torch.isinf(got[n - 1]).all())
        leaf = mt.clone().requires_grad_()
        (sign * segment_max_aggregate(sign * leaf, csr, recv)).backward(g)
        out = segment_max_plain(sign * mt, csr)
        want_g = sign * torch.where(sign * mt == out[recv.long()],
                                    sign * g[recv.long()], 0.0)
        assert torch.equal(leaf.grad, want_g)
    assert segment_max.launches == launches + 4


@pytest.mark.cuda
def test_kernels_refuse_autograd_cuda(cuda):
    """The forward-only K6 wrapper refuses a CUDA input that requires grad
    (its autograd call is ``segment_max_aggregate``); K1 and K2 are
    differentiable: their wrappers take such an input through their
    ``autograd.Function`` and launch the kernel in the backward too."""
    s, r, n = _grid()
    edges = build_segment_csr(np.arange(len(r)), r, n,
                              num_cols=len(r)).to(cuda)
    m = torch.zeros(len(r), 8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        segment_max(m, edges)
    x = torch.randn(n, 8, device=cuda, requires_grad=True)
    launches = segment_spmm.launches
    segment_spmm(x, build_segment_csr(s, r, n).to(cuda),
                 csr_rev=build_segment_csr(r, s, n).to(cuda)).sum().backward()
    assert segment_spmm.launches == launches + 2
    assert torch.isfinite(x.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,f2,o", _K2_CASES[:-1])
@pytest.mark.parametrize("f,dtype", [(64, torch.float32), (30, torch.float32),
                                     (128, torch.bfloat16)])
def test_k1_k2_backward_cuda(cuda, f, dtype, kind, f2, o):
    """K1's backward (the kernel on the transposed CSR) and K2's (the
    stencil on ``dia_rev``; the fused VJP as one launch of its own kernel on
    ``dia_norm_rev``, no stencil) against autograd through the plain
    versions: 1e-5 (bf16: 2e-2) of the largest entry for ``dx``, 1e-4 for
    ``dW`` and ``db``. K2 in f32 at each storage and width of
    ``_K2_CASES``: W^T whole in shared memory or in k-tiles, dW as a
    product on u (out past 64)."""
    s, r, w_e, rng = _edges(3000, 40000, 17)
    csr = build_segment_csr(s, r, 3000, edge_weight=w_e).to(cuda)
    csr_rev = build_segment_csr(r, s, 3000, edge_weight=w_e).to(cuda)
    x = torch.from_numpy(rng.normal(size=(3000, f)).astype(np.float32)).to(
        cuda, dtype)
    g = torch.randn(3000, f, device=cuda).to(dtype)
    bound = 1e-5 if dtype == torch.float32 else BF16
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    segment_spmm(xk, csr, csr_rev=csr_rev).backward(g)
    segment_spmm_plain(xp, csr).to(dtype).backward(g)
    assert _rel(xk.grad.cpu().float(), xp.grad.cpu().float()) <= bound
    dm = _dia_graph(kind, rng.random)
    dm, dm_rev = dm.to(cuda), transpose_dia(dm).to(cuda)
    gn = dm.num_nodes
    x = torch.from_numpy(rng.normal(size=(gn, f2)).astype(np.float32)).to(
        cuda)
    w = torch.from_numpy(rng.normal(size=(f2, o)).astype(np.float32)
                         / np.sqrt(f2)).to(cuda)
    b = torch.randn(1, o, device=cuda)
    g = torch.randn(gn, o, device=cuda)
    leaves_k = [t.clone().requires_grad_() for t in (x, w, b)]
    leaves_p = [t.clone().requires_grad_() for t in (x, w, b)]
    fused0 = dia_gcn_rhs.launches
    stencil0 = dia_spmm_stencil.backward_launches
    dia_gcn_rhs("tanh", *leaves_k, dm, dm_rev).backward(g)
    assert dia_gcn_rhs.launches == fused0 + 2
    assert dia_spmm_stencil.backward_launches == stencil0
    dia_rhs_plain(dm, leaves_p[0], leaves_p[1], leaves_p[2], "tanh", True,
                  torch.float32).backward(g)
    for k, p, bd in zip(leaves_k, leaves_p, (1e-5, 1e-4, 1e-4)):
        assert _rel(k.grad.cpu(), p.grad.cpu()) <= bd
    gx = torch.randn(gn, f2, device=cuda)
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    dia_spmm_stencil(xk, dm, dm_rev).backward(gx)
    dia_rhs_plain(dm, xp, None, None, None, False,
                  torch.float32).backward(gx)
    assert _rel(xk.grad.cpu(), xp.grad.cpu()) <= 1e-5


@functools.lru_cache(maxsize=2)
def _k2_bwd_storage(kind):
    """Ĉ and Ĉᵀ (``precompute``'s ``dia_norm``, ``dia_norm_rev``) on the
    host: ``grid512``, the self-looped 512² 8-neighbour grid (the
    ``grand-grid.train`` cell's), or ``large``, a 161 × 130 one (20,930
    nodes: not a multiple of the 64-row tile)."""
    shape = {"grid512": (512, 512), "large": (161, 130)}[kind]
    g = P.precompute(grid_graph_2d(*shape, diagonals=True),
                     add_self_loops=True)
    return g.cache["dia_norm"], g.cache["dia_norm_rev"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,f,o,act,has_w,x_grad", [
    ("grid512", 64, 64, "tanh", True, True),
    ("grid512", 64, 64, "tanh", True, False),
    ("grid512", 64, 64, "relu", False, True),
    ("grid512", 64, 64, "sigmoid", True, True),
    ("grid512", 64, 64, "identity", True, True),
    ("grid512", 64, 40, "tanh", True, True),
    ("grid512", 48, 64, "sigmoid", True, True),
    ("grid512", 128, 64, "tanh", True, True),
    ("large", 64, 64, "tanh", True, True),
    ("large", 64, 64, "relu", False, True)])
def test_k2_fused_backward_cuda(cuda, kind, f, o, act, has_w, x_grad):
    """K2's fused backward at the grid cell's shape class (F = out = 64,
    dW from the kernel's tiles), at F ≠ out, and past 64 (dW as a product
    on u), with W and b or in the premultiplied encoder's form (``w=None``,
    relu), against autograd through the plain version in float64: 1e-5 of
    the largest entry for dx, 1e-4 for dW and db. An x that needs no
    gradient gets none. One launch of the backward a call and no stencil
    launch; the same bits on a second call (the blocks' dW and db partials
    added in a fixed order)."""
    dm, dm_rev = (t.to(cuda) for t in _k2_bwd_storage(kind))
    n = dm.num_nodes
    o = o if has_w else f
    gen = torch.Generator(device=cuda).manual_seed(29)
    x = torch.randn(n, f, device=cuda, generator=gen)
    w = (torch.randn(f, o, device=cuda, generator=gen) / f ** 0.5
         if has_w else None)
    b = torch.randn(1, o, device=cuda, generator=gen) / 4
    g = torch.randn(n, o, device=cuda, generator=gen)
    grads = []
    for _ in range(2):
        leaves = [None if t is None else t.clone().requires_grad_(need)
                  for t, need in ((x, x_grad), (w, True), (b, True))]
        counts = (dia_gcn_rhs.backward_launches, dia_gcn_rhs.backward_eager,
                  dia_spmm_stencil.backward_launches)
        y = dia_gcn_rhs(act, *leaves, dm, dm_rev)
        y.backward(g)
        torch.cuda.synchronize()
        assert (dia_gcn_rhs.backward_launches - counts[0],
                dia_gcn_rhs.backward_eager - counts[1],
                dia_spmm_stencil.backward_launches - counts[2]) == (1, 0, 0)
        grads.append([None if t is None else t.grad for t in leaves])
    refs = [None if t is None else t.double().requires_grad_(need)
            for t, need in ((x, x_grad), (w, True), (b, True))]
    _rhs64(dm, act, *refs, y.detach()).backward(g.double())
    for got, again, ref, bound in zip(*grads, refs, (1e-5, 1e-4, 1e-4)):
        if ref is None or not ref.requires_grad:
            assert got is None and again is None
            continue
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        assert _rel(got.cpu(), ref.grad.float().cpu()) <= bound


@pytest.mark.cuda
def test_k2_fused_backward_nan_pattern_cuda(cuda):
    """A NaN in the output's cotangent reaches the same entries of dx, dW
    and db as in the plain version (``dia_gcn_bwd_plain``): the rows of u
    with a stored value on its row (zeros included) and, through Wᵀ, their
    whole rows of dx; its column of dW and its entry of db."""
    from neuralgraphpde_torch.kernels.dia_kernels import (_gcn_bwd,
                                                          dia_gcn_bwd_plain)

    dm, dm_rev = (t.to(cuda) for t in _k2_bwd_storage("large"))
    n, f = dm.num_nodes, 64
    gen = torch.Generator(device=cuda).manual_seed(37)
    x = torch.randn(n, f, device=cuda, generator=gen)
    w = torch.randn(f, f, device=cuda, generator=gen) / 8
    with torch.no_grad():
        y = dia_gcn_rhs("tanh", x, w, None, dm)
    g = torch.randn(n, f, device=cuda, generator=gen)
    g[1000, 7] = float("nan")
    got = _gcn_bwd(dm_rev, x, w, y, g, "tanh", True, True, True)
    want = dia_gcn_bwd_plain(dm_rev, x, w, y, g, "tanh")
    torch.cuda.synchronize()
    for a, c in zip(got, want):
        assert torch.equal(a.isnan(), c.isnan())
        assert int(a.isnan().sum()) > 0
        assert _rel(torch.nan_to_num(a).cpu(),
                    torch.nan_to_num(c).cpu()) <= 1e-4


@pytest.mark.cuda
def test_k2_backward_eager_counts_cuda(cuda):
    """bf16, and an output wider than ``TF_MAX``, take the unfused
    reassociated backward (``dia_gcn_bwd_plain``): one eager backward a
    call, its one stencil launch, no launch of the fused backward; finite
    gradients, and in f32 against autograd through the plain version."""
    s, r, n = _grid()
    rng = np.random.default_rng(41)
    for dtype, f, o in ((torch.bfloat16, 64, 64), (torch.float32, 64, 520)):
        dm = _dia_graph("grid", rng.random, dtype)
        dm, dm_rev = dm.to(cuda), transpose_dia(dm).to(cuda)
        x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(
            cuda, dtype)
        w = torch.from_numpy(rng.normal(size=(f, o)).astype(np.float32)
                             / np.sqrt(f)).to(cuda)
        b = torch.randn(1, o, device=cuda)
        g = torch.randn(n, o, device=cuda).to(dtype)
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        counts = (dia_gcn_rhs.backward_launches, dia_gcn_rhs.backward_eager,
                  dia_spmm_stencil.backward_launches)
        dia_gcn_rhs("tanh", *leaves, dm, dm_rev).backward(g)
        torch.cuda.synchronize()
        assert (dia_gcn_rhs.backward_launches - counts[0],
                dia_gcn_rhs.backward_eager - counts[1],
                dia_spmm_stencil.backward_launches - counts[2]) == (0, 1, 1)
        assert all(bool(torch.isfinite(t.grad).all()) for t in leaves)
        if dtype == torch.bfloat16:
            continue
        refs = [t.clone().requires_grad_() for t in (x, w, b)]
        dia_rhs_plain(dm, *refs, "tanh", True, dtype).backward(g)
        for got, ref in zip(leaves, refs):
            assert _rel(got.grad.cpu(), ref.grad.cpu()) <= 1e-4


def _k4_k7_case(cuda, kind, dtype, seed=18, isolated=False):
    """An RCM-relabeled Delaunay mesh of 3,000 points in packed (512 × 128)
    or dense (256 × 256) block bands, with its transpose, on the card. With
    ``isolated``, 300 isolated nodes sit in the middle of the numbering
    (3,300 nodes): their 64-row tiles list no sub-tile."""
    from neuralgraphpde_torch.graph.reorder import rcm_order
    from neuralgraphpde_torch.ops.bsr import (build_banded,
                                              build_packed_banded)

    rng = np.random.default_rng(seed)
    g = P.delaunay_graph(rng.random((3000, 2)).astype(np.float32))
    s, r = g.host_coo
    order = rcm_order(s, r, 3000)
    inv = np.empty(3000, np.int64)
    inv[order] = np.arange(3000)
    s, r = inv[s], inv[r]
    n = 3000
    if isolated:
        s, r, n = s + 300 * (s >= 1500), r + 300 * (r >= 1500), 3300
    w = rng.uniform(0.5, 1.5, len(s)).astype(np.float32)
    if kind == "pbanded":
        kw = dict(tb=128, tb_rows=512, edge_weight=w, dtype=dtype)
        st, st_rev = (build_packed_banded(s, r, n, **kw),
                      build_packed_banded(r, s, n, **kw))
    else:
        kw = dict(tb=256, edge_weight=w, dtype=dtype, max_bands=24)
        st, st_rev = (build_banded(s, r, n, **kw),
                      build_banded(r, s, n, **kw))
    # what the cases are for: a block-row slot holding only zeros, and (with
    # isolated nodes) a tile listing no sub-tile
    assert not (st.blocks != 0).any(-1).any(-1).all()
    assert not isolated or bool((torch.diff(st.tiles.ptr) == 0).any())
    return st.to(cuda), st_rev.to(cuda), rng


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pbanded", "banded"])
@pytest.mark.parametrize("f,dtype", [(128, torch.float32),
                                     (40, torch.float32),
                                     (300, torch.float32),
                                     (128, torch.bfloat16)])
def test_k4_k7_kernels_match_plain_cuda(cuda, kind, f, dtype):
    """The SpMM and the fused right-hand side (tanh with W and b, relu with
    W and no b, sigmoid with no W) against ``block_rhs_plain`` on the same
    inputs: 1e-5 (bf16 storage: 2e-2) of the largest value; each call
    launches once. On the mesh (block-rows with empty slots) and on the
    mesh with isolated nodes (tiles with no sub-tile)."""
    spmm = (BK.pbanded_spmm_pallas if kind == "pbanded"
            else BK.banded_spmm_pallas)
    rhs = BK.pbanded_gcn_rhs if kind == "pbanded" else BK.banded_gcn_rhs
    bound = 1e-5 if dtype == torch.float32 else BF16
    for isolated in (False, True):
        st, _, rng = _k4_k7_case(cuda, kind, dtype, isolated=isolated)
        n = st.num_nodes
        x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(
            cuda)
        w = torch.from_numpy((rng.normal(size=(f, 70)) / np.sqrt(f)).astype(
            np.float32)).to(cuda)
        b = torch.randn(1, 70, device=cuda)
        wc = w.to(dtype)
        xc = x.to(dtype)
        bf = b[:, :1].expand(1, f).contiguous()
        cases = [
            (lambda: spmm(x, st), lambda: BK.block_rhs_plain(
                st, xc, None, None, None, False), spmm),
            (lambda: rhs("tanh", x, w, b, st), lambda: BK.block_rhs_plain(
                st, xc, wc, b, "tanh", True), rhs),
            (lambda: rhs("relu", x, w, None, st), lambda: BK.block_rhs_plain(
                st, xc, wc, None, "relu", True), rhs),
            (lambda: rhs("sigmoid", x, None, bf, st),
             lambda: BK.block_rhs_plain(st, xc, None, bf, "sigmoid", True),
             rhs)]
        for kernel, plain, fn in cases:
            launches = fn.launches
            got = kernel()
            torch.cuda.synchronize()
            assert fn.launches == launches + 1
            want = plain()
            assert got.shape == want.shape
            assert _rel(got.cpu().float(), want.cpu().float()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pbanded", "banded"])
def test_k4_k7_autograd_cuda(cuda, kind):
    """The VJPs on the card (the kernel on the transpose; the fused
    right-hand side's aggregate recomputed for dW) against autograd through
    the plain version: ``dx`` within 1e-5, ``dW``/``db`` within 1e-4 of
    their largest entry; the fused call's backward launches the SpMM twice
    (counted on the SpMM wrapper), the SpMM's once. On the mesh and on the
    mesh with isolated nodes."""
    spmm = (BK.pbanded_spmm_pallas if kind == "pbanded"
            else BK.banded_spmm_pallas)
    rhs = BK.pbanded_gcn_rhs if kind == "pbanded" else BK.banded_gcn_rhs
    for isolated in (False, True):
        st, st_rev, rng = _k4_k7_case(cuda, kind, torch.float32, seed=19,
                                      isolated=isolated)
        n = st.num_nodes

        def put(*shape, scale=1.0):
            return torch.from_numpy((rng.normal(size=shape) * scale).astype(
                np.float32)).to(cuda)

        x, w, b, g = put(n, 128), put(128, 128, scale=0.1), put(1, 128), put(
            n, 128)
        leaves_k = [t.clone().requires_grad_() for t in (x, w, b)]
        leaves_p = [t.clone().requires_grad_() for t in (x, w, b)]
        fwd0, bwd0 = rhs.launches, spmm.backward_launches
        rhs("tanh", *leaves_k, st, st_rev).backward(g)
        assert rhs.launches == fwd0 + 1 and rhs.backward_launches == 0
        assert spmm.backward_launches == bwd0 + 2
        BK.block_rhs_plain(st, *leaves_p, "tanh", True).backward(g)
        for k, p, bd in zip(leaves_k, leaves_p, (1e-5, 1e-4, 1e-4)):
            assert _rel(k.grad.cpu(), p.grad.cpu()) <= bd
        xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        bwd0 = spmm.backward_launches
        spmm(xk, st, st_rev).backward(g)
        assert spmm.backward_launches == bwd0 + 1
        BK.block_rhs_plain(st, xp, None, None, None, False).backward(g)
        assert _rel(xk.grad.cpu(), xp.grad.cpu()) <= 1e-5
        if kind == "banded":  # the transpose and its index built on the card
            xt = x.clone().requires_grad_()
            spmm(xt, st, None).backward(g)
            assert _rel(xt.grad.cpu(), xp.grad.cpu()) <= 1e-5


@pytest.mark.cuda
def test_k4_k7_envelope_raises_cuda(cuda):
    """The fused kernel takes F ≤ 512: a wider input raises on the card,
    with no launch and no plain version."""
    st, _, rng = _k4_k7_case(cuda, "pbanded", torch.float32)
    x = torch.zeros(3000, 513, device=cuda)
    launches = BK.pbanded_gcn_rhs.launches
    with pytest.raises(ValueError, match="F ≤ 512"):
        BK.pbanded_gcn_rhs("tanh", x, None, None, st)
    assert BK.pbanded_gcn_rhs.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pbanded", "banded"])
def test_k4_k7_without_index_raises_cuda(cuda, kind):
    """A CUDA storage whose sub-tile index is removed raises (no launch, no
    plain version), and so do one whose index was made for other
    sub-tiles than the kernel's (32 × 32; the kernel refuses it) and one
    whose index does not fit its blocks (the wrapper refuses it)."""
    import dataclasses

    st, st_rev, rng = _k4_k7_case(cuda, kind, torch.float32)
    spmm = (BK.pbanded_spmm_pallas if kind == "pbanded"
            else BK.banded_spmm_pallas)
    rhs = BK.pbanded_gcn_rhs if kind == "pbanded" else BK.banded_gcn_rhs
    x = torch.from_numpy(rng.normal(size=(3000, 16)).astype(np.float32)).to(
        cuda)
    w = torch.ones(16, 8, device=cuda)
    counts = [(f.launches, f.backward_launches) for f in (spmm, rhs)]
    bare = dataclasses.replace(st, tiles=None)
    with pytest.raises(ValueError, match="sub-tile index"):
        spmm(x, bare)
    with pytest.raises(ValueError, match="sub-tile index"):
        rhs("tanh", x, w, None, bare)
    other = dataclasses.replace(st, tiles=dataclasses.replace(
        st.tiles, rows=2 * st.tiles.rows, ptr=st.tiles.ptr[::2].contiguous()))
    with pytest.raises(RuntimeError, match="CUDA error"):
        spmm(x, other)
    misfit = dataclasses.replace(st, tiles=dataclasses.replace(
        st.tiles, ptr=st.tiles.ptr[:-1]))
    with pytest.raises(ValueError, match="not made for blocks"):
        spmm(x, misfit)
    assert counts == [(f.launches, f.backward_launches) for f in (spmm, rhs)]
    # the backward on a transpose without its index
    y = spmm(x.clone().requires_grad_(), st,
             dataclasses.replace(st_rev, tiles=None))
    bwd = spmm.backward_launches
    with pytest.raises(ValueError, match="sub-tile index"):
        y.sum().backward()
    assert spmm.backward_launches == bwd


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pbanded", "banded"])
def test_k4_k7_nonfinite_x_stays_in_its_rows_cuda(cuda, kind):
    """A NaN row and an inf row of x reach only the output rows with a
    nonzero on their columns, as K1 and ``torch.sparse.mm`` give (the plain
    ``bmm``, the full walk and the TPU kernel spread them through stored
    zeros, 0·inf); every other row equals the plain version on x with those
    rows zeroed, within 1e-5."""
    st, _, rng = _k4_k7_case(cuda, kind, torch.float32)
    spmm = (BK.pbanded_spmm_pallas if kind == "pbanded"
            else BK.banded_spmm_pallas)
    rhs = BK.pbanded_gcn_rhs if kind == "pbanded" else BK.banded_gcn_rhs
    x = torch.from_numpy(rng.normal(size=(3000, 128)).astype(np.float32)).to(
        cuda)
    w = torch.from_numpy((rng.normal(size=(128, 64)) / 11).astype(
        np.float32)).to(cuda)
    b = torch.randn(1, 64, device=cuda)
    bad = [700, 2100]
    hit = torch.zeros(3000, 2, device=cuda)
    hit[bad, [0, 1]] = 1.0
    rows = (BK.block_rhs_plain(st, hit, None, None, None, False) != 0).any(1)
    assert 0 < int(rows.sum()) < 100
    clean = x.clone()
    clean[bad] = 0.0
    x[bad[0]] = float("nan")
    x[bad[1]] = float("inf")
    for got, want in (
            (spmm(x, st), BK.block_rhs_plain(st, clean, None, None, None,
                                             False)),
            (rhs("tanh", x, w, b, st), BK.block_rhs_plain(st, clean, w, b,
                                                          "tanh", True))):
        torch.cuda.synchronize()
        assert not torch.isfinite(got[rows]).any(1).any()
        assert torch.isfinite(got[~rows]).all()
        assert _rel(got[~rows].cpu(), want[~rows].cpu()) <= 1e-5


def _k3_case(cuda, acts, dims, seed=9):
    """A 3,000-node random graph's edge-id layout (in-degrees 0 to ~20)
    and an MLP of widths ``dims``, on the card."""
    n, e = 3000, 18000
    s, r, _, rng = _edges(n, e, seed)
    csr = build_segment_csr(np.arange(e), r, n, num_cols=e).to(cuda)
    feats = torch.from_numpy(rng.normal(size=(e, dims[0])).astype(
        np.float32)).to(cuda)
    ws = [torch.from_numpy((rng.normal(size=(a, b)) / np.sqrt(a)).astype(
        np.float32)).to(cuda) for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy((rng.normal(size=(1, b)) / 3).astype(
        np.float32)).to(cuda) for b in dims[1:]]
    g = torch.from_numpy(rng.normal(size=(n, dims[-1])).astype(
        np.float32)).to(cuda)
    return csr, feats, ws, bs, g


@pytest.mark.cuda
@pytest.mark.parametrize("acts,dims", [
    (("tanh", "tanh", "tanh"), (4, 60, 60, 60)),
    (("relu", "sigmoid", "softplus", None), (5, 33, 17, 64, 9)),
    (("elu", "gelu", "swish"), (3, 8, 128, 7))])
def test_k3_kernels_match_plain_cuda(cuda, acts, dims):
    csr, feats, ws, bs, g = _k3_case(cuda, acts, dims)
    fwd0, bwd0 = K3.fused_mlp_fwd.launches, K3.fused_mlp_bwd.launches
    got = K3.fused_mlp_fwd(acts, csr, feats, ws, bs)
    kdf, kdw, kdb = K3.fused_mlp_bwd(acts, csr, feats, ws, bs, g)
    torch.cuda.synchronize()
    assert K3.fused_mlp_fwd.launches == fwd0 + 1
    assert K3.fused_mlp_bwd.launches == bwd0 + 1
    with torch.no_grad():
        want = K3.fused_mlp_plain(acts, csr, feats, ws, bs)
    pdf, pdw, pdb = K3.fused_mlp_bwd_plain(acts, csr, feats, ws, bs, g)
    assert _rel(got.cpu(), want.cpu()) <= 1e-5
    assert _rel(kdf.cpu(), pdf.cpu()) <= 1e-5
    for k, p in zip(kdw + kdb, pdw + pdb):
        assert k.shape == p.shape
        assert _rel(k.cpu(), p.cpu()) <= 1e-4
    # the same inputs give the same bits: no atomics
    again = K3.fused_mlp_bwd(acts, csr, feats, ws, bs, g)
    for a, b in zip((kdf,) + kdw + kdb, (again[0],) + again[1] + again[2]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k3_autograd_function_cuda(cuda):
    """On the card ``fused_mlp_aggregate`` is the K3 pair under autograd;
    its gradients are those of autograd through the plain version."""
    acts, dims = ("tanh", "tanh", "tanh"), (4, 60, 60, 60)
    csr, feats, ws, bs, g = _k3_case(cuda, acts, dims, seed=10)
    leaves = [t.clone().requires_grad_() for t in (feats, *ws, *bs)]
    bwd0 = K3.fused_mlp_bwd.launches
    out = K3.fused_mlp_aggregate(acts, leaves[0], leaves[1:4], leaves[4:],
                                 csr)
    out.backward(g)
    assert K3.fused_mlp_bwd.launches == bwd0 + 1
    pdf, pdw, pdb = K3.fused_mlp_bwd_plain(acts, csr, feats, ws, bs, g)
    assert _rel(leaves[0].grad.cpu(), pdf.cpu()) <= 1e-5
    for leaf, p in zip(leaves[1:], pdw + pdb):
        assert _rel(leaf.grad.cpu(), p.cpu()) <= 1e-4


def _tiled(h, w, kt):
    """``h @ w`` by k-tiles of ``kt`` rows of ``w`` (all of them at once for
    ``kt`` None): the first tile's product stored, later ones added."""
    kt = kt or w.shape[0]
    z = None
    for k0 in range(0, w.shape[0], kt):
        part = h[:, k0:k0 + kt] @ w[k0:k0 + kt]
        z = part if z is None else z + part
    return z


def _sum_partials(parts):
    """``csrc/common.cuh``'s ``sum_partials`` order: with W = min(len,
    8) warps, warp w adds the parts w, w + W, ... in order onto 0, then the
    warps' sums are added in warp order (with at most 8 parts, the plain
    sum in part order)."""
    warps = max(1, min(len(parts), 8))
    sums = []
    for w in range(warps):
        a = torch.zeros_like(parts[0])
        for part in parts[w::warps]:
            a = a + part
        sums.append(a)
    total = torch.zeros_like(parts[0])
    for a in sums:
        total = total + a
    return total


def _stream_bwd_emulated(acts, csr, feats, ws, bs, g, sms, te, kt,
                         streamed=True):
    """The K3 backward's decomposition in torch ops, in f32: blocks of
    receiver rows by the wrapper's rule for ``sms`` SMs (for the streamed
    variant, or with ``streamed`` False the resident one), each block's edge
    slots in chunks of ``te`` (the last one ragged), the chunk's MLP
    recomputed by W k-tiles of ``kt`` rows (the first tile stored, later ones
    added; ``kt`` None: W as one tile, as the resident block holds it), its
    dW/db summed over the chunk's slots in order and added onto one partial
    per block, chunk after chunk, dh taken by W k-tiles; the blocks'
    partials summed in ``_sum_partials``' order."""
    rows, _ = K3._rows_rule(csr.num_rows, csr.col.shape[0], sms, streamed,
                            True)
    n_blocks = -(-csr.num_rows // rows)
    row_ptr = csr.row_ptr.tolist()
    plain = [K3._PLAIN_ACTS[K3._act_name(a)] for a in acts]
    dfeats = torch.zeros_like(feats)
    partials = []
    for blk in range(n_blocks):
        r0, r1 = blk * rows, min((blk + 1) * rows, csr.num_rows)
        dws = [torch.zeros_like(w) for w in ws]
        dbs = [torch.zeros(w.shape[1]) for w in ws]
        for c0 in range(row_ptr[r0], row_ptr[r1], te):
            sl = slice(c0, min(c0 + te, row_ptr[r1]))
            hs, zs = [feats[csr.col[sl].long()]], []
            for w, b, act in zip(ws, bs, plain):
                zs.append(_tiled(hs[-1], w, kt) + b.reshape(1, -1))
                hs.append(act(zs[-1]))
            dz = csr.weight[sl, None] * g[csr.rows[sl]]
            for layer in reversed(range(len(ws))):
                with torch.enable_grad():
                    z = zs[layer].detach().requires_grad_()
                    dz = torch.autograd.grad(plain[layer](z), z, dz)[0]
                dws[layer] += hs[layer].T @ dz
                dbs[layer] += dz.sum(0)
                w = ws[layer]
                step = kt or w.shape[0]
                dz = torch.cat([dz @ w[k0:k0 + step].T
                                for k0 in range(0, w.shape[0], step)], 1)
            dfeats[csr.col[sl].long()] = dz
        partials.append(dws + dbs)
    total = [_sum_partials(list(parts)) for parts in zip(*partials)]
    n = len(ws)
    return (dfeats, tuple(total[:n]),
            tuple(t.reshape(b.shape) for t, b in zip(total[n:], bs)))


@pytest.mark.parametrize("te", [4, 8, 32])
@pytest.mark.parametrize("acts,dims", [
    (("swish",), (282, 128)),
    (("gelu", None), (5, 33, 9)),
    (("tanh",) * 3, (4, 128, 128, 128)),
    (("relu", "sigmoid", "softplus", None), (7, 33, 17, 64, 5))])
def test_k3_stream_bwd_decomposition(jx, te, acts, dims):
    """The streamed backward's blocks, chunks and W k-tiles, emulated in
    torch on 40 receivers for 16 SMs (3 rows a block), with every 7th
    receiver and the whole of block 2 (rows 6 to 8) without edges: against
    ``fused_mlp_bwd_plain`` and ``_fused_mlp_bwd_pallas`` in interpret
    mode, ``dfeats`` within 1e-5 and ``dW``/``db`` within 1e-4 of their
    largest entries (sums over the edges in another order)."""
    from neuralgraphpde.kernels import fused_mlp_kernels as JK

    jnp, pltpu = jx.jnp, jx.pltpu
    n, e = 40, 170
    rng = np.random.default_rng(te + len(dims))
    r = rng.choice([i for i in range(n) if i % 7 and not 6 <= i <= 8], e)
    ew = rng.normal(size=e).astype(np.float32)
    csr = build_segment_csr(np.arange(e), r, n, num_cols=e, edge_weight=ew)
    tj = jx.sk.build_tiled_csr(np.arange(e), r, n, edge_weight=ew, tn=8,
                               te=64)
    feats = rng.normal(size=(e, dims[0])).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.normal(size=(1, b)) / 3).astype(np.float32) for b in dims[1:]]
    g = rng.normal(size=(n, dims[-1])).astype(np.float32)
    pt = [torch.from_numpy(a) for a in (feats, *ws, *bs, g)]
    pf, pw, pb, pg = pt[0], pt[1:len(ws) + 1], pt[len(ws) + 1:-1], pt[-1]
    got = _stream_bwd_emulated(acts, csr, pf, pw, pb, pg, sms=16, te=te,
                               kt=16)
    pdf, pdw, pdb = K3.fused_mlp_bwd_plain(acts, csr, pf, pw, pb, pg)
    gpad = np.zeros((tj.num_tiles * tj.tn, g.shape[1]), np.float32)
    gpad[:n] = g
    with pltpu.force_tpu_interpret_mode():
        jdf, jdw, jdb = JK._fused_mlp_bwd_pallas(
            acts, tj, jnp.asarray(feats), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, bs)), jnp.asarray(gpad), interpret=True)
    # block 2 holds no edge slot, and some block ends on a ragged chunk
    slots = np.diff(csr.row_ptr.numpy()[::3])
    assert slots[2] == 0 and (slots % te).any()
    for want in ((pdf,) + pdw + pdb, (jdf,) + jdw + jdb):
        assert _rel(got[0], np.asarray(want[0])) <= 1e-5
        for a, b in zip(got[1] + got[2], want[1:]):
            assert tuple(a.shape) == tuple(np.shape(b))
            assert _rel(a, np.asarray(b)) <= 1e-4


def _stream_fwd_emulated(acts, csr, feats, ws, bs, sms, te, kt,
                         streamed=True):
    """The K3 forward's decomposition in torch ops, in f32: blocks of
    receiver rows by the wrapper's rule for ``sms`` SMs (for the streamed
    variant, or with ``streamed`` False the resident one), each block's
    edge slots in chunks of ``te`` (the last one ragged), the chunk's MLP by
    W k-tiles of ``kt`` rows (the first tile stored, later ones added, then
    the bias and the activation; ``kt`` None: W as one tile, as the
    resident block holds it), each row's sum added slot by slot in order
    from 0 per block."""
    rows, _ = K3._rows_rule(csr.num_rows, csr.col.shape[0], sms, streamed,
                            False)
    row_ptr = csr.row_ptr.tolist()
    plain = [K3._PLAIN_ACTS[K3._act_name(a)] for a in acts]
    out = torch.zeros((csr.num_rows, ws[-1].shape[1]))
    for r0 in range(0, csr.num_rows, rows):
        r1 = min(r0 + rows, csr.num_rows)
        for c0 in range(row_ptr[r0], row_ptr[r1], te):
            c1 = min(c0 + te, row_ptr[r1])
            h = feats[csr.col[c0:c1].long()]
            for w, b, act in zip(ws, bs, plain):
                h = act(_tiled(h, w, kt) + b.reshape(1, -1))
            for s in range(c0, c1):
                row = int(csr.rows[s])
                out[row] = out[row] + csr.weight[s] * h[s - c0]
    return out


def _k3_decomposition_case(jx, dims, seed, empty_rows):
    """40 receivers, 170 edge slots, every 7th receiver and ``empty_rows``
    without edges, an MLP of widths ``dims``: the port's edge-id layout,
    JAX's tiling of the same edges, and numpy inputs."""
    n, e = 40, 170
    rng = np.random.default_rng(seed)
    r = rng.choice([i for i in range(n) if i % 7 and i not in empty_rows],
                   e)
    ew = rng.normal(size=e).astype(np.float32)
    csr = build_segment_csr(np.arange(e), r, n, num_cols=e, edge_weight=ew)
    tj = jx.sk.build_tiled_csr(np.arange(e), r, n, edge_weight=ew, tn=8,
                               te=64)
    feats = rng.normal(size=(e, dims[0])).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.normal(size=(1, b)) / 3).astype(np.float32) for b in dims[1:]]
    g = rng.normal(size=(n, dims[-1])).astype(np.float32)
    return csr, tj, feats, ws, bs, g


_K3_DECOMPOSITION_MLPS = [
    (("swish",), (282, 128)),
    (("tanh",) * 3, (4, 60, 60, 60)),
    (("gelu", None), (5, 33, 9)),
    (("relu", "sigmoid", "softplus", None), (7, 33, 17, 64, 5))]


@pytest.mark.parametrize("te", [8, 32])
@pytest.mark.parametrize("acts,dims", _K3_DECOMPOSITION_MLPS)
def test_k3_stream_fwd_decomposition(jx, te, acts, dims):
    """The streamed forward's blocks, chunks and W k-tiles, emulated in
    torch on 40 receivers for 16 SMs (3 rows a block), with every 7th
    receiver and the whole of block 2 (rows 6 to 8) without edges: against
    ``fused_mlp_plain`` and ``_fused_mlp_fwd`` in interpret mode, within
    1e-5 of the largest output (sums over the edges in another order)."""
    from neuralgraphpde.kernels import fused_mlp_kernels as JK

    jnp, pltpu = jx.jnp, jx.pltpu
    assert K3._rows_rule(40, 170, 16, True, False)[0] == 3
    csr, tj, feats, ws, bs, _ = _k3_decomposition_case(jx, dims,
                                                       te + len(dims),
                                                       range(6, 9))
    pt = [torch.from_numpy(a) for a in (feats, *ws, *bs)]
    pw, pb = pt[1:len(ws) + 1], pt[len(ws) + 1:]
    got = _stream_fwd_emulated(acts, csr, pt[0], pw, pb, sms=16, te=te,
                               kt=16)
    want = K3.fused_mlp_plain(acts, csr, pt[0], pw, pb)
    with pltpu.force_tpu_interpret_mode():
        jout = JK._fused_mlp_fwd(
            acts, tj, jnp.asarray(feats), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, bs)), interpret=True)
    # block 2 holds no edge slot, and some block ends on a ragged chunk
    slots = np.diff(csr.row_ptr.numpy()[::3])
    assert slots[2] == 0 and (slots % te).any()
    assert _rel(got, want) <= 1e-5
    assert _rel(got, np.asarray(jout)[:40]) <= 1e-5


@pytest.mark.parametrize("acts,dims", [
    (("tanh",) * 3, (4, 60, 60, 60)),
    (("tanh",) * 3, (4, 128, 128, 128)),
    (("gelu", None), (5, 33, 9)),
    (("relu", "sigmoid", "softplus", None), (7, 33, 17, 64, 5))])
def test_k3_resident_fwd_decomposition(jx, acts, dims):
    """The resident forward's blocks (the wrapper's rule for the resident
    variant: 13 rows a block at 170 slots on 40 receivers), chunks of 32
    slots and W as one tile, emulated in torch with every 7th receiver and
    the whole of block 1 (rows 13 to 25) without edges: against
    ``fused_mlp_plain`` and ``_fused_mlp_fwd`` in interpret mode, within
    1e-5 of the largest output (sums over the edges in another order)."""
    from neuralgraphpde.kernels import fused_mlp_kernels as JK

    jnp, pltpu = jx.jnp, jx.pltpu
    rows = K3._rows_rule(40, 170, 16, False, False)[0]
    assert rows == 13
    csr, tj, feats, ws, bs, _ = _k3_decomposition_case(
        jx, dims, 2 * len(dims), range(rows, 2 * rows))
    pt = [torch.from_numpy(a) for a in (feats, *ws, *bs)]
    pw, pb = pt[1:len(ws) + 1], pt[len(ws) + 1:]
    got = _stream_fwd_emulated(acts, csr, pt[0], pw, pb, sms=16, te=32,
                               kt=None, streamed=False)
    want = K3.fused_mlp_plain(acts, csr, pt[0], pw, pb)
    with pltpu.force_tpu_interpret_mode():
        jout = JK._fused_mlp_fwd(
            acts, tj, jnp.asarray(feats), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, bs)), interpret=True)
    # block 1 holds no edge slot; the others take two chunks, the last one
    # ragged
    slots = np.diff(csr.row_ptr.numpy()[::rows])
    assert slots[1] == 0 and slots.max() > 32 and (slots % 32).any()
    assert _rel(got, want) <= 1e-5
    assert _rel(got, np.asarray(jout)[:40]) <= 1e-5


@pytest.mark.parametrize("acts,dims", _K3_DECOMPOSITION_MLPS)
def test_k3_resident_bwd_decomposition(jx, acts, dims):
    """The resident backward's blocks (the wrapper's rule for the resident
    variant: 13 rows a block for 16 SMs), chunks of 32 slots and W as one
    tile, dW/db summed per block over its chunks and the blocks in order,
    emulated in torch with every 7th receiver and the whole of block 1
    (rows 13 to 25) without edges: against ``fused_mlp_bwd_plain`` and
    ``_fused_mlp_bwd_pallas`` in interpret mode, ``dfeats`` within 1e-5 and
    ``dW``/``db`` within 1e-4 of their largest entries."""
    from neuralgraphpde.kernels import fused_mlp_kernels as JK

    jnp, pltpu = jx.jnp, jx.pltpu
    rows = K3._rows_rule(40, 170, 16, False, True)[0]
    assert rows == 13
    csr, tj, feats, ws, bs, g = _k3_decomposition_case(
        jx, dims, len(dims), range(rows, 2 * rows))
    pt = [torch.from_numpy(a) for a in (feats, *ws, *bs, g)]
    pf, pw, pb, pg = pt[0], pt[1:len(ws) + 1], pt[len(ws) + 1:-1], pt[-1]
    got = _stream_bwd_emulated(acts, csr, pf, pw, pb, pg, sms=16, te=32,
                               kt=None, streamed=False)
    pdf, pdw, pdb = K3.fused_mlp_bwd_plain(acts, csr, pf, pw, pb, pg)
    gpad = np.zeros((tj.num_tiles * tj.tn, g.shape[1]), np.float32)
    gpad[:40] = g
    with pltpu.force_tpu_interpret_mode():
        jdf, jdw, jdb = JK._fused_mlp_bwd_pallas(
            acts, tj, jnp.asarray(feats), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, bs)), jnp.asarray(gpad), interpret=True)
    # block 1 holds no edge slot; the others take several chunks, the last
    # one ragged
    slots = np.diff(csr.row_ptr.numpy()[::rows])
    assert slots[1] == 0 and slots.max() > 32 and (slots % 32).any()
    for want in ((pdf,) + pdw + pdb, (jdf,) + jdw + jdb):
        assert _rel(got[0], np.asarray(want[0])) <= 1e-5
        for a, b in zip(got[1] + got[2], want[1:]):
            assert tuple(a.shape) == tuple(np.shape(b))
            assert _rel(a, np.asarray(b)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("acts,dims,n,e,variants,te,empty", [
    # the MP-PDE ϕ as the kernel gets it (the last linear layer split off)
    (("swish",), (282, 128), 256, 1024, ("streamed", "streamed"), 8, False),
    (("tanh", None), (4, 300, 300), 3000, 18000, ("streamed", "streamed"),
     32, False),
    # VMH ϕ at hidden 128: the forward still fits the resident block
    (("tanh",) * 3, (4, 128, 128, 128), 3000, 18000,
     ("resident", "streamed"), 32, False),
    (("gelu", "relu", "sigmoid", None), (7, 1024, 33, 1024, 5), 200, 900,
     ("streamed", "streamed"), None, False),
    (("tanh",) * 3, (4, 60, 60, 60), 3000, 18000, ("resident", "resident"),
     None, False),
    # the streamed backward's chunk at 4 and 16 slots, a first block
    # without edges, and many chunks a block (about 30 of 32 slots)
    (("swish",), (282, 128), 264, 264, ("streamed", "streamed"), 4, False),
    (("tanh", None), (4, 300, 300), 264, 2112, ("streamed", "streamed"),
     16, False),
    (("swish",), (282, 128), 256, 1024, ("streamed", "streamed"), 8, True),
    (("tanh",) * 3, (4, 128, 128, 128), 3000, 120000,
     ("resident", "streamed"), 32, True),
    # the resident backward: many chunks a block (about 29 chunks of 32
    # slots), a first block without edges, an MLP of widths that are not
    # multiples of 4
    (("tanh",) * 3, (4, 60, 60, 60), 3000, 120000, ("resident", "resident"),
     None, False),
    (("tanh",) * 3, (4, 60, 60, 60), 3000, 18000, ("resident", "resident"),
     None, True),
    (("gelu", None), (5, 33, 9), 3000, 18000, ("resident", "resident"),
     None, False),
    # the resident forward at hidden 128 with a first block without edges,
    # and with W rows that are not 16-byte multiples (4-byte staging)
    (("tanh",) * 3, (4, 128, 128, 128), 3000, 18000,
     ("resident", "streamed"), 32, True),
    (("sigmoid", "tanh"), (6, 30, 50), 3000, 18000, ("resident", "resident"),
     None, True)])
def test_k3_wide_variants_match_plain_cuda(cuda, acts, dims, n, e, variants,
                                           te, empty):
    """Each MLP runs the variant the launcher picks for its widths, and
    matches the plain versions at the K3 bounds; the forward and the
    backward give the same bits on a second call. ``te``: the streamed
    backward's chunk, the power of two (4 to 32) above the slots a block
    holds on average; ``empty``: the first backward block's receivers lose
    their edges."""
    assert (K3.fused_mlp_variant(dims), K3.fused_mlp_variant(
        dims, backward=True)) == variants
    s, r, _, rng = _edges(n, e, 16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows, slots = K3._rows_rule(n, e, sms, variants[1] == "streamed", True)
    if empty:
        r = r[r >= rows]
        e = len(r)
    if te is not None:
        assert te == min(32, max(4, 1 << (slots - 1).bit_length()))
    csr = build_segment_csr(np.arange(e), r, n, num_cols=e).to(cuda)

    def put(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(cuda)

    feats = put(e, dims[0])
    ws = [put(a, b, scale=1 / np.sqrt(a)) for a, b in zip(dims[:-1],
                                                          dims[1:])]
    bs = [put(1, b, scale=1 / 3) for b in dims[1:]]
    g = put(n, dims[-1])
    fwd0, bwd0 = K3.fused_mlp_fwd.launches, K3.fused_mlp_bwd.launches
    got = K3.fused_mlp_fwd(acts, csr, feats, ws, bs)
    kdf, kdw, kdb = K3.fused_mlp_bwd(acts, csr, feats, ws, bs, g)
    torch.cuda.synchronize()
    assert (K3.fused_mlp_fwd.launches, K3.fused_mlp_bwd.launches) == (
        fwd0 + 1, bwd0 + 1)
    with torch.no_grad():
        want = K3.fused_mlp_plain(acts, csr, feats, ws, bs)
    pdf, pdw, pdb = K3.fused_mlp_bwd_plain(acts, csr, feats, ws, bs, g)
    assert _rel(got.cpu(), want.cpu()) <= 1e-5
    assert _rel(kdf.cpu(), pdf.cpu()) <= 1e-5
    for k, p in zip(kdw + kdb, pdw + pdb):
        assert k.shape == p.shape
        assert _rel(k.cpu(), p.cpu()) <= 1e-4
    assert torch.equal(got, K3.fused_mlp_fwd(acts, csr, feats, ws, bs))
    again = K3.fused_mlp_bwd(acts, csr, feats, ws, bs, g)
    for a, b in zip((kdf,) + kdw + kdb, (again[0],) + again[1] + again[2]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k3_envelope_raises_cuda(cuda):
    """On the card the K3 wrappers raise outside the kernels' envelope (a
    width above 1,024, more than 4 layers) and on a dtype other than f32
    and bf16, with no launch and no hand-off to the plain version."""
    acts, dims = ("tanh",), (4, 8)
    csr, feats, ws, bs, g = _k3_case(cuda, acts, dims)
    with pytest.raises(TypeError, match="f32 or bf16"):
        K3.fused_mlp_fwd(acts, csr, feats.to(torch.float16), ws, bs)
    fwd0, bwd0 = K3.fused_mlp_fwd.launches, K3.fused_mlp_bwd.launches
    for acts, dims in [(("tanh", None), (4, 1100, 8)),
                       (("tanh",) * 5, (4, 8, 8, 8, 8, 8))]:
        csr, feats, ws, bs, g = _k3_case(cuda, acts, dims)
        with pytest.raises(ValueError, match="envelope"):
            K3.fused_mlp_fwd(acts, csr, feats, ws, bs)
        with pytest.raises(ValueError, match="envelope"):
            K3.fused_mlp_bwd(acts, csr, feats, ws, bs, g)
        with pytest.raises(ValueError, match="envelope"):
            K3.fused_mlp_variant(dims)
    assert K3.fused_mlp_fwd.launches == fwd0
    assert K3.fused_mlp_bwd.launches == bwd0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_vmhconv_outside_envelope_raises_cuda(cuda, mode):
    """``VMHConv``'s fused-ϕ gate has no width condition, as in JAX: ϕ at
    the VMH widths and at hidden 128 launch the kernel, while a 1,100-wide
    hidden layer reaches K3 and raises on the card."""
    from neuralgraphpde_torch import (MLP, VMHConv, GnnGraph, precompute,
                                      set_spmm_mode, update_graph)

    s, r, _, rng = _edges(300, 1800, 11)
    pos = rng.normal(size=(300, 2)).astype(np.float32)
    g = precompute(GnnGraph.from_coo(s, r, num_nodes=300, ndata={"x": pos}),
                   dense=False, pallas=True).to(cuda)
    x = torch.from_numpy(rng.normal(size=(300, 1)).astype(np.float32)).to(
        cuda)
    set_spmm_mode(mode)
    try:
        for hidden, fits in ((60, True), (128, True), (1100, False)):
            gen = torch.Generator().manual_seed(0)
            layer = VMHConv(MLP((4, hidden, hidden, hidden, 40), "tanh",
                                generator=gen, device=cuda),
                            MLP((41, 60, 1), "tanh", generator=gen,
                                device=cuda))
            update_graph(layer, g)
            fwd0 = K3.fused_mlp_fwd.launches
            if fits:
                assert torch.isfinite(layer(x)).all()
                assert K3.fused_mlp_fwd.launches == fwd0 + 1
            else:
                with pytest.raises(ValueError, match="envelope"):
                    layer(x)
                assert K3.fused_mlp_fwd.launches == fwd0
    finally:
        set_spmm_mode("auto")


# ------------------------------------------------------------------- K5
def _k5_case(device, k, in_chs, out_chs, bias=True, n=1024, e=19092, seed=12):
    """Random edges onto nodes 0..n−2 (node n − 1 receives none), their
    edge-id layout and senders, and K5's inputs at widths (k, in, out)."""
    s, r, _, rng = _edges(n - 1, e, seed)
    s = np.where(rng.random(e) < 0.5, s, n - 1)  # node n − 1 sends
    csr = build_segment_csr(np.arange(e), r, n, num_cols=e).to(device)
    senders = torch.from_numpy(s.astype(np.int32)).to(device)

    def put(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(device)

    ph, h = put(e, k), put(n, in_chs)
    w = put(k, in_chs * out_chs, scale=1 / np.sqrt(k))
    b = put(1, in_chs * out_chs) if bias else None
    wl, bl = K5.pack_last_layer(w, b, in_chs, out_chs)
    return csr, senders, ph, h, wl, bl, put(n, out_chs)


def test_k5_plain_matches_numpy_loop():
    """The plain forward (which CPU tensors take) against ``out[r_e] +=
    h[s_e] @ reshape(ph_e @ W + b, in×out)`` edge by edge."""
    csr, senders, ph, h, wl, bl, _ = _k5_case("cpu", 6, 3, 5, n=20, e=70)
    got = K5.fused_gno_fwd(csr, senders, ph, h, wl, bl).numpy()
    w = wl.permute(1, 0, 2).reshape(6, 15).numpy()
    flat = ph.numpy() @ w + bl.reshape(1, -1).numpy()
    want = np.zeros((20, 5), np.float32)
    s, rows = senders.numpy(), csr.rows.numpy()
    for slot, e in enumerate(csr.col.numpy()):
        want[rows[slot]] += h.numpy()[s[e]] @ flat[e].reshape(3, 5)
    np.testing.assert_allclose(got, want, **F32)
    assert not got[19].any()


def _split_ranges(inner, splits, depth=32):
    """The inner range ``[lo, hi)`` of each split, in order, as
    ``csrc/gno.cu``'s ``launch_gemm`` cuts them: ``ceil(inner / splits)``
    rounded up to a whole stage of ``depth`` (``kBK``)."""
    per = -(-inner // splits)
    kc = -(-per // depth) * depth
    return [(min(z * kc, inner), min((z + 1) * kc, inner))
            for z in range(splits)]


# csrc/gno.cu's reduce: a thread's tile of S (kRI rows i x 4 columns k) and
# the most threads a block (kRedThreads); the shared memory a block may use
# (kMaxSmem) and what leaves a second block its share of the SM
# (kHalfSmPerBlock)
_REDUCE_ROWS = 8
_REDUCE_THREADS = 384
_MAX_SMEM = 232448
_HALF_SM = 233472 // 2 - 1024


def _reduce_shape(in_chs, kp):
    """``csrc/gno.cu``'s ``reduce_shape``: the w·h chunk rows' stride (IN
    rounded up to ``_REDUCE_ROWS``), the groups of 4 columns k a pass, the
    threads a block and the passes."""
    hs = -(-in_chs // _REDUCE_ROWS) * _REDUCE_ROWS
    ig, kt = hs // _REDUCE_ROWS, kp // 4
    passes = -(-kt // max(1, _REDUCE_THREADS // ig))
    kgp = -(-kt // passes)
    return hs, kgp, -(-(ig * kgp) // 32) * 32, passes


def _edge_shape(in_chs, kp):
    """``csrc/gno.cu``'s ``edge_shape``: the per-edge backward's slice
    width ``ks`` and slices of k (the last runs to KP)."""
    inp = -(-in_chs // 4) * 4

    def smem(stride):
        return 4 * (inp * stride + 32 * (inp + stride))

    if smem(kp) <= _HALF_SM:
        return kp, 1
    for budget in (_HALF_SM, _MAX_SMEM):
        fl = budget // 4 - 32 * inp
        ks = (fl // (inp + 32) - 4) & ~3 if fl > 0 else 0
        if ks >= kp:
            return kp, 1
        if ks >= 128:
            ks &= ~127
        if ks >= 4:
            return ks, -(-(kp - 4) // ks)
    return 0, 0


def _k5_emulated(csr, senders, ph, h, wl, bl, g, sms):
    """K5 forward and backward by the CUDA kernels' decomposition, in torch
    ops in f32: ``Wl'`` packed with k padded to KP rows (``_packed``); S
    (N, IN, KP) reduced per receiver row by the reduce's tiles (pass p holds
    the groups of 4 columns k from p·kgp on, and its thread t the
    ``_REDUCE_ROWS`` × 4 tile (t // kgn, p·kgp + t % kgn) over (IN rounded
    up, KP), kgn the pass's groups; it adds the row's chunks of 32 edge
    slots in order into its registers and stores the rows below IN once:
    every S entry is stored by exactly one thread); the products split along
    their inner dimension for ``sms`` SMs (``_splits``, ``_split_ranges``),
    the partials summed in ``_sum_partials``' order; the per-edge backward
    slice by slice of k (``_edge_shape``), dph and the per-edge dh_e of each
    chunk by warp tasks of TR edges (TR the smallest that leaves none of 8
    warps a second task, at most 8), dph's columns within the slice, dh_e's
    sum going on across the slices, w[s] times each sum; dh_e onto the
    senders with ``index_add_``. Returns ``(out, (dph, dh, dwl, dbl), (forward splits,
    dWl' splits, reduce passes, per-edge backward slices))``."""
    in_chs, k, out_chs = wl.shape
    wlb = K5._packed(wl, bl)
    kp = wlb.shape[1]
    n, j = csr.num_rows, in_chs * kp
    row_ptr, col = csr.row_ptr.tolist(), csr.col.long()
    snd = senders.long()
    php = torch.zeros(ph.shape[0], kp)  # ph' = [ph, 1], zero-padded
    php[:, :k] = ph
    if bl is not None:
        php[:, k] = 1.0

    def chunks(r):
        return [(c0, min(c0 + 32, row_ptr[r + 1]))
                for c0 in range(row_ptr[r], row_ptr[r + 1], 32)]

    hs, kgp, threads, passes = _reduce_shape(in_chs, kp)
    assert threads % 32 == 0 and threads <= _REDUCE_THREADS
    hwp = torch.zeros(ph.shape[0], hs)  # chunk rows of w·h, hs wide
    hwp[:, :in_chs] = h[snd]
    s_red = torch.full((n, in_chs, kp), float("nan"))
    stores = torch.zeros(in_chs, kp, dtype=torch.int64)
    for pass_ in range(passes):
        kgn = min(kgp, kp // 4 - pass_ * kgp)
        acc = {}  # tile -> (rows, RI, 4) registers, held across chunks
        for t in range(threads):
            if t < hs // _REDUCE_ROWS * kgn:
                i0, k0 = divmod(t, kgn)
                acc[(i0 * _REDUCE_ROWS, (pass_ * kgp + k0) * 4)] = \
                    torch.zeros(n, _REDUCE_ROWS, 4)
        for r in range(n):
            for c0, c1 in chunks(r):
                e = col[c0:c1]
                part = (csr.weight[c0:c1, None] * hwp[e]).T @ php[e]
                for (i0, k0), a in acc.items():
                    a[r] += part[i0:i0 + _REDUCE_ROWS, k0:k0 + 4]
        for (i0, k0), a in acc.items():
            rows = min(_REDUCE_ROWS, in_chs - i0)
            if rows > 0:
                s_red[:, i0:i0 + rows, k0:k0 + 4] = a[:, :rows]
                stores[i0:i0 + rows, k0:k0 + 4] += 1
    assert bool((stores == 1).all())  # each entry stored once

    def product(a, b):
        splits = K5._splits(a.shape[0], b.shape[1], a.shape[1], sms)
        parts = [a[:, lo:hi] @ b[lo:hi]
                 for lo, hi in _split_ranges(a.shape[1], splits)]
        return _sum_partials(parts), splits

    w2 = wlb.reshape(j, out_chs)
    out, fwd_splits = product(s_red.reshape(n, j), w2)
    ds = (g @ w2.T).reshape(n, in_chs, kp)  # one split: inner OUT
    dwlb, bwd_splits = product(s_red.reshape(n, j).T, g)
    dph = torch.zeros_like(ph)
    dh_e = torch.zeros(ph.shape[0], in_chs)
    ks, slices = _edge_shape(in_chs, kp)
    for slice_ in range(slices):
        lo = slice_ * ks
        hi = lo + ks if slice_ + 1 < slices else kp
        kd = max(0, min(hi, k) - lo)  # the slice's columns of dph
        groups = -(-kd // 128) + -(-in_chs // 64)
        last = slice_ + 1 == slices
        for r in range(n):
            for c0, c1 in chunks(r):
                ne = c1 - c0
                tr = next((t for t in range(1, 9)
                           if -(-ne // t) * groups <= 8), 8)
                for e0 in range(c0, c1, tr):
                    sl = slice(e0, min(e0 + tr, c1))
                    e, w = col[sl], csr.weight[sl, None]
                    dph[e, lo:lo + kd] = w * (h[snd[e]]
                                              @ ds[r, :, lo:lo + kd])
                    # the running sum, unscaled until the last slice
                    dh_e[e] += php[e, lo:hi] @ ds[r, :, lo:hi].T
                    if last:
                        dh_e[e] *= w
    dh = torch.zeros_like(h).index_add_(0, snd, dh_e)
    dwlb = dwlb.reshape(in_chs, kp, out_chs)
    return out, (dph, dh, dwlb[:, :k],
                 None if bl is None else dwlb[:, k:k + 1]), (
        fwd_splits, bwd_splits, passes, slices)


@pytest.mark.parametrize("k,in_chs,out_chs,bias,n,e,splits", [
    # S.Wl' over 8 · 64 = 512 inner columns (K + 0 padded from 61 to 64)
    (61, 8, 5, False, 40, 300, (2, 1, 1, 1)),
    # S^T.g over 520 receivers, the last split ragged; KB 14 padded to 16
    (13, 6, 5, True, 520, 1200, (1, 3, 1, 1)),
    # the reduce's 8 × 64 tiles of (IN 64, KP 256) in two passes of 32
    # column groups
    (255, 64, 5, True, 40, 300, (32, 1, 2, 1)),
    # IN 512: the reduce in three passes of 24, 24 and 16 columns k; the
    # per-edge backward in four slices of 16 columns (dS[n] is 128 KB)
    (61, 512, 5, False, 40, 300, (32, 1, 3, 4))])
def test_k5_decomposition(jx, k, in_chs, out_chs, bias, n, e, splits):
    """K5's forward and backward as the CUDA kernels decompose them
    (``_k5_emulated``, 16 SMs; ``splits``: the products' splits, the
    reduce's passes and the per-edge backward's slices of k): the reduce's
    tiles and passes, the per-edge backward's slices, the products at their
    split-K boundaries with the partials summed in ``_sum_partials``' order,
    and the per-edge backward's chunks and warp tasks, with every 7th
    receiver and node n − 1 without in-edges and receivers 3, 5 and 6
    holding 70, 32 and 33 edges (chunks of 32, 32 and 6; one full chunk; 32
    and 1): against
    ``fused_gno_plain`` / ``fused_gno_bwd_plain`` and ``_fused_gno_fwd`` /
    ``_fused_gno_bwd_pallas`` in interpret mode, the forward, dph and dh
    within 1e-5 and dWl, dbl within 1e-4 of their largest entries."""
    from neuralgraphpde.kernels import gno_kernels as JK

    jnp = jx.jnp
    rng = np.random.default_rng(k + n)
    held = {3: 70, 5: 32, 6: 33}  # receiver: in-edges
    live = [i for i in range(n - 1) if i % 7 and i not in held]
    r = np.concatenate([rng.choice(live, e - sum(held.values()))]
                       + [np.full(d, i) for i, d in held.items()])
    s = rng.integers(0, n, e).astype(np.int32)
    ew = rng.normal(size=e).astype(np.float32)
    csr = build_segment_csr(np.arange(e), r, n, num_cols=e, edge_weight=ew)
    tj = jx.sk.build_tiled_csr(np.arange(e), r, n, edge_weight=ew, tn=8,
                               te=16)
    ph = rng.normal(size=(e, k)).astype(np.float32)
    h = rng.normal(size=(n, in_chs)).astype(np.float32)
    wl = (rng.normal(size=(in_chs, k, out_chs)) / np.sqrt(k)).astype(
        np.float32)
    bl = (rng.normal(size=(in_chs, 1, out_chs)).astype(np.float32)
          if bias else None)
    g = rng.normal(size=(n, out_chs)).astype(np.float32)
    t = [None if a is None else torch.from_numpy(a)
         for a in (s, ph, h, wl, bl, g)]
    out, grads, geometry = _k5_emulated(csr, *t, sms=16)
    assert geometry == splits
    assert np.bincount(r, minlength=n)[[3, 5, 6]].tolist() == [70, 32, 33]
    want = K5.fused_gno_plain(csr, *t[:5])
    plain = K5.fused_gno_bwd_plain(csr, *t)
    jargs = (tj, jnp.asarray(s), jnp.asarray(ph), jnp.asarray(h),
             jnp.asarray(wl), None if bl is None else jnp.asarray(bl))
    jout = JK._fused_gno_fwd(*jargs, interpret=True)
    gpad = np.zeros((tj.num_tiles * tj.tn, out_chs), np.float32)
    gpad[:n] = g
    jgrads = JK._fused_gno_bwd_pallas(*jargs, jnp.asarray(gpad),
                                      interpret=True)
    assert not out[n - 1].any()
    for ref in (want, np.asarray(jout)[:n]):
        assert _rel(out, np.asarray(ref)) <= 1e-5
    for ref in (plain, jgrads):
        assert (ref[3] is None) == (not bias)
        for a, b, bound in zip(grads, ref, (1e-5, 1e-5, 1e-4, 1e-4)):
            if b is None:
                continue
            assert tuple(a.shape) == tuple(np.shape(b))
            assert _rel(a, np.asarray(b)) <= bound


# K5 on the card beyond the Darcy widths: rows of ~90 edges (3 chunks, the
# reduce's second buffer refilled), a width whose reduce takes two passes
# (IN 64, KP 256: 512 tiles), one whose two chunk buffers exceed the card's
# shared memory (IN 4, KP 1,004: one buffer), the graph kernel network's
# (K 1,024, IN = OUT = 64: six reduce passes, four per-edge backward slices
# of 256 columns k, the last 260; the f32 test also takes it without the
# bias) and IN 1,000
# (the reduce's 125 tile rows in six passes, the per-edge backward in four
# slices of 20 columns at one block an SM)
K5_WIDE = [(128, 64, 64, True, 100, 9000), (255, 64, 16, True, 200, 4000),
           (1000, 4, 8, True, 100, 3000), (1024, 64, 64, True, 300, 30000),
           (64, 1000, 8, True, 100, 2000)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,in_chs,out_chs,bias,n,e", [
    (128, 64, 64, True, 1024, 19092), (128, 64, 64, False, 1024, 19092),
    (128, 64, 64, True, 300, 15000),
    (7, 5, 9, True, 300, 2000), (40, 33, 17, False, 100, 5000),
    (1024, 64, 64, False, 200, 12000)] + K5_WIDE)
def test_k5_kernels_match_plain_cuda(cuda, k, in_chs, out_chs, bias, n, e):
    """Forward and backward against the plain versions, at the GNO Darcy
    widths, at widths that are not multiples of 4 and at ``K5_WIDE``; the
    third and the fifth case's rows have ~50 edges (several 32-edge chunks
    each); the same inputs give the same bits."""
    csr, senders, ph, h, wl, bl, g = _k5_case(cuda, k, in_chs, out_chs,
                                              bias, n, e)
    fwd0, bwd0 = K5.fused_gno_fwd.launches, K5.fused_gno_bwd.launches
    got = K5.fused_gno_fwd(csr, senders, ph, h, wl, bl)
    kern = K5.fused_gno_bwd(csr, senders, ph, h, wl, bl, g)
    torch.cuda.synchronize()
    assert K5.fused_gno_fwd.launches == fwd0 + 1
    assert K5.fused_gno_bwd.launches == bwd0 + 1
    with torch.no_grad():
        want = K5.fused_gno_plain(csr, senders, ph, h, wl, bl)
    plain = K5.fused_gno_bwd_plain(csr, senders, ph, h, wl, bl, g)
    assert _rel(got.cpu(), want.cpu()) <= 1e-5
    assert not got[n - 1].any()
    assert (kern[3] is None) == (not bias)
    for a, p, bound in zip(kern, plain, (1e-5, 1e-5, 1e-4, 1e-4)):
        if p is None:
            continue
        assert a.shape == p.shape
        assert _rel(a.cpu(), p.cpu()) <= bound
    # the same inputs give the same bits (dh adds its per-edge rows with
    # index_add_, whose atomics may not)
    again = K5.fused_gno_bwd(csr, senders, ph, h, wl, bl, g)
    assert torch.equal(K5.fused_gno_fwd(csr, senders, ph, h, wl, bl), got)
    for a, b in zip(kern[:1] + kern[2:], again[:1] + again[2:]):
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_k5_autograd_function_cuda(cuda):
    """On the card ``fused_gno_aggregate`` is the K5 pair under autograd;
    its gradients reach the Dense weight and bias through
    ``pack_last_layer``'s views and equal autograd through the plain
    version."""
    csr, senders, ph, h, wl, bl, g = _k5_case(cuda, 128, 64, 64, seed=13)
    w = wl.permute(1, 0, 2).reshape(128, 64 * 64).clone().requires_grad_()
    b = bl.reshape(1, -1).clone().requires_grad_()
    leaves = [ph.clone().requires_grad_(), h.clone().requires_grad_()]
    bwd0 = K5.fused_gno_bwd.launches
    out = K5.fused_gno_aggregate(*leaves, *K5.pack_last_layer(w, b, 64, 64),
                                 csr, senders)
    out.backward(g)
    assert K5.fused_gno_bwd.launches == bwd0 + 1
    dph, dh, dwl, dbl = K5.fused_gno_bwd_plain(csr, senders, ph, h, wl, bl,
                                               g)
    assert _rel(leaves[0].grad.cpu(), dph.cpu()) <= 1e-5
    assert _rel(leaves[1].grad.cpu(), dh.cpu()) <= 1e-5
    assert _rel(w.grad.cpu(),
                dwl.permute(1, 0, 2).reshape(128, -1).cpu()) <= 1e-4
    assert _rel(b.grad.cpu(), dbl.reshape(1, -1).cpu()) <= 1e-4


@pytest.mark.cuda
def test_k5_envelope_raises_cuda(cuda):
    """On the card the K5 wrappers raise outside the kernels' envelope
    (here IN = 1,448: the per-edge backward's block at a slice of 4 columns
    k would need ~232 KB of shared memory) and on a dtype other than f32
    and bf16, with no launch and no plain version."""
    csr, senders, ph, h, wl, bl, g = _k5_case(cuda, 16, 8, 8, n=200, e=900)
    with pytest.raises(TypeError, match="f32 or bf16"):
        K5.fused_gno_fwd(csr, senders, ph.to(torch.float16), h, wl, bl)
    fwd0, bwd0 = K5.fused_gno_fwd.launches, K5.fused_gno_bwd.launches
    assert K5.gno_plan(16, 1448, 8, True) is None
    assert K5.gno_plan(16, 1444, 8, True) is not None
    csr, senders, ph, h, wl, bl, g = _k5_case(cuda, 16, 1448, 8, n=200,
                                              e=900)
    with pytest.raises(ValueError, match="envelope"):
        K5.fused_gno_fwd(csr, senders, ph, h, wl, bl)
    with pytest.raises(ValueError, match="envelope"):
        K5.fused_gno_bwd(csr, senders, ph, h, wl, bl, g)
    assert K5.fused_gno_fwd.launches == fwd0
    assert K5.fused_gno_bwd.launches == bwd0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_gnoconv_outside_envelope_raises_cuda(cuda, mode):
    """``GNOConv``'s fused gate has no width condition, as in JAX: ϕ with a
    4,100-wide last hidden layer (past K5's 4,096) reaches K5 and raises on
    the card, while ϕ at kernel width 16 launches the kernel."""
    from neuralgraphpde_torch import (MLP, GNOConv, GnnGraph, precompute,
                                      set_spmm_mode, update_graph)

    s, r, _, rng = _edges(300, 1800, 14)
    nd = {"a": rng.normal(size=(300, 1)).astype(np.float32),
          "x": rng.normal(size=(300, 2)).astype(np.float32)}
    g = precompute(GnnGraph.from_coo(s, r, num_nodes=300, ndata=nd),
                   dense=False, pallas=True).to(cuda)
    x = torch.from_numpy(rng.normal(size=(300, 8)).astype(np.float32)).to(
        cuda)
    set_spmm_mode(mode)
    try:
        for ker, fits in ((16, True), (4100, False)):
            gen = torch.Generator().manual_seed(0)
            layer = GNOConv(8, 8, MLP((6, ker, 64), "relu", generator=gen,
                                      device=cuda),
                            generator=gen, device=cuda)
            update_graph(layer, g)
            fwd0 = K5.fused_gno_fwd.launches
            if fits:
                assert torch.isfinite(layer(x)).all()
                assert K5.fused_gno_fwd.launches == fwd0 + 1
            else:
                with pytest.raises(ValueError, match="envelope"):
                    layer(x)
                assert K5.fused_gno_fwd.launches == fwd0
    finally:
        set_spmm_mode("auto")


# ------------------------------------------------ the bf16 forms (K3, K5, K6)
# Plain versions against the JAX kernels in interpret mode on the CPU, and
# the CUDA kernels against the plain versions on the card. bf16 operands are
# read as f32 and everything accumulates in f32: the results differ only
# where they are rounded to bf16 (and by the sums' order), so each is held
# to 1e-2 of its own largest entry. K6 takes a maximum, which rounds
# nothing: exact equality.
def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _dtype_pair(jnp, bf16):
    """(torch dtype, jnp dtype): bf16 or f32."""
    return ((torch.bfloat16, jnp.bfloat16) if bf16
            else (torch.float32, jnp.float32))


@pytest.mark.parametrize("n,e,f,tn,te", [
    (50, 300, 16, 8, 32), (96, 1000, 128, 16, 64), (33, 77, 24, 8, 16)])
def test_k6_bf16_matches_pallas(jx, n, e, f, tn, te):
    """bf16 messages: JAX's ``_tiled_segment_max_fwd`` gives a bf16 result;
    the port's ``segment_max`` gives the same bits in bf16 (a max of bf16
    values is one of them), −inf on the empty rows, and the gradient of its
    autograd call equals JAX's custom VJP's in bf16 (ties, which bf16
    rounding makes common, each get the full cotangent)."""
    import jax

    jnp = jx.jnp
    r, m, csr, rng = _k6_case(n, e, f, seed=2)
    m16 = jnp.asarray(m).astype(jnp.bfloat16)
    tcsr = jx.sk.build_tiled_csr(np.arange(e), r, n, tn=tn, te=te)
    want = jx.sk._tiled_segment_max_fwd(tcsr, m16, interpret=True)
    got = segment_max(_bf(m), csr)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32)[:n])
    g = rng.normal(size=(n, f)).astype(np.float32)
    recv = r.astype(np.int32)

    def jax_loss(mm):
        out = jx.sk.tiled_segment_max(mm, tcsr, jnp.asarray(recv))[:n]
        out = jnp.where(jnp.isfinite(out), out, 0.0).astype(jnp.float32)
        return jnp.sum(out * g)

    with jx.pltpu.force_tpu_interpret_mode():
        want_g = jax.grad(jax_loss)(m16)
    leaf = _bf(m).requires_grad_()
    out = segment_max_aggregate(leaf, csr, torch.from_numpy(recv))
    (torch.where(torch.isfinite(out), out, 0.0).float()
     * torch.from_numpy(g)).sum().backward()
    assert leaf.grad.dtype == torch.bfloat16 and want_g.dtype == jnp.bfloat16
    np.testing.assert_array_equal(leaf.grad.float().numpy(),
                                  np.asarray(want_g, np.float32))


@pytest.mark.parametrize("feats_bf16", [True, False])
@pytest.mark.parametrize("acts", [("tanh", "tanh", None), ("swish",)])
def test_k3_bf16_plain_matches_pallas(jx, feats_bf16, acts):
    """bf16 weights and biases, with bf16 features (every operand bf16) or
    f32 features (what the precision policy gives where the edge features
    concatenate f32 graph data): forward and VJP against
    ``_fused_mlp_fwd`` / ``_fused_mlp_bwd_pallas`` in interpret mode; the
    output and ``dfeats`` in the features' dtype, ``dW``/``db`` in the
    weights'."""
    import neuralgraphpde as J
    from neuralgraphpde.kernels import fused_mlp_kernels as JK

    jnp, pltpu = jx.jnp, jx.pltpu

    rng = np.random.default_rng(4)
    n, e = 50, 300
    gj = J.precompute(J.rand_graph(n, e, seed=7), dense=False, pallas=True,
                      tn=8, te=64)
    gp = P.precompute(P.rand_graph(n, e, seed=7), dense=False, pallas=True)
    tj, tp = gj.cache["tcsr_edges"], gp.cache["tcsr_edges"]
    dims = (4, 16, 16, 8)[:len(acts) + 1]
    feats = rng.normal(size=(e, 4)).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.normal(size=(1, b)) / 3).astype(np.float32) for b in dims[1:]]
    g = rng.normal(size=(n, dims[-1])).astype(np.float32)
    dt, jdt = _dtype_pair(jnp, feats_bf16)
    jw = tuple(jnp.asarray(w).astype(jnp.bfloat16) for w in ws)
    jb = tuple(jnp.asarray(b).astype(jnp.bfloat16) for b in bs)
    jf = jnp.asarray(feats).astype(jdt)
    gpad = np.zeros((tj.num_tiles * tj.tn, g.shape[1]), np.float32)
    gpad[:n] = g
    with pltpu.force_tpu_interpret_mode():
        want = JK._fused_mlp_fwd(acts, tj, jf, jw, jb, interpret=True)
        wdf, wdw, wdb = JK._fused_mlp_bwd_pallas(
            acts, tj, jf, jw, jb, jnp.asarray(gpad).astype(jdt),
            interpret=True)
    pf = torch.from_numpy(feats).to(dt)
    pw, pb = [_bf(w) for w in ws], [_bf(b) for b in bs]
    got = K3.fused_mlp_fwd(acts, tp, pf, pw, pb)
    assert got.dtype == dt and want.dtype == jdt
    assert _rel(got.float(), np.asarray(want, np.float32)[:n]) <= 1e-2
    gdf, gdw, gdb = K3.fused_mlp_bwd(acts, tp, pf, pw, pb,
                                     torch.from_numpy(g).to(dt))
    assert gdf.dtype == dt and wdf.dtype == jdt
    for a, b in zip((gdf,) + gdw + gdb, (wdf,) + wdw + wdb):
        assert tuple(a.shape) == tuple(b.shape)
        assert a.dtype == (dt if a is gdf else torch.bfloat16)
        assert _rel(a.float(), np.asarray(b, np.float32)) <= 1e-2


@pytest.mark.parametrize("ph_bf16,h_bf16", [(True, True), (False, True),
                                            (False, False)])
def test_k5_bf16_plain_matches_pallas(jx, ph_bf16, h_bf16):
    """bf16 weight and bias with ``ph``/``h`` in bf16 or f32 (the policy
    gives f32 ``ph`` where the edge features come from f32 graph data):
    forward and ``jax.grad`` of ``fused_gno_aggregate`` in interpret mode;
    each result in its input's dtype."""
    import jax

    from neuralgraphpde.kernels import gno_kernels as JK

    jnp, pltpu = jx.jnp, jx.pltpu

    csr, senders, ph, h, wl, bl, g = _k5_case("cpu", 8, 3, 5, n=24, e=90,
                                              seed=17)
    r = np.empty(90, np.int64)  # each edge's receiver
    r[csr.col.numpy()] = csr.rows.numpy()
    tj = jx.sk.build_tiled_csr(np.arange(90), r, 24, tn=8, te=16)
    pdt, jpdt = _dtype_pair(jnp, ph_bf16)
    hdt, jhdt = _dtype_pair(jnp, h_bf16)
    jph = jnp.asarray(ph.numpy()).astype(jpdt)
    jh = jnp.asarray(h.numpy()).astype(jhdt)
    jwl = jnp.asarray(wl.numpy()).astype(jnp.bfloat16)
    jbl = jnp.asarray(bl.numpy()).astype(jnp.bfloat16)
    js = jnp.asarray(senders.numpy())
    want = JK._fused_gno_fwd(tj, js, jph, jh, jwl, jbl, interpret=True)
    gj = jnp.asarray(g.numpy()).astype(jpdt)

    def loss(*a):
        out = JK.fused_gno_aggregate(*a, tj, js)[:24]
        return jnp.sum(out.astype(jnp.float32) * gj.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        wgrads = jax.grad(loss, argnums=(0, 1, 2, 3))(jph, jh, jwl, jbl)
    args = (ph.to(pdt), h.to(hdt), wl.to(torch.bfloat16),
            bl.to(torch.bfloat16))
    got = K5.fused_gno_fwd(csr, senders, *args)
    assert got.dtype == pdt and want.dtype == jpdt
    assert _rel(got.float(), np.asarray(want, np.float32)[:24]) <= 1e-2
    grads = K5.fused_gno_bwd(csr, senders, *args, g.to(pdt))
    for a, b, arg in zip(grads, wgrads, args):
        assert a.dtype == arg.dtype and tuple(a.shape) == tuple(b.shape)
        assert _rel(a.float(), np.asarray(b, np.float32)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("feats_bf16", [True, False])
@pytest.mark.parametrize("acts,dims,variants", [
    (("tanh",) * 3, (4, 60, 60, 60), ("resident", "resident")),
    (("swish",), (282, 128), ("streamed", "streamed")),
    (("tanh",) * 3, (4, 128, 128, 128), ("resident", "streamed")),
    (("gelu", None), (5, 33, 9), ("resident", "resident")),
    (("sigmoid", "tanh"), (6, 30, 50), ("resident", "resident"))])
def test_k3_bf16_kernels_match_plain_cuda(cuda, feats_bf16, acts, dims,
                                          variants):
    """K3's bf16 forms in both variants (bf16 weights; bf16 or f32
    features): forward, ``dfeats``, ``dW`` and ``db`` each within 1e-2 of
    its own largest entry of the plain versions fed the same operands, in
    the JAX kernels' output dtypes, counted as bf16 launches."""
    assert (K3.fused_mlp_variant(dims),
            K3.fused_mlp_variant(dims, backward=True)) == variants
    csr, feats, ws, bs, g = _k3_case(cuda, acts, dims, seed=21)
    dt = torch.bfloat16 if feats_bf16 else torch.float32
    feats, g = feats.to(dt), g.to(dt)
    ws = [w.to(torch.bfloat16) for w in ws]
    bs = [b.to(torch.bfloat16) for b in bs]
    n16 = (K3.fused_mlp_fwd.bf16_launches, K3.fused_mlp_bwd.bf16_launches)
    got = K3.fused_mlp_fwd(acts, csr, feats, ws, bs)
    kdf, kdw, kdb = K3.fused_mlp_bwd(acts, csr, feats, ws, bs, g)
    torch.cuda.synchronize()
    assert (K3.fused_mlp_fwd.bf16_launches,
            K3.fused_mlp_bwd.bf16_launches) == (n16[0] + 1, n16[1] + 1)
    with torch.no_grad():
        want = K3.fused_mlp_plain(acts, csr, feats, ws, bs)
    pdf, pdw, pdb = K3.fused_mlp_bwd_plain(acts, csr, feats, ws, bs, g)
    assert got.dtype == kdf.dtype == dt
    assert _rel(got.cpu().float(), want.cpu().float()) <= BF16 / 2
    for k, p in zip((kdf,) + kdw + kdb, (pdf,) + pdw + pdb):
        assert k.shape == p.shape and k.dtype == p.dtype
        assert _rel(k.cpu().float(), p.cpu().float()) <= BF16 / 2


@pytest.mark.cuda
@pytest.mark.parametrize("k,in_chs,out_chs,bias,n,e",
                         [(128, 64, 64, True, 1024, 19092)] + K5_WIDE)
@pytest.mark.parametrize("ph_bf16,h_bf16", [(True, True), (False, True),
                                            (False, False)])
def test_k5_bf16_kernels_match_plain_cuda(cuda, ph_bf16, h_bf16, k, in_chs,
                                          out_chs, bias, n, e):
    """K5's bf16 forms (bf16 ``Wl``/``bl``; ``ph`` and ``h`` in bf16 or
    f32) at the GNO Darcy widths and at ``K5_WIDE``: forward, ``dph``,
    ``dh``, ``dWl`` and ``dbl`` each within 1e-2 of its own largest entry of
    the plain versions, each in its input's dtype; the same inputs give the
    same bits."""
    csr, senders, ph, h, wl, bl, g = _k5_case(cuda, k, in_chs, out_chs,
                                              bias, n, e, seed=22)
    pdt = torch.bfloat16 if ph_bf16 else torch.float32
    args = (ph.to(pdt), h.to(torch.bfloat16 if h_bf16 else torch.float32),
            wl.to(torch.bfloat16), bl.to(torch.bfloat16))
    n16 = (K5.fused_gno_fwd.bf16_launches, K5.fused_gno_bwd.bf16_launches)
    got = K5.fused_gno_fwd(csr, senders, *args)
    kern = K5.fused_gno_bwd(csr, senders, *args, g.to(pdt))
    torch.cuda.synchronize()
    assert (K5.fused_gno_fwd.bf16_launches,
            K5.fused_gno_bwd.bf16_launches) == (n16[0] + 1, n16[1] + 1)
    with torch.no_grad():
        want = K5.fused_gno_plain(csr, senders, *args)
    plain = K5.fused_gno_bwd_plain(csr, senders, *args, g.to(pdt))
    assert got.dtype == pdt
    assert _rel(got.cpu().float(), want.cpu().float()) <= BF16 / 2
    for a, p, arg in zip(kern, plain, args):
        assert a.shape == p.shape and a.dtype == p.dtype == arg.dtype
        assert _rel(a.cpu().float(), p.cpu().float()) <= BF16 / 2
    # dh adds its per-edge rows with index_add_, whose atomics may not
    again = K5.fused_gno_bwd(csr, senders, *args, g.to(pdt))
    assert torch.equal(K5.fused_gno_fwd(csr, senders, *args), got)
    for a, b in zip(kern[:1] + kern[2:], again[:1] + again[2:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,f", [(3000, 40000, 128), (256, 1024, 128),
                                   (500, 3000, 3)])
def test_k6_bf16_kernel_matches_plain_cuda(cuda, n, e, f):
    """K6 on bf16 messages (16-byte loads of 8 at F = 128, scalar loads at
    F = 3): the forward and the backward's bits equal the plain versions',
    in bf16, with ties, empty rows and a NaN."""
    r, m, csr, rng = _k6_case(n - 1, e, f, seed=23)
    csr = build_segment_csr(np.arange(e), r, n, num_cols=e).to(cuda)
    tie = rng.random(e) < 0.3
    m[tie] = np.maximum(np.round(m[tie] * 2) / 2, 0)
    m[11, f // 2] = np.nan
    mt = _bf(m).to(cuda)
    recv = torch.from_numpy(r.astype(np.int32)).to(cuda)
    g = _bf(rng.normal(size=(n, f))).to(cuda)
    launches = segment_max.bf16_launches
    got = segment_max(mt, csr)
    want = segment_max_plain(mt, csr)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    leaf = mt.clone().requires_grad_()
    segment_max_aggregate(leaf, csr, recv).backward(g)
    want_g = torch.where(mt == want[recv.long()], g[recv.long()],
                         torch.zeros((), dtype=torch.bfloat16, device=cuda))
    assert leaf.grad.dtype == torch.bfloat16
    assert torch.equal(leaf.grad, want_g)
    assert segment_max.bf16_launches == launches + 2
