"""GNO Darcy training path: the PyTorch port against the JAX package on the
CPU.

Both packages get the same seeded numpy inputs and the same parameters (the
JAX ``setup`` tree copied with ``params_from_jax``). Tolerances:

- graphs and datasets: equal arrays (the same host code on one seed);
- ``pack_last_layer``: equal arrays (the same reshape);
- K5's plain versions against the Pallas kernels in interpret mode: forward
  max |port − JAX| ≤ 1e-5 of the largest value (f32 sums in another
  order); ``dph``, ``dh``, ``dWl``, ``dbl`` within 1e-4 of their largest
  entry (sums over every edge, and ``jax.grad`` of the kernel pair against
  autograd through the per-edge formulation);
- ``GNOConv`` and ``GNOModel`` outputs and losses: rel 1e-5 of the largest
  value; every gradient (parameters, ``h``, ``a``): 1e-4 of its largest
  entry;
- ``adam``: rtol 1e-6 (optax and ``torch.optim.Adam`` round the same
  update in another order);
- the training loop against the JAX script: the logged losses within rel
  1e-4 (five Adam steps; a first Adam step is ``lr·g/(|g| + eps)``, so
  gradients near zero move by up to a fraction of ``lr`` on either side).
"""
import functools
import importlib.util
import os
import re
import subprocess
import sys

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
from neuralgraphpde.data.pde import darcy_dataset as jax_darcy  # noqa: E402
from neuralgraphpde.graph.builders import \
    radius_graph as jax_radius_graph  # noqa: E402
from neuralgraphpde.kernels import gno_kernels as JK  # noqa: E402
from neuralgraphpde.kernels.segment_kernels import \
    build_tiled_csr  # noqa: E402
from neuralgraphpde.models import GNOModel as JGNOModel  # noqa: E402
from neuralgraphpde.nn.basic import MLP as JMLP  # noqa: E402
from neuralgraphpde.train import adam as jax_adam  # noqa: E402
import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.examples import train_gno_darcy as port_train  # noqa
from neuralgraphpde_torch.kernels import gno_kernels as PK  # noqa: E402
from neuralgraphpde_torch.kernels.segment_kernels import \
    build_segment_csr  # noqa: E402
from neuralgraphpde_torch.ops import fused as port_fused  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = 1e-5  # forward and losses: max|port − JAX| / max|JAX|
GRAD = 1e-4  # gradients: max|port − JAX| / max|JAX|


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _leaf(tree, dotted):
    return functools.reduce(lambda t, k: t[k], dotted.split("."), tree)


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


# ------------------------------------------------------------ graph, data
@pytest.mark.parametrize("kw", [{}, {"loop": True}, {"max_degree": 5}])
def test_radius_graph_matches_jax(kw):
    pts = np.random.default_rng(0).random((200, 2))
    gj, gp = jax_radius_graph(pts, 0.12, **kw), P.radius_graph(pts, 0.12,
                                                               **kw)
    assert gp.num_nodes == gj.num_nodes and gp.num_edges == gj.num_edges
    np.testing.assert_array_equal(gp.senders.numpy(), np.asarray(gj.senders))
    np.testing.assert_array_equal(gp.receivers.numpy(),
                                  np.asarray(gj.receivers))


def test_darcy_dataset_matches_jax():
    kw = dict(num_samples=3, n=6, radius=1.6 / 7, seed=2)
    dj, dp = jax_darcy(**kw), P.darcy_dataset(**kw)
    for name in ("a", "u", "positions"):
        np.testing.assert_array_equal(getattr(dp, name), getattr(dj, name))
    np.testing.assert_array_equal(dp.graph.senders.numpy(),
                                  np.asarray(dj.graph.senders))
    np.testing.assert_array_equal(dp.graph.receivers.numpy(),
                                  np.asarray(dj.graph.receivers))
    np.testing.assert_array_equal(dp.graph.ndata["x"].numpy(),
                                  np.asarray(dj.graph.ndata["x"]))


def test_darcy_precompute_matches_jax():
    """The config-4 graph (32×32 grid, radius 0.08: 1,024 nodes, 19,092
    edges) gets the same cache keys in both packages, the edge-id layout
    among them."""
    h = 1.0 / 33
    xs = np.linspace(h, 1 - h, 32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=-1)
    gj = J.precompute(jax_radius_graph(pts, 0.08), dense=False)
    gp = P.precompute(P.radius_graph(pts, 0.08), dense=False)
    assert gp.num_edges == gj.num_edges == 19092
    assert sorted(gp.cache) == sorted(gj.cache)
    assert "tcsr_edges" in gp.cache


# --------------------------------------------------------------------- K5
def _k5_problem(seed, n=24, e=90, k=8, in_chs=3, out_chs=5):
    """``tests/test_gno_kernel.py``'s problem: random edges (node n − 1
    receives none), ϕ's last layer ``(K, in·out)``, both layouts."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n - 1, e)
    ph = rng.normal(size=(e, k)).astype(np.float32)
    h = rng.normal(size=(n, in_chs)).astype(np.float32)
    w = (rng.normal(size=(k, in_chs * out_chs)) / np.sqrt(k)).astype(
        np.float32)
    b = rng.normal(size=(1, in_chs * out_chs)).astype(np.float32)
    g = rng.normal(size=(n, out_chs)).astype(np.float32)
    tj = build_tiled_csr(np.arange(e), r, n, tn=8, te=16)
    tp = build_segment_csr(np.arange(e), r, n, num_cols=e)
    return s.astype(np.int32), tj, tp, ph, h, w, b, g, n, in_chs, out_chs


def test_pack_last_layer_matches_jax():
    _, _, _, _, _, w, b, _, _, i, o = _k5_problem(0)
    wj, bj = JK.pack_last_layer(jnp.asarray(w), jnp.asarray(b), i, o)
    wp, bp = PK.pack_last_layer(_t(w), _t(b), i, o)
    np.testing.assert_array_equal(wp.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    assert PK.pack_last_layer(_t(w), None, i, o)[1] is None


@pytest.mark.parametrize("bias", [True, False])
def test_k5_plain_forward_matches_pallas(bias):
    """``_fused_gno_fwd`` (interpret mode) against the port's plain
    forward, which the CPU wrapper takes."""
    s, tj, tp, ph, h, w, b, _, n, i, o = _k5_problem(1)
    wj, bj = JK.pack_last_layer(jnp.asarray(w), jnp.asarray(b) if bias
                                else None, i, o)
    want = np.asarray(JK._fused_gno_fwd(tj, jnp.asarray(s), jnp.asarray(ph),
                                        jnp.asarray(h), wj, bj,
                                        interpret=True))[:n]
    wp, bp = PK.pack_last_layer(_t(w), _t(b) if bias else None, i, o)
    got = PK.fused_gno_fwd(tp, torch.from_numpy(s), _t(ph), _t(h), wp, bp)
    assert got.shape == (n, o)
    assert _rel(got.numpy(), want) <= FWD
    assert np.all(got.numpy()[n - 1] == 0)  # the node with no in-edges


@pytest.mark.parametrize("bias", [True, False])
def test_k5_plain_vjp_matches_pallas_grad(bias):
    """``dph``, ``dh``, ``dWl`` and ``dbl`` of the port's plain backward
    against ``jax.grad`` of ``fused_gno_aggregate`` (whose VJP is
    ``_fused_gno_bwd_pallas``) in interpret mode, for one cotangent."""
    s, tj, tp, ph, h, w, b, g, n, i, o = _k5_problem(2)
    wj, bj = JK.pack_last_layer(jnp.asarray(w), jnp.asarray(b), i, o)
    gj = jnp.asarray(g)

    def loss(ph, h, wl, bl):
        out = JK.fused_gno_aggregate(ph, h, wl, bl if bias else None, tj,
                                     jnp.asarray(s))[:n]
        return jnp.sum(out * gj)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2, 3))(
            jnp.asarray(ph), jnp.asarray(h), wj, bj)
    wp, bp = PK.pack_last_layer(_t(w), _t(b) if bias else None, i, o)
    got = PK.fused_gno_bwd(tp, torch.from_numpy(s), _t(ph), _t(h),
                           wp.contiguous(), bp, _t(g))
    assert (got[3] is None) == (not bias)
    for a, ref, name in zip(got, want, ("dph", "dh", "dwl", "dbl")):
        if a is None:
            continue
        assert tuple(a.shape) == tuple(ref.shape), name
        assert _rel(a.numpy(), ref) <= GRAD, name


def test_k5_plain_autograd_equals_plain_vjp():
    """``fused_gno_aggregate`` on the CPU is the plain forward under
    autograd; its gradients are ``fused_gno_bwd_plain``'s, and they reach
    the Dense weight through ``pack_last_layer``'s views."""
    s, _, tp, ph, h, w, b, g, n, i, o = _k5_problem(3)
    leaves = [_t(a).requires_grad_() for a in (ph, h, w, b)]
    wl, bl = PK.pack_last_layer(leaves[2], leaves[3], i, o)
    out = PK.fused_gno_aggregate(leaves[0], leaves[1], wl, bl, tp,
                                 torch.from_numpy(s))
    out.backward(_t(g))
    dph, dh, dwl, dbl = PK.fused_gno_bwd_plain(
        tp, torch.from_numpy(s), _t(ph), _t(h),
        *PK.pack_last_layer(_t(w), _t(b), i, o), _t(g))
    k = ph.shape[1]
    want_w = dwl.permute(1, 0, 2).reshape(k, i * o)
    for leaf, want in zip(leaves, (dph, dh, want_w, dbl.reshape(1, -1))):
        np.testing.assert_allclose(leaf.grad.numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_k5_wrappers_refuse():
    """A dtype other than f32 and bf16, a bias in another dtype than its
    weight, mismatched shapes and a device with no kernel raise; nothing
    falls back. (The envelope is the CUDA kernel's and raises on the card:
    ``tests/test_torch_kernels.py``.)"""
    s, _, tp, ph, h, w, b, g, n, i, o = _k5_problem(4)
    sp = torch.from_numpy(s)
    wl, bl = PK.pack_last_layer(_t(w), _t(b), i, o)
    with pytest.raises(TypeError, match="f32 or bf16"):
        PK.fused_gno_fwd(tp, sp, _t(ph).to(torch.float16), _t(h), wl, bl)
    with pytest.raises(TypeError, match="wl's dtype"):
        PK.fused_gno_fwd(tp, sp, _t(ph), _t(h), wl, bl.to(torch.bfloat16))
    with pytest.raises(ValueError, match="ph must be"):
        PK.fused_gno_fwd(tp, sp, _t(ph)[1:], _t(h), wl, bl)
    with pytest.raises(ValueError, match="wl"):
        PK.fused_gno_fwd(tp, sp, _t(ph), _t(h)[:, :2], wl, bl)
    with pytest.raises(ValueError, match="g_out"):
        PK.fused_gno_bwd(tp, sp, _t(ph), _t(h), wl, bl, _t(g)[:, :2])
    meta = [t.to("meta") for t in (_t(ph), _t(h), wl, bl)]
    with pytest.raises(RuntimeError, match="no kernel"):
        PK.fused_gno_fwd(tp, sp, *meta)


# ---------------------------------------------------------------- GNOConv
def _conv_graphs(seed, n=30, e=200):
    """Random edges onto nodes 0..n−2 (node n − 1 receives none) with
    ``ndata = {'a', 'x'}``, precomputed in both packages."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n - 1, e).astype(np.int32)
    nd = {"a": rng.normal(size=(n, 1)).astype(np.float32),
          "x": rng.normal(size=(n, 2)).astype(np.float32)}
    gj = J.precompute(J.GnnGraph.from_coo(s, r, num_nodes=n, ndata=nd),
                      dense=False, pallas=True, tn=8, te=32)
    gp = P.precompute(P.GnnGraph.from_coo(s, r, num_nodes=n, ndata=nd),
                      dense=False, pallas=True)
    return gj, gp, rng


@pytest.mark.parametrize("mode,aggr,bias", [
    ("pallas", "mean", True), ("pallas", "sum", True),
    ("pallas", "mean", False), ("xla", "mean", True), ("xla", "sum", False)])
def test_gnoconv_matches_jax(monkeypatch, mode, aggr, bias):
    """Output and gradients (parameters and input) of the port's GNOConv on
    the fused path (``pallas``: K5's plain versions on the CPU) and the
    exact path, against the JAX layer on its exact path, on a graph with a
    node that receives no edge (0 message under mean and sum)."""
    gj, gp, rng = _conv_graphs(5)
    in_chs, out_chs = 4, 6
    layer_j = J.GNOConv(in_chs, out_chs, JMLP((6, 16, 16, in_chs * out_chs),
                                              "relu"), "tanh", aggr=aggr,
                        use_bias=bias)
    layer_p = P.GNOConv(in_chs, out_chs, P.MLP((6, 16, 16, in_chs * out_chs),
                                               "relu"), "tanh", aggr=aggr,
                        use_bias=bias)
    ps, st = J.setup(jax.random.PRNGKey(6), layer_j)
    st = J.update_graph(st, gj)
    x = rng.normal(size=(30, in_chs)).astype(np.float32)

    def loss(ps, x):
        y, _ = layer_j(x, ps, st)
        return jnp.sum(y ** 2), y

    J.set_spmm_mode("xla")
    try:
        (_, want), (gps, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(x))
    finally:
        J.set_spmm_mode("auto")
    P.params_from_jax(layer_p, _np(ps))
    P.update_graph(layer_p, gp)
    fused = _spy(monkeypatch, port_fused, "fused_gno_aggregate")
    xp = _t(x).requires_grad_()
    P.set_spmm_mode(mode)
    try:
        y = layer_p(xp)
    finally:
        P.set_spmm_mode("auto")
    assert bool(fused) == (mode == "pallas")
    (y ** 2).sum().backward()
    assert _rel(y.detach().numpy(), want) <= FWD
    assert _rel(xp.grad.numpy(), gx) <= GRAD
    names = [name for name, _ in layer_p.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(gps))
    for name, p in layer_p.named_parameters():
        assert _rel(p.grad.numpy(), _leaf(gps, name)) <= GRAD, name


def test_gnoconv_nonlinear_last_layer_takes_exact_path(monkeypatch):
    """ϕ ending in an activation cannot split off its last layer: even in
    ``pallas`` mode the layer takes the exact path (JAX's gate)."""
    _, gp, rng = _conv_graphs(7)
    phi = P.MLP((6, 8, 12), "relu", final_activation="tanh")
    layer = P.GNOConv(3, 4, phi, generator=torch.Generator().manual_seed(0))
    P.update_graph(layer, gp)
    fused = _spy(monkeypatch, port_fused, "fused_gno_aggregate")
    x = _t(rng.normal(size=(30, 3)))
    P.set_spmm_mode("pallas")
    try:
        got = layer(x)
    finally:
        P.set_spmm_mode("xla")
    try:
        want = layer(x)
    finally:
        P.set_spmm_mode("auto")
    assert not fused
    np.testing.assert_array_equal(got.detach().numpy(),
                                  want.detach().numpy())


# --------------------------------------------------------------- GNOModel
def _darcy_pair(n=6, samples=3, seed=1):
    radius = 1.6 / (n + 1)
    dj = jax_darcy(num_samples=samples, n=n, radius=radius, seed=seed)
    dp = P.darcy_dataset(num_samples=samples, n=n, radius=radius, seed=seed)
    return (J.precompute(dj.graph, dense=False, pallas=True, tn=8, te=32),
            P.precompute(dp.graph, dense=False, pallas=True), dp)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_gnomodel_matches_jax(monkeypatch, mode):
    """``GNOModel(width 8, ker_width 16, depth 2)``: the loss, every
    parameter gradient and the gradient with respect to ``a``, with the JAX
    ``setup`` parameters, against the JAX model on its exact path."""
    gj, gp, data = _darcy_pair()
    model_j = JGNOModel(a_dim=1, pos_dim=2, width=8, ker_width=16, depth=2)
    ps, st = J.setup(jax.random.PRNGKey(2), model_j)
    st = J.update_graph(st, gj)
    a = data.a[0] / np.abs(data.a).max()
    u = data.u[0] / np.abs(data.u).max()

    def loss(ps, a):
        pred, _ = model_j(a, ps, st)
        return jnp.mean((pred - jnp.asarray(u)) ** 2)

    J.set_spmm_mode("xla")
    try:
        lj, (gps, ga) = jax.value_and_grad(loss, argnums=(0, 1))(
            ps, jnp.asarray(a))
    finally:
        J.set_spmm_mode("auto")
    model = P.GNOModel(a_dim=1, pos_dim=2, width=8, ker_width=16, depth=2)
    P.params_from_jax(model, _np(ps))
    P.update_graph(model, gp)
    fused = _spy(monkeypatch, port_fused, "fused_gno_aggregate")
    ap = _t(a).requires_grad_()
    P.set_spmm_mode(mode)
    try:
        lp = P.mse(model(ap), _t(u))
    finally:
        P.set_spmm_mode("auto")
    assert len(fused) == (2 if mode == "pallas" else 0)
    lp.backward()
    assert _rel(float(lp.detach()), float(lj)) <= FWD
    assert _rel(ap.grad.numpy(), ga) <= GRAD
    names = [name for name, _ in model.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(gps)) == 2 + 2 * 8 + 2
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), _leaf(gps, name)) <= GRAD, name


def test_gnomodel_leaves_no_sample_on_its_convs():
    """After a forward each conv holds its own graph again (no ``a``), and
    a second sample's output does not depend on the first's."""
    _, gp, data = _darcy_pair(seed=3)
    model = P.GNOModel(width=8, ker_width=16, depth=2,
                       generator=torch.Generator().manual_seed(0))
    P.update_graph(model, gp)
    a = torch.from_numpy(data.a)
    with torch.no_grad():
        y1 = model(a[1])
        model(a[0])
        y1_again = model(a[1])
    for name in ("conv_1", "conv_2"):
        assert getattr(model, name).graph is gp
        assert "a" not in getattr(model, name).graph.ndata
    np.testing.assert_array_equal(y1.numpy(), y1_again.numpy())


# ------------------------------------------------------------------- adam
def test_adam_matches_optax():
    """Three steps on the same gradients (optax's defaults, lr 1e-3)."""
    rng = np.random.default_rng(8)
    p0 = rng.normal(size=(3, 8)).astype(np.float32)
    grads = [rng.normal(size=(3, 8)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    opt_j = jax_adam(1e-3)
    pj = jnp.asarray(p0)
    state = opt_j.init(pj)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt_p = P.adam([p], 1e-3)
    for g in grads:
        upd, state = opt_j.update(jnp.asarray(g), state, pj)
        pj = pj + upd
        p.grad = torch.from_numpy(g.copy())
        opt_p.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj),
                                   rtol=1e-6, atol=1e-9)


# --------------------------------------------------------------- training
def _jax_train_gno():
    spec = importlib.util.spec_from_file_location(
        "jax_train_gno_darcy",
        os.path.join(REPO, "examples", "train_gno_darcy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_gno_darcy_matches_jax():
    """Five epochs of the port's ``train_gno_darcy`` (4 samples on a 6×6
    grid, width 8, kernel width 16, depth 2) log the JAX script's train and
    test MSE after epochs 1 and 5, from the JAX ``setup`` parameters."""
    kw = dict(num_samples=4, n=6, width=8, ker_width=16, depth=2, epochs=5)
    jmod = _jax_train_gno()
    want = jmod.main(jmod.Config(**kw)).history
    cfg = port_train.Config(**kw)
    model, a, u = port_train.setup(cfg, "cpu")
    model_j = JGNOModel(a_dim=1, pos_dim=2, width=8, ker_width=16, depth=2)
    ps, _ = J.setup(jax.random.PRNGKey(cfg.seed), model_j)
    P.params_from_jax(model, _np(ps))
    got = port_train.train(model, a, u, cfg).history
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 5]
    for key in ("train_mse", "test_mse"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4)


def test_train_gno_darcy_cli_loss_falls():
    """``python -m neuralgraphpde_torch.examples.train_gno_darcy --device
    cpu --samples 4 --n 8 --epochs 5`` runs, logs epochs 1 and 5, and its
    loss falls."""
    proc = subprocess.run(
        [sys.executable, "-m", "neuralgraphpde_torch.examples."
         "train_gno_darcy", "--device", "cpu", "--samples", "4", "--n", "8",
         "--epochs", "5"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = [float(v) for v in re.findall(r"train mse ([0-9.]+)",
                                           proc.stdout)]
    epochs = [int(v) for v in re.findall(r"epoch +([0-9]+) \|", proc.stdout)]
    assert epochs == [1, 5] and losses[1] < losses[0], proc.stdout


def test_train_gno_darcy_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.setup(port_train.Config(num_samples=1, n=4), "cuda")


def test_make_train_step_and_metrics_logger(tmp_path):
    """One step lowers a quadratic (with and without an aux output); the
    logger keeps the history and writes one JSON line per record."""
    w = torch.nn.Parameter(torch.tensor([2.0, -1.0]))
    step = P.make_train_step(lambda t: ((w - t) ** 2).sum(),
                             P.adam([w], 0.1))
    loss0, aux = step(torch.zeros(2))
    loss1, _ = step(torch.zeros(2))
    assert aux is None and float(loss1) < float(loss0)
    step_aux = P.make_train_step(lambda t: (((w - t) ** 2).sum(), "aux"),
                                 P.adam([w], 0.1), has_aux=True)
    loss2, aux = step_aux(torch.zeros(2))
    assert aux == "aux" and float(loss2) < float(loss1)
    logger = P.MetricsLogger(path=str(tmp_path / "log.jsonl"))
    rec = logger.log(1, loss=loss1)
    assert rec["loss"] == float(loss1) and logger.history == [rec]
    assert len((tmp_path / "log.jsonl").read_text().splitlines()) == 1
