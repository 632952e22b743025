"""GRAND forward: the PyTorch port against the JAX package on the CPU.

Both packages get the same seeded numpy inputs and the same parameters (the
JAX ``setup`` tree copied with ``params_from_jax``). The JAX side runs with
``set_spmm_mode("xla")``, its exact gather/scatter path; the port runs the
path under test. Tolerance rtol = atol = 1e-4: both sides accept the same
steps and their sums differ only in order.

At solver rtol = atol = 1e-3 the first Tsit5 step's error estimate is at
f32 rounding level (error ratio ~2e-5), so a change of summation order moves
the next step size by ~1e-3 relative and the Hermite save by up to ~2e-4:
the JAX package's own xla and Pallas paths differ the same way. The
entry-point test keeps ``entry()``'s 1e-3 (its margin is 4x); the kernel
path tests solve at 1e-5, where the controller is out of that regime.
"""
import importlib
import os
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

import neuralgraphpde as J  # noqa: E402
from neuralgraphpde.data import synthetic_cora as jax_cora  # noqa: E402
from neuralgraphpde.models import grand_model as jax_grand  # noqa: E402
import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.ops import fused as port_fused  # noqa: E402

# the module, which ``ops.spmm`` (the function) shadows as an attribute
port_spmm = importlib.import_module("neuralgraphpde_torch.ops.spmm")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_logits(model, g, x):
    ps, st = J.setup(jax.random.PRNGKey(0), model)
    st = J.update_graph(st, g)
    J.set_spmm_mode("xla")
    try:
        logits = jax.jit(lambda p, v: model(v, p, st)[0])(ps, jnp.asarray(x))
    finally:
        J.set_spmm_mode("auto")
    return np.asarray(logits), jax.tree_util.tree_map(np.asarray, ps)


def _port_logits(model, ps_np, g, x, mode):
    P.params_from_jax(model, ps_np)
    P.update_graph(model, g)
    P.set_spmm_mode(mode)
    try:
        with torch.no_grad():
            return model(torch.from_numpy(x)).numpy()
    finally:
        P.set_spmm_mode("auto")


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_entry_analog_dense():
    """``__graft_entry__.entry()``: 512-node synthetic Cora, dense
    precompute, Tsit5 at rtol = atol = 1e-3."""
    kw = dict(num_nodes=512, num_edges=2048, num_features=64, num_classes=7,
              seed=0)
    dj, dp = jax_cora(**kw), P.synthetic_cora(**kw)
    gj = J.precompute(J.add_self_loops(dj.graph), dense=True, csr=True)
    gp = P.precompute(P.add_self_loops(dp.graph), dense=True, csr=True)
    assert sorted(gp.cache) == sorted(gj.cache)
    want, ps = _jax_logits(
        jax_grand(64, 64, 7, rtol=1e-3, atol=1e-3,
                  precomputed_self_loops=True), gj, dj.features)
    model = P.grand_model(64, 64, 7, rtol=1e-3, atol=1e-3,
                          precomputed_self_loops=True)
    got = _port_logits(model, ps, gp, dp.features, "auto")
    np.testing.assert_allclose(got, want, **TOL)
    assert model.layer_2.last_stats["accepted"] > 0


def test_segment_kernel_path(monkeypatch):
    """~600-node graph forced onto K1 (``dense=False, pallas=True``); the
    encoder is 48 → 16 wide, so it takes the out<in pre-multiply."""
    kw = dict(num_nodes=600, num_edges=2400, num_features=48, num_classes=5,
              seed=1)
    dj, dp = jax_cora(**kw), P.synthetic_cora(**kw)
    pre = dict(add_self_loops=True, dense=False, pallas=True)
    gj = J.precompute(dj.graph, **pre)
    gp = P.precompute(dp.graph, **pre)
    assert "tcsr" in gp.cache and "adj" not in gp.cache
    solve = dict(rtol=1e-5, atol=1e-5, precomputed_self_loops=True)
    want, ps = _jax_logits(jax_grand(48, 16, 5, **solve), gj, dj.features)
    calls = _spy(monkeypatch, port_spmm, "segment_spmm")
    got = _port_logits(P.grand_model(48, 16, 5, **solve), ps, gp,
                       dp.features, "pallas")
    assert calls, "K1 was not on the path"
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fused,in_dims", [(True, 12), (True, 20),
                                           (False, 12)])
def test_dia_path(monkeypatch, fused, in_dims):
    """16×12 8-neighbour grid on the DIA stencil (``dense=False, bsr=True``,
    as tests/test_dia.py builds it): with ``gcn_fused`` every GCNConv is one
    fused K2 call (20 → 12 pre-multiplies into the kernel); without, the
    plain stencil K2 runs inside the exact GCNConv path."""
    g0j = J.add_self_loops(J.grid_graph_2d(16, 12, diagonals=True))
    g0p = P.add_self_loops(P.grid_graph_2d(16, 12, diagonals=True))
    pre = dict(add_self_loops=False, dense=False, pallas=False, bsr=True,
               gcn_fused=fused)
    gj, gp = J.precompute(g0j, **pre), P.precompute(g0p, **pre)
    assert sorted(gp.cache) == sorted(gj.cache)
    assert ("dia_norm" in gp.cache) == fused
    x = np.random.default_rng(6).normal(
        size=(g0j.num_nodes, in_dims)).astype(np.float32)
    solve = dict(rtol=1e-5, atol=1e-5, precomputed_self_loops=True)
    want, ps = _jax_logits(jax_grand(in_dims, 12, 5, **solve), gj, x)
    fused_calls = _spy(monkeypatch, port_fused, "dia_gcn_rhs")
    stencil_calls = _spy(monkeypatch, port_spmm, "dia_spmm_stencil")
    got = _port_logits(P.grand_model(in_dims, 12, 5, **solve), ps, gp, x,
                       "bsr")
    assert bool(fused_calls) == fused and bool(stencil_calls) != fused
    np.testing.assert_allclose(got, want, **TOL)


def test_port_imports_no_jax():
    """The port (its training example and measurement scripts included),
    and the chip smoke script, load neither jax nor the JAX package."""
    code = (
        "import sys; import neuralgraphpde_torch, chip_smoke; "
        "import neuralgraphpde_torch.examples.train_vmh, "
        "neuralgraphpde_torch.examples.train_gno_darcy, "
        "neuralgraphpde_torch.examples.train_mppde_burgers, "
        "neuralgraphpde_torch.examples.train_grand_cora; "
        "import neuralgraphpde_torch.tools.profile_paths, "
        "neuralgraphpde_torch.tools.time_build; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'neuralgraphpde' or m.startswith('neuralgraphpde.')]; "
        "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_card():
    """``chip_smoke.py`` exits non-zero and prints no result where there is
    no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _layer_pair(in_chs, out_chs, **kw):
    layer_j = J.GCNConv(in_chs, out_chs, "tanh", **kw)
    ps, st = J.setup(jax.random.PRNGKey(3), layer_j)
    layer_p = P.GCNConv(in_chs, out_chs, "tanh", **kw)
    P.params_from_jax(layer_p, jax.tree_util.tree_map(np.asarray, ps))
    return layer_j, ps, st, layer_p


@pytest.mark.parametrize("case", ["loops_in_forward", "weights_looped",
                                  "weights_runtime", "stored_weights",
                                  "premultiply"])
def test_gcnconv_branches_match_jax(case):
    """GCNConv's self-loop, edge-weight and out<in branches, both packages
    on their exact (xla) path."""
    gj, gp = J.rand_graph(60, 240, seed=7), P.rand_graph(60, 240, seed=7)
    rng = np.random.default_rng(8)
    w = rng.random(240).astype(np.float32)
    in_chs, out_chs, kw, ewj, ewp = 5, 7, {}, None, None
    if case == "loops_in_forward":  # add_self_loops=True, raw graph
        pass
    elif case == "weights_looped":  # weights for the original edges
        gj = J.precompute(gj, add_self_loops=True)
        gp = P.precompute(gp, add_self_loops=True)
        ewj, ewp = jnp.asarray(w), torch.from_numpy(w)
    elif case == "weights_runtime":
        kw = dict(add_self_loops=False)
        ewj, ewp = jnp.asarray(w), torch.from_numpy(w)
    elif case == "stored_weights":
        kw = dict(add_self_loops=False, use_edge_weight=True)
        gj = gj.replace(edata={"e": w})
        gp = gp.replace(edata={"e": w})
    else:
        in_chs, out_chs = 9, 4
    layer_j, ps, st, layer_p = _layer_pair(in_chs, out_chs, **kw)
    st = J.update_graph(st, gj)
    P.update_graph(layer_p, gp)
    x = rng.normal(size=(60, in_chs)).astype(np.float32)
    J.set_spmm_mode("xla")
    P.set_spmm_mode("xla")
    try:
        want, _ = layer_j(jnp.asarray(x), ps, st, edge_weight=ewj)
        with torch.no_grad():
            got = layer_p(torch.from_numpy(x), edge_weight=ewp)
    finally:
        J.set_spmm_mode("auto")
        P.set_spmm_mode("auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["pallas", "bsr", "auto"])
def test_weighted_spmm_dispatch_matches_jax(mode):
    """Runtime edge weights: ``pallas`` takes the weighted K1 path over the
    edge-index layout, ``bsr`` falls back to it, ``auto`` on the CPU to
    scatter; all equal the weighted gather/scatter sum."""
    gj, gp = J.rand_graph(80, 400, seed=9), P.rand_graph(80, 400, seed=9)
    cp = P.precompute(gp, dense=False, pallas=True)
    w = np.random.default_rng(9).random(400).astype(np.float32)
    x = np.random.default_rng(10).normal(size=(80, 6)).astype(np.float32)
    want = J.spmm(gj, jnp.asarray(x), edge_weight=jnp.asarray(w))
    # precompute sorted the edges by receiver: weights follow that order
    perm = np.argsort(gp.host_coo[1], kind="stable")
    P.set_spmm_mode(mode)
    try:
        got = P.spmm(cp, torch.from_numpy(x),
                     edge_weight=torch.from_numpy(w[perm]))
    finally:
        P.set_spmm_mode("auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("aggr", ["sum", "mean", "max"])
def test_generic_message_path_matches_jax(aggr):
    """``propagate`` with a message of its own goes apply_edges →
    aggregate_neighbors; in ``pallas`` mode sum and mean ride K1 over the
    edge-index layout."""
    gj = J.precompute(J.rand_graph(70, 300, seed=11), dense=False,
                      pallas=True)
    gp = P.precompute(P.rand_graph(70, 300, seed=11), dense=False,
                      pallas=True)
    x = np.random.default_rng(12).normal(size=(70, 4)).astype(np.float32)
    want = J.propagate(lambda xi, xj, e: xj - 0.5 * xi, gj, aggr,
                       xi=jnp.asarray(x), xj=jnp.asarray(x))
    P.set_spmm_mode("pallas")
    try:
        got = P.propagate(lambda xi, xj, e: xj - 0.5 * xi, gp, aggr,
                          xi=torch.from_numpy(x), xj=torch.from_numpy(x))
    finally:
        P.set_spmm_mode("auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
