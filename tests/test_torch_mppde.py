"""MP-PDE Burgers training path (config 3): the PyTorch port against the JAX
package on the CPU.

Both packages get the same seeded numpy inputs and the same parameters (the
JAX ``setup`` tree copied with ``params_from_jax``). Tolerances:

- graphs: equal arrays (the same host code);
- the Burgers dataset: the same initial conditions exactly; the solved
  trajectories within rel 1e-5 of the largest value (the two FFT libraries
  round differently over the RK4 steps: about 3e-7 at this test's nx 32,
  17 saves, 10 substeps, and it grows with the steps taken);
- ``ExplicitEdgeConv``, ``MPPDEConv`` and ``MPPDESolver`` outputs and
  losses: max |port − JAX| ≤ 1e-5 of the largest value; every gradient
  (parameters and input) within 1e-4 of its largest entry;
- one Adam step: the parameters within 1e-3 of the learning rate (a first
  Adam step moves each entry by ``lr·g/(|g| + eps)``, so only gradients
  within their rounding of zero may move differently; none does here);
- the training loop against the JAX script: the logged losses and rollout
  RMSE within rel 1e-4 (the datasets differ at the FFTs' rounding).
"""
import functools
import importlib
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

import neuralgraphpde as J  # noqa: E402
from neuralgraphpde.data.pde import burgers_dataset as jax_burgers  # noqa
from neuralgraphpde.models import MPPDESolver as JMPPDESolver  # noqa: E402
from neuralgraphpde.nn.basic import MLP as JMLP  # noqa: E402
from neuralgraphpde.train import adam as jax_adam  # noqa: E402
import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.examples import \
    train_mppde_burgers as port_train  # noqa: E402
from neuralgraphpde_torch.ops import fused as port_fused  # noqa: E402

port_spmm = importlib.import_module("neuralgraphpde_torch.ops.spmm")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = 1e-5  # outputs and losses: max|port − JAX| / max|JAX|
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


def _run(mode, fn):
    P.set_spmm_mode(mode)
    try:
        return fn()
    finally:
        P.set_spmm_mode("auto")


def _jax_xla(fn):
    J.set_spmm_mode("xla")
    try:
        return fn()
    finally:
        J.set_spmm_mode("auto")


# ------------------------------------------------------------ graph, data
def test_burgers_dataset_matches_jax():
    kw = dict(num_sims=2, nx=32, num_saves=17, substeps=10, seed=0)
    dj, dp = jax_burgers(**kw), P.burgers_dataset(**kw)
    assert dp.u.shape == dj.u.shape == (2, 17, 32, 1)
    assert dp.u.dtype == np.float32 and dp.nu == dj.nu
    np.testing.assert_array_equal(dp.ts, dj.ts)
    np.testing.assert_array_equal(dp.u[:, 0], dj.u[:, 0])
    assert _rel(dp.u, dj.u) <= 1e-5
    np.testing.assert_array_equal(dp.graph.senders.numpy(),
                                  np.asarray(dj.graph.senders))
    np.testing.assert_array_equal(dp.graph.receivers.numpy(),
                                  np.asarray(dj.graph.receivers))
    np.testing.assert_array_equal(dp.graph.ndata["x"].numpy(),
                                  np.asarray(dj.graph.ndata["x"]))


def test_burgers_precompute_matches_jax():
    """The config-3 chain (256 nodes, 2 neighbours each side: 1,024 edges)
    gets the same cache keys in both packages, the edge-id layout among
    them, and no stencil."""
    gj = J.precompute(J.grid_graph_1d(256, periodic=True, stencil=2),
                      dense=False)
    gp = P.precompute(P.grid_graph_1d(256, periodic=True, stencil=2),
                      dense=False)
    assert gp.num_edges == gj.num_edges == 1024
    assert sorted(gp.cache) == sorted(gj.cache)
    assert "tcsr_edges" in gp.cache and "dia" not in gp.cache


# ------------------------------------------------------- ExplicitEdgeConv
def _chain_pair(n=24, seed=0, **features):
    """The periodic stencil-2 chain in both packages, precomputed (edge-id
    layout attached), with ``features`` as ndata."""
    kw = dict(periodic=True, stencil=2, **features)
    gj = J.precompute(J.grid_graph_1d(n, **kw), dense=False, pallas=True,
                      tn=8, te=32)
    gp = P.precompute(P.grid_graph_1d(n, **kw), dense=False, pallas=True)
    return gj, gp


def _check_grads(layer_p, gps, strip=""):
    names = [name for name, _ in layer_p.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(gps))
    for name, p in layer_p.named_parameters():
        assert _rel(p.grad.numpy(), _leaf(gps, name[len(strip):])) <= GRAD, \
            name


@pytest.mark.parametrize("aggr,mode", [
    ("mean", "pallas"), ("sum", "pallas"), ("max", "pallas"),
    ("mean", "xla"), ("max", "xla"), ("min", "pallas")])
def test_explicit_edgeconv_matches_jax(monkeypatch, aggr, mode):
    """Output and gradients of ``ExplicitEdgeConv`` against the JAX layer
    on its exact path. Input as a dict whose ``x`` collides with the
    positions: ``ndata`` wins, in both. ``pallas`` mode takes K3 (sum,
    mean) or K6 (max, min), as their plain versions on the CPU. ϕ is the
    only child: its parameter tree is the layer's own."""
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(24, 2)).astype(np.float32)
    gj, gp = _chain_pair(ndata={"x": pos})
    layer_j = J.ExplicitEdgeConv(JMLP((8, 16, 16, 6), "tanh"), aggr=aggr)
    layer_p = P.ExplicitEdgeConv(P.MLP((8, 16, 16, 6), "tanh"), aggr=aggr)
    ps, st = J.setup(jax.random.PRNGKey(3), layer_j)
    st = J.update_graph(st, gj)
    h = rng.normal(size=(24, 3)).astype(np.float32)
    junk = rng.normal(size=(24, 2)).astype(np.float32)

    def loss(ps, h):
        y, _ = layer_j({"h": h, "x": jnp.asarray(junk)}, ps, st)
        return jnp.sum(y ** 2), y

    (_, want), (gps, gh) = _jax_xla(lambda: jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(h)))
    assert "layer_1" in ps  # flattened: no "phi" level
    P.params_from_jax(layer_p, _np(ps))
    P.update_graph(layer_p, gp)
    k3 = _spy(monkeypatch, port_fused, "fused_mlp_aggregate")
    k6 = _spy(monkeypatch, port_spmm, "segment_max_aggregate")
    hp = _t(h).requires_grad_()
    y = _run(mode, lambda: layer_p({"h": hp, "x": _t(junk)}))
    fused = mode == "pallas"
    assert len(k3) == (fused and aggr in ("sum", "mean"))
    assert len(k6) == (fused and aggr in ("max", "min"))
    (y ** 2).sum().backward()
    assert _rel(y.detach().numpy(), want) <= FWD
    assert _rel(hp.grad.numpy(), gh) <= GRAD
    _check_grads(layer_p, gps, strip="phi.")


# ------------------------------------------------------------- MPPDEConv
def _mppde_conv_case(rng, n=24, K=4, H=8, with_edata=False):
    u = rng.normal(size=(n, K)).astype(np.float32)
    pos = np.linspace(0, 2 * np.pi, n, endpoint=False).reshape(-1, 1).astype(
        np.float32)
    gj, gp = _chain_pair(n, ndata={"u": u, "x": pos})
    theta = {"nu": np.array([[0.01, 0.5]], np.float32)}
    gj = gj.copy(gdata=theta)
    gp = gp.copy(gdata=theta)
    E = 0
    if with_edata:
        e = rng.normal(size=(gp.num_edges, 3)).astype(np.float32)
        gj, gp = gj.copy(edata={"e": e}), gp.copy(edata={"e": e})
        E = 3
    width = 2 * H + K + 1 + E + 2
    return gj, gp, width


@pytest.mark.parametrize("aggr,mode,with_edata", [
    ("mean", "pallas", False), ("mean", "xla", False), ("max", "pallas", False),
    ("max", "xla", False), ("sum", "pallas", True), ("min", "pallas", True)])
def test_mppdeconv_matches_jax(monkeypatch, aggr, mode, with_edata):
    """Output and gradients of ``MPPDEConv`` (``[h_i, h_j, d_i − d_j, e,
    θ]`` with ``d = [u, x]`` and θ from ``gdata``) against the JAX layer on
    its exact path; ϕ takes K3 under sum and mean, ϕ on every edge then K6
    under max and min (``pallas`` mode)."""
    rng = np.random.default_rng(2)
    H = 8
    gj, gp, width = _mppde_conv_case(rng, H=H, with_edata=with_edata)
    layer_j = J.MPPDEConv(JMLP((width, H, H), "swish"),
                          JMLP((2 * H + 2, H, H), "swish"), aggr=aggr)
    layer_p = P.MPPDEConv(P.MLP((width, H, H), "swish"),
                          P.MLP((2 * H + 2, H, H), "swish"), aggr=aggr)
    ps, st = J.setup(jax.random.PRNGKey(5), layer_j)
    st = J.update_graph(st, gj)
    x = rng.normal(size=(24, H)).astype(np.float32)

    def loss(ps, x):
        y, _ = layer_j(x, ps, st)
        return jnp.sum(y ** 2), y

    (_, want), (gps, gx) = _jax_xla(lambda: jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(x)))
    P.params_from_jax(layer_p, _np(ps))
    P.update_graph(layer_p, gp)
    k3 = _spy(monkeypatch, port_fused, "fused_mlp_aggregate")
    k6 = _spy(monkeypatch, port_spmm, "segment_max_aggregate")
    xp = _t(x).requires_grad_()
    y = _run(mode, lambda: layer_p(xp))
    fused = mode == "pallas"
    assert len(k3) == (fused and aggr in ("sum", "mean"))
    assert len(k6) == (fused and aggr in ("max", "min"))
    (y ** 2).sum().backward()
    assert _rel(y.detach().numpy(), want) <= FWD
    assert _rel(xp.grad.numpy(), gx) <= GRAD
    _check_grads(layer_p, gps)


def test_mppdeconv_theta_broadcast_needs_equal_graphs():
    """A batch of graphs that cannot share one structure raises, as in
    JAX."""
    g = P.grid_graph_1d(9, periodic=True).copy(num_graphs=2)
    layer = P.update_graph(P.MPPDEConv(P.MLP((3, 4)), P.MLP((6, 4))), g)
    with pytest.raises(ValueError, match="identically-structured"):
        layer(torch.zeros(9, 2))


# ----------------------------------------------------------- MPPDESolver
def _solver_pair(n=16, K=4, H=16, depth=2, seed=4):
    pos = np.linspace(0, 2 * np.pi, n, endpoint=False).reshape(-1, 1).astype(
        np.float32)
    gj, gp = _chain_pair(n, ndata={"x": pos})
    model_j = JMPPDESolver(bundle=K, hidden=H, depth=depth, pos_dim=1,
                           initialgraph=gj)
    ps, st = J.setup(jax.random.PRNGKey(seed), model_j)
    model_p = P.MPPDESolver(bundle=K, hidden=H, depth=depth, pos_dim=1,
                            initialgraph=gp)
    P.params_from_jax(model_p, _np(ps))
    return model_j, ps, st, model_p


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_mppde_solver_matches_jax(monkeypatch, mode):
    """``MPPDESolver`` (hidden 16, depth 2, K 4) on a 16-node chain: the
    next bundle, and the pushforward loss of two windows with its gradients
    (every parameter and the first window), against the JAX model on its
    exact path. In ``pallas`` mode each of the 2 × 2 conv calls takes K3."""
    model_j, ps, st, model_p = _solver_pair()
    rng = np.random.default_rng(6)
    w0, w1, w2 = (rng.normal(size=(16, 4)).astype(np.float32)
                  for _ in range(3))

    def loss(ps, w0):
        pred1, _ = model_j(w0, ps, st)
        pred2, _ = model_j(jax.lax.stop_gradient(pred1), ps, st)
        return (jnp.mean((pred1 - w1) ** 2) + jnp.mean((pred2 - w2) ** 2),
                pred1)

    (lj, pred_j), (gps, gw) = _jax_xla(lambda: jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(w0)))
    k3 = _spy(monkeypatch, port_fused, "fused_mlp_aggregate")
    wp = _t(w0).requires_grad_()

    def port_loss():
        pred1 = model_p(wp)
        pred2 = model_p(pred1.detach())
        return P.mse(pred1, _t(w1)) + P.mse(pred2, _t(w2)), pred1

    lp, pred_p = _run(mode, port_loss)
    assert len(k3) == (4 if mode == "pallas" else 0)
    lp.backward()
    assert _rel(pred_p.detach().numpy(), pred_j) <= FWD
    assert _rel(float(lp.detach()), float(lj)) <= FWD
    assert _rel(wp.grad.numpy(), gw) <= GRAD
    names = [name for name, _ in model_p.named_parameters()]
    # encoder and decoder 2 layers each, every conv ϕ and ψ 2 layers each
    assert len(names) == len(jax.tree_util.tree_leaves(gps)) == 4 * (2 + 4)
    for name, p in model_p.named_parameters():
        assert _rel(p.grad.numpy(), _leaf(gps, name)) <= GRAD, name


def test_mppde_solver_rollout_and_graph_restore():
    """The rollout stacks bundles of the model applied to its own output,
    matches the JAX scan, and every conv holds its own graph again after a
    forward."""
    model_j, ps, st, model_p = _solver_pair(seed=7)
    w0 = np.random.default_rng(8).normal(size=(16, 4)).astype(np.float32)
    want, _ = _jax_xla(lambda: model_j.rollout(jnp.asarray(w0), ps, st, 3))
    own = [model_p.conv_1.graph, model_p.conv_2.graph]
    got = model_p.rollout(_t(w0), 3)
    assert got.shape == (3, 16, 4) and not got.requires_grad
    assert _rel(got.numpy(), want) <= FWD
    assert [model_p.conv_1.graph, model_p.conv_2.graph] == own


# ------------------------------------------------------------------ Adam
def test_one_adam_step_matches_jax():
    """One step of the training script (4 windows of one simulation,
    pushforward loss, Adam at 1e-4) from the same parameters: the same
    loss, and parameters within 1e-3 of the learning rate."""
    model_j, ps, st, model_p = _solver_pair(n=16, seed=9)
    rng = np.random.default_rng(10)
    u_sim = rng.normal(size=(16, 20)).astype(np.float32)
    s0s = np.array([0, 4, 8, 4])
    K, lr = 4, 1e-4

    def loss_fn(ps):
        def one(s0):
            w0, w1, w2 = (jax.lax.dynamic_slice_in_dim(
                jnp.asarray(u_sim), s0 + i * K, K, axis=1) for i in range(3))
            pred1, _ = model_j(w0, ps, st)
            pred2, _ = model_j(jax.lax.stop_gradient(pred1), ps, st)
            return (jnp.mean((pred1 - w1) ** 2)
                    + jnp.mean((pred2 - w2) ** 2))
        return jnp.mean(jax.vmap(one)(jnp.asarray(s0s)))

    opt = jax_adam(lr)
    lj, grads = _jax_xla(lambda: jax.value_and_grad(loss_fn)(ps))
    upd, _ = opt.update(grads, opt.init(ps), ps)
    new_ps = _np(jax.tree_util.tree_map(lambda p, u: p + u, ps, upd))
    step = P.make_train_step(
        lambda u, s: port_train.batch_loss(model_p, u, s),
        P.adam(model_p.parameters(), lr))
    lp, _ = step(_t(u_sim), s0s)
    assert _rel(float(lp), float(lj)) <= FWD
    for name, p in model_p.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(new_ps, name),
                                   rtol=0, atol=1e-3 * lr, err_msg=name)


# -------------------------------------------------------------- training
def _jax_train_mppde():
    spec = importlib.util.spec_from_file_location(
        "jax_train_mppde_burgers",
        os.path.join(REPO, "examples", "train_mppde_burgers.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_mppde_burgers_matches_jax(tmp_path):
    """Two epochs of the port's ``train_mppde_burgers`` (2 sims on a
    32-node chain, 41 saves, K 4, hidden 16, depth 2) log the JAX script's
    losses and first-sim rollout RMSE, from the JAX ``setup``
    parameters."""
    kw = dict(num_sims=2, nx=32, num_saves=41, bundle=4, hidden=16, depth=2,
              epochs=2)
    jmod = _jax_train_mppde()
    want = jmod.main(jmod.Config(log_path=str(tmp_path / "jax.jsonl"),
                                 **kw)).history
    cfg = port_train.Config(log_path=str(tmp_path / "port.jsonl"), **kw)
    model, u = port_train.setup(cfg, "cpu")
    model_j = JMPPDESolver(bundle=4, hidden=16, depth=2, pos_dim=1)
    ps, _ = J.setup(jax.random.PRNGKey(cfg.seed), model_j)
    P.params_from_jax(model, _np(ps))
    got = port_train.train(model, u, cfg).history
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    np.testing.assert_allclose([r["train_mse"] for r in got[:2]],
                               [r["train_mse"] for r in want[:2]], rtol=1e-4)
    np.testing.assert_allclose(got[2]["rollout_rmse"],
                               want[2]["rollout_rmse"], rtol=1e-4)


def test_train_mppde_burgers_cli_runs():
    """``python -m neuralgraphpde_torch.examples.train_mppde_burgers
    --device cpu --sims 4 --nx 64 --epochs 3`` (the full model: hidden
    128, depth 6, K 25) runs with finite losses and a rollout RMSE."""
    proc = subprocess.run(
        [sys.executable, "-m", "neuralgraphpde_torch.examples."
         "train_mppde_burgers", "--device", "cpu", "--sims", "4", "--nx",
         "64", "--epochs", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    losses = [float(v) for v in re.findall(r"bundle mse ([0-9.e+-]+|nan)",
                                           proc.stdout)]
    # the first bundle and the 3 it rolls out: 4 × 25 of the 101 saves
    rmse = re.findall(r"rollout rmse over 100 steps: ([0-9.]+)", proc.stdout)
    assert len(losses) == 3 and np.isfinite(losses).all(), proc.stdout
    assert len(rmse) == 1 and np.isfinite(float(rmse[0])), proc.stdout


def test_train_mppde_burgers_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.setup(port_train.Config(num_sims=1, nx=16), "cuda")
