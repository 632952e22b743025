"""VMH training path: the PyTorch port against the JAX package on the CPU.

Both packages get the same seeded numpy inputs and the same parameters (the
JAX ``setup`` tree copied with ``params_from_jax``). Tolerances:

- graphs and datasets: equal arrays (the same host code on one seed);
- K3's plain versions against the Pallas kernels in interpret mode:
  max |port − JAX| ≤ 1e-5 of the largest value (f32 sums in another
  order);
- ``VMHConv`` and ``NeuralGraphODE(VMHConv)`` outputs and gradients:
  rtol 1e-4 / atol 1e-4 (and 1e-4 of the largest entry of each gradient),
  the JAX package's own fused-vs-xla bound (``tests/test_fused_mlp.py``);
- ``rprop``: equal updates (the same f32 operations);
- losses of the training loop and of the full configuration: rel 1e-5,
  and each epoch's loss change within 1e-2 of JAX's (at lr 1e-6 the loss
  moves by ~1e-6 an epoch, below a plain relative bound).
"""
import importlib.util
import os

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
from neuralgraphpde.data.pde import \
    convection_diffusion_dataset as jax_dataset  # noqa: E402
from neuralgraphpde.graph.builders import \
    delaunay_graph as jax_delaunay  # noqa: E402
from neuralgraphpde.kernels import fused_mlp_kernels as JK  # noqa: E402
from neuralgraphpde.models import vmh_model as jax_vmh_model  # noqa: E402
from neuralgraphpde.nn.basic import MLP as JMLP  # noqa: E402
from neuralgraphpde.train import rprop as jax_rprop  # noqa: E402
import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.examples import train_vmh as port_train  # noqa
from neuralgraphpde_torch.kernels import fused_mlp_kernels as PK  # noqa
from neuralgraphpde_torch.nn import conv as port_conv  # noqa: E402
from neuralgraphpde_torch.ops import fused as port_fused  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


# ------------------------------------------------------------ graph, data
def test_delaunay_graph_matches_jax():
    pts = np.random.default_rng(0).random((300, 2)).astype(np.float32)
    gj, gp = jax_delaunay(pts), P.delaunay_graph(pts)
    assert gp.num_nodes == gj.num_nodes and gp.num_edges == gj.num_edges
    np.testing.assert_array_equal(gp.senders.numpy(), np.asarray(gj.senders))
    np.testing.assert_array_equal(gp.receivers.numpy(),
                                  np.asarray(gj.receivers))


def test_convection_diffusion_dataset_matches_jax():
    kw = dict(num_sims=2, num_points=200, grid_n=32, num_saves=5, seed=3)
    dj, dp = jax_dataset(**kw), P.convection_diffusion_dataset(**kw)
    for name in ("u", "ts", "positions"):
        np.testing.assert_array_equal(getattr(dp, name), getattr(dj, name))
    np.testing.assert_array_equal(dp.graph.senders.numpy(),
                                  np.asarray(dj.graph.senders))
    np.testing.assert_array_equal(dp.graph.receivers.numpy(),
                                  np.asarray(dj.graph.receivers))
    np.testing.assert_array_equal(dp.graph.ndata["x"].numpy(),
                                  np.asarray(dj.graph.ndata["x"]))


def test_vmh_precompute_matches_jax():
    """The VMH mesh gets the edge-id layout and no stencil, as in JAX."""
    pts = np.random.default_rng(1).random((1100, 2)).astype(np.float32)
    gj = J.precompute(jax_delaunay(pts), dense=False)
    gp = P.precompute(P.delaunay_graph(pts), dense=False)
    assert sorted(gp.cache) == sorted(gj.cache)
    assert "tcsr_edges" in gp.cache and "dia" not in gp.cache


# --------------------------------------------------------------------- K3
def _k3_inputs(acts, seed=0):
    rng = np.random.default_rng(seed)
    gj = J.precompute(J.rand_graph(50, 300, seed=seed + 3), dense=False,
                      pallas=True, tn=8, te=64)
    gp = P.precompute(P.rand_graph(50, 300, seed=seed + 3), dense=False,
                      pallas=True)
    dims = (4, 16, 16, 8)[:len(acts) + 1]
    feats = rng.normal(size=(300, 4)).astype(np.float32)
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.normal(size=(1, b)) / 3).astype(np.float32) for b in dims[1:]]
    g = rng.normal(size=(50, dims[-1])).astype(np.float32)
    return gj.cache["tcsr_edges"], gp.cache["tcsr_edges"], feats, ws, bs, g


@pytest.mark.parametrize("acts", [
    ("tanh", "tanh", None), ("relu", "sigmoid", "softplus"),
    ("elu", "gelu", "swish"), ("silu",), (None, "tanh")])
def test_k3_plain_matches_pallas(acts):
    """Forward (``_fused_mlp_fwd``) and VJP (``_fused_mlp_bwd_pallas``)
    against the port's plain versions, on every kernel activation."""
    tj, tp, feats, ws, bs, g = _k3_inputs(acts)
    jw, jb = tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs))
    gpad = np.zeros((tj.num_tiles * tj.tn, g.shape[1]), np.float32)
    gpad[:50] = g
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JK._fused_mlp_fwd(acts, tj, jnp.asarray(feats), jw,
                                            jb, interpret=True))[:50]
        wdf, wdw, wdb = JK._fused_mlp_bwd_pallas(
            acts, tj, jnp.asarray(feats), jw, jb, jnp.asarray(gpad),
            interpret=True)
    pw, pb = list(map(_t, ws)), list(map(_t, bs))
    got = PK.fused_mlp_fwd(acts, tp, _t(feats), pw, pb)
    assert _rel(got.numpy(), want) <= 1e-5
    gdf, gdw, gdb = PK.fused_mlp_bwd(acts, tp, _t(feats), pw, pb, _t(g))
    for a, b in zip((gdf,) + gdw + gdb, (wdf,) + wdw + wdb):
        assert tuple(a.shape) == tuple(b.shape)
        assert _rel(a.numpy(), b) <= 1e-5


def test_k3_plain_autograd_equals_plain_vjp():
    """``fused_mlp_aggregate`` on the CPU is the plain forward under
    autograd; its gradients are ``fused_mlp_bwd_plain``'s."""
    acts = ("tanh", "tanh", None)
    _, tp, feats, ws, bs, g = _k3_inputs(acts, seed=1)
    leaves = [_t(a).requires_grad_() for a in [feats, *ws, *bs]]
    out = PK.fused_mlp_aggregate(acts, leaves[0], leaves[1:4], leaves[4:],
                                 tp)
    out.backward(_t(g))
    df, dw, db = PK.fused_mlp_bwd_plain(acts, tp, _t(feats),
                                        list(map(_t, ws)), list(map(_t, bs)),
                                        _t(g))
    for leaf, want in zip(leaves, (df,) + dw + db):
        np.testing.assert_allclose(leaf.grad.numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_k3_wrappers_refuse():
    """A dtype other than f32 and bf16, weights in two dtypes, unsupported
    activations, mismatched widths and a device with no kernel raise;
    nothing falls back. (The shared-memory envelope is the CUDA kernels'
    and raises on the card: ``test_torch_kernels.py``.)"""
    acts = ("tanh", None)
    _, tp, feats, ws, bs, _ = _k3_inputs(acts)
    pw, pb = list(map(_t, ws)), list(map(_t, bs))
    with pytest.raises(TypeError, match="f32 or bf16"):
        PK.fused_mlp_fwd(acts, tp, _t(feats).to(torch.float16), pw, pb)
    with pytest.raises(TypeError, match="one dtype"):
        PK.fused_mlp_fwd(acts, tp, _t(feats), pw,
                         [pb[0].to(torch.bfloat16), pb[1]])
    with pytest.raises(ValueError, match="does not take width"):
        PK.fused_mlp_fwd(acts, tp, _t(feats), pw[::-1], pb)
    with pytest.raises(ValueError, match="no kernel form"):
        PK.fused_mlp_fwd(("leaky_relu", None), tp, _t(feats), pw, pb)
    meta = [t.to("meta") for t in pw], [t.to("meta") for t in pb]
    with pytest.raises(RuntimeError, match="no kernel"):
        PK.fused_mlp_fwd(acts, tp, _t(feats).to("meta"), *meta)


@pytest.mark.parametrize("hidden,depth", [(60, 3), (128, 3), (16, 5)])
def test_fused_phi_gate_ignores_widths(monkeypatch, hidden, depth):
    """The fused-ϕ gate is JAX's: any Dense stack with kernel activations
    under sum or mean takes K3 in ``pallas`` mode, whatever its widths (on
    the card, widths outside the envelope then raise in the wrapper)."""
    gj, gp, rng = _graph_pair(False, seed=3)
    phi = P.MLP((4,) + (hidden,) * depth + (6,), "tanh",
                generator=torch.Generator().manual_seed(0))
    plan = port_conv.fused_phi_plan(phi, "mean")
    assert plan is not None and len(plan[0]) == depth
    layer = P.VMHConv(phi, P.MLP((7, 12, 1)))
    P.update_graph(layer, gp)
    fused = _spy(monkeypatch, port_fused, "fused_mlp_aggregate")
    x = _t(rng.normal(size=(40, 1)))
    P.set_spmm_mode("pallas")
    try:
        with torch.no_grad():
            got = layer(x)
    finally:
        P.set_spmm_mode("auto")
    assert fused
    P.set_spmm_mode("xla")
    try:
        with torch.no_grad():
            want = layer(x)
    finally:
        P.set_spmm_mode("auto")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ---------------------------------------------------------------- VMHConv
def _graph_pair(isolated, seed):
    rng = np.random.default_rng(seed)
    n = 40
    if isolated:  # every edge points at nodes 0..9: the rest have none
        s = rng.integers(0, n, 200).astype(np.int32)
        r = rng.integers(0, 10, 200).astype(np.int32)
    else:
        s = rng.integers(0, n, 200).astype(np.int32)
        r = rng.integers(0, n, 200).astype(np.int32)
    pos = rng.normal(size=(n, 2)).astype(np.float32)
    gj = J.GnnGraph.from_coo(s, r, num_nodes=n, ndata={"x": pos})
    gp = P.GnnGraph.from_coo(s, r, num_nodes=n, ndata={"x": pos})
    return (J.precompute(gj, dense=False, pallas=True, tn=8, te=32),
            P.precompute(gp, dense=False, pallas=True), rng)


def _conv_pair(msg=6):
    layer_j = J.VMHConv(JMLP((4, 12, 12, msg), "tanh"), JMLP((1 + msg, 12, 1)))
    layer_p = P.VMHConv(P.MLP((4, 12, 12, msg), "tanh"), P.MLP((1 + msg, 12,
                                                               1)))
    return layer_j, layer_p


@pytest.mark.parametrize("aggr,isolated,mode", [
    ("mean", False, "pallas"), ("sum", False, "pallas"),
    ("mean", True, "pallas"), ("mean", False, "xla"), ("sum", True, "xla")])
def test_vmhconv_matches_jax(monkeypatch, aggr, isolated, mode):
    """Output and gradients (parameters and input) of the port's VMHConv,
    on the fused path (``pallas``: K3's plain versions on the CPU) and the
    exact path, against the JAX layer on its exact path. ``isolated``:
    receivers with no in-edges, which stay 0 under mean."""
    gj, gp, rng = _graph_pair(isolated, seed=2)
    layer_j, layer_p = _conv_pair()
    layer_j = J.VMHConv(layer_j.phi, layer_j.gamma, aggr=aggr)
    layer_p.aggr = aggr
    ps, st = J.setup(jax.random.PRNGKey(4), layer_j)
    st = J.update_graph(st, gj)
    x = rng.normal(size=(40, 1)).astype(np.float32)

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
    fused = _spy(monkeypatch, port_fused, "fused_mlp_aggregate")
    xp = _t(x).requires_grad_()
    P.set_spmm_mode(mode)
    try:
        y = layer_p(xp)
    finally:
        P.set_spmm_mode("auto")
    assert bool(fused) == (mode == "pallas")
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xp.grad.numpy(), np.asarray(gx), **TOL)
    for name, p in layer_p.named_parameters():
        sub, layer, leaf = name.split(".")
        want_g = np.asarray(gps[sub][layer][leaf])
        np.testing.assert_allclose(p.grad.numpy(), want_g, **TOL)


def test_node_vmh_gradients_match_jax_checkpoint_adjoint(monkeypatch):
    """``NeuralGraphODE(VMHConv)`` parameter gradients through the adaptive
    solve with K3 on the path, against the JAX checkpoint adjoint on its
    exact path (the analog of ``test_fused_backward_inside_checkpoint_
    adjoint``)."""
    rng = np.random.default_rng(7)
    sj = J.rand_graph(40, 240, seed=int(rng.integers(1 << 30)))
    pos = rng.normal(size=(40, 2)).astype(np.float32)
    gj = J.precompute(sj.replace(ndata={"x": jnp.asarray(pos)}),
                      dense=False, pallas=True, tn=8, te=64)
    gp = P.precompute(P.GnnGraph.from_coo(
        np.asarray(sj.senders), np.asarray(sj.receivers), num_nodes=40,
        ndata={"x": pos}), dense=False, pallas=True)
    kw = dict(tspan=(0.0, 0.1), saveat=(0.0, 0.05, 0.1),
              adjoint="checkpoint", checkpoint_steps=16)
    core_j, core_p = _conv_pair()
    node_j = J.NeuralGraphODE(core_j, **kw)
    node_p = P.NeuralGraphODE(core_p, **kw)
    ps, st = J.setup(jax.random.PRNGKey(7), node_j)
    st = J.update_graph(st, gj)
    x = rng.normal(size=(40, 1)).astype(np.float32)

    def loss(ps):
        y, _ = node_j(jnp.asarray(x), ps, st)
        return jnp.mean(y ** 2)

    J.set_spmm_mode("xla")
    try:
        lj, gps = jax.value_and_grad(loss)(ps)
    finally:
        J.set_spmm_mode("auto")
    P.params_from_jax(node_p, _np(ps))
    P.update_graph(node_p, gp)
    fused = _spy(monkeypatch, port_fused, "fused_mlp_aggregate")
    P.set_spmm_mode("pallas")
    try:
        lp = torch.mean(node_p(_t(x)) ** 2)
    finally:
        P.set_spmm_mode("auto")
    assert fused
    lp.backward()
    np.testing.assert_allclose(float(lp.detach()), float(lj), rtol=1e-4)
    for name, p in node_p.named_parameters():
        _, sub, layer, leaf = name.split(".")
        want = np.asarray(gps[sub][layer][leaf])
        assert _rel(p.grad.numpy(), want) <= 1e-4, name


# ------------------------------------------------------------------ rprop
def test_rprop_matches_jax():
    """Five steps with sign flips, zero gradients and step sizes pushed to
    both bounds; the learning rate starts above ``step_max`` for half the
    entries, so a step size kept (sign 0) must stay above it."""
    rng = np.random.default_rng(5)
    kw = dict(eta_minus=0.5, eta_plus=1.2, step_min=0.05, step_max=0.5)
    p0 = rng.normal(size=(2, 8)).astype(np.float32)
    lr = np.where(np.arange(8) < 4, 0.7, 0.2).astype(np.float32)
    signs = [rng.choice([-1.0, 0.0, 1.0], size=(2, 8), p=[0.4, 0.2, 0.4])
             for _ in range(5)]
    grads = [(s * rng.uniform(0.5, 2.0, size=(2, 8))).astype(np.float32)
             for s in signs]
    # the JAX rprop takes a scalar learning rate: one optimizer per column
    want = np.empty((5, 2, 8), np.float32)
    for c in range(8):
        opt = jax_rprop(float(lr[c]), **kw)
        params = jnp.asarray(p0[:, c])
        state = opt.init(params)
        for k, g in enumerate(grads):
            upd, state = opt.update(jnp.asarray(g[:, c]), state, params)
            params = params + upd
            want[k, :, c] = np.asarray(params)
    for c in range(8):
        p = torch.nn.Parameter(torch.from_numpy(p0[:, c].copy()))
        opt = P.rprop([p], float(lr[c]), **kw)
        for k, g in enumerate(grads):
            p.grad = torch.from_numpy(g[:, c].copy())
            opt.step()
            np.testing.assert_array_equal(p.detach().numpy(), want[k, :, c])


# --------------------------------------------------------------- training
def _jax_train_vmh():
    spec = importlib.util.spec_from_file_location(
        "jax_train_vmh", os.path.join(REPO, "examples", "train_vmh.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_vmh_params(cfg, data):
    saveat = tuple(np.asarray(data.ts))
    model = jax_vmh_model(1, 2, hidden=cfg.hidden, msg_dim=cfg.msg_dim,
                          depth=cfg.depth, tspan=(saveat[0], saveat[-1]),
                          saveat=saveat, rtol=cfg.rtol, atol=cfg.atol)
    ps, st = J.setup(jax.random.PRNGKey(cfg.seed), model)
    return model, ps, st


def test_train_vmh_three_epochs_match_jax():
    """Three full-batch Rprop epochs of the port's ``train_vmh`` (2 sims,
    60 points, hidden 8) give the JAX script's loss per epoch."""
    jmod = _jax_train_vmh()
    jcfg = jmod.Config(num_sims=2, num_points=60, hidden=8, epochs=3,
                       log_every=1)
    want = [r["train_mse"] for r in jmod.main(jcfg).history]
    cfg = port_train.Config(num_sims=2, num_points=60, hidden=8, epochs=3,
                            log_every=1)
    model, u = port_train.setup(cfg, "cpu")
    _, ps, _ = _jax_vmh_params(cfg, jax_dataset(
        num_sims=2, num_points=60, seed=0))
    P.params_from_jax(model, _np(ps))
    got = port_train.train(model, u, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(np.diff(got), np.diff(want), rtol=1e-2)
    assert got[-1] < got[0]


def test_train_vmh_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.setup(port_train.Config(num_sims=1, num_points=20),
                         "cuda")


def test_full_configuration_forward_loss_matches_jax():
    """24 sims × 3,000 points, the seed-0 JAX parameters: the mean rollout
    MSE of the full configuration's forward, as ``train_vmh`` takes it."""
    cfg = port_train.Config()
    data = jax_dataset(num_sims=cfg.num_sims, num_points=cfg.num_points,
                       seed=cfg.seed)
    model_j, ps, st = _jax_vmh_params(cfg, data)
    st = J.update_graph(st, J.precompute(data.graph, dense=False))

    def loss_fn(ps, u, st):
        def one(traj):
            pred, _ = model_j(traj[0], ps, st)
            return jnp.mean((pred - traj) ** 2)

        return jnp.mean(jax.vmap(one)(u))

    want = float(jax.jit(loss_fn)(ps, jnp.asarray(data.u), st))
    model, u = port_train.setup(cfg, "cpu")
    P.params_from_jax(model, _np(ps))
    with torch.no_grad():
        got = sum(float(P.rollout_mse(model(u[s, 0]), u[s]))
                  for s in range(cfg.num_sims)) / cfg.num_sims
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("events,want", [
    ([], 0.0),
    ([("a", 0, 10, "kernel")], 10.0),
    ([("a", 0, 10, "kernel"), ("b", 5, 10, "kernel")], 15.0),  # overlap
    ([("a", 0, 10, "kernel"), ("b", 2, 3, "gpu_memcpy")], 10.0),  # inside
    ([("b", 20, 5, "kernel"), ("a", 0, 10, "kernel")], 15.0),  # unsorted
])
def test_profile_busy_time_is_interval_union(events, want):
    """The device busy time behind the paths' idle shares
    (``tools/profile_paths.py``) counts overlapping device events once."""
    from neuralgraphpde_torch.tools.profile_paths import busy_us

    assert busy_us(events) == want
