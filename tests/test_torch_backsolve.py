"""The backsolve adjoint (``odeint(..., adjoint="backsolve")``, the default
as in JAX) and ``solve_stats``: the port against the JAX package on the CPU.

Two implementations of the continuous adjoint agree only where their
backward step sequences agree, so every comparison runs at solver rtol =
atol = 1e-6 on a short span: the loss within rel 1e-6, each gradient within
1e-4 of its own largest entry (the augmented right-hand side sums in
another order; a step size that moves by a rounding moves the result by
the solver's tolerance). The right-hand side is differentiated in
parameters it closes over (a module's, found by walking the graph of one
recorded evaluation) as JAX's ``closure_convert`` finds them, and in the
tensors passed through ``args``; a missed parameter would have no gradient
and fail the per-parameter comparisons. The backsolve gradient is not the
checkpoint (discrete) gradient: their gap is printed, not asserted.
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

import neuralgraphpde as J  # noqa: E402
from neuralgraphpde.data import synthetic_cora as jax_cora  # noqa: E402
from neuralgraphpde.data.pde import \
    convection_diffusion_dataset as jax_dataset  # noqa: E402
from neuralgraphpde.models import grand_model as jax_grand  # noqa: E402
from neuralgraphpde.models import vmh_model as jax_vmh_model  # noqa: E402
from neuralgraphpde.nn.basic import MLP as JMLP  # noqa: E402
from neuralgraphpde.ode import integrate as jax_int  # noqa: E402
from neuralgraphpde.train import losses as jl  # noqa: E402
import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.examples import train_vmh as port_train  # noqa
from neuralgraphpde_torch.ops import fused as port_fused  # noqa: E402
from neuralgraphpde_torch.ode import integrate as port_int  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-6)
LOSS, GRAD = 1e-6, 1e-4
TS = [0.0, 0.5, 1.3, 2.0]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _loss_rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def _tanh_problem(seed):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(6, 6)) / 2).astype(np.float32)
    y0 = rng.normal(size=(20, 6)).astype(np.float32)
    # positive weights: the loss is no sum of cancelling terms, so its
    # relative error is that of the saves
    wt = rng.random(size=(len(TS), 20, 6)).astype(np.float32)
    return a, y0, wt


def _jax_tanh_grads(a, y0, wt, time_term, **kw):
    def loss(y, m):
        ys = jax_int.odeint(
            lambda t, v, mm: 0.1 * (jnp.tanh(v @ mm) - 0.3 * v)
            + time_term * t, y, jnp.asarray(TS), m, **kw)
        return jnp.sum(ys * wt)

    return jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(y0),
                                                    jnp.asarray(a))


@pytest.mark.parametrize("interpolation", ["hermite", "tstop"])
@pytest.mark.parametrize("via", ["args", "closure"])
@pytest.mark.parametrize("time_term", [0.0, 0.05])
def test_odeint_backsolve_matches_jax(interpolation, via, time_term):
    """``f(t, y) = 0.1 (tanh(y A) − 0.3 y) + c·t``, the matrix passed
    through ``args`` or closed over (JAX hoists it with
    ``closure_convert``); with ``c ≠ 0`` the save times' cotangent ``t̄``
    has a derivative, which enters the backward's error norm."""
    a, y0, wt = _tanh_problem(1)
    kw = dict(interpolation=interpolation, adjoint="backsolve", **TOL)
    lj, (dyj, daj) = _jax_tanh_grads(a, y0, wt, time_term, **kw)
    yp, ap = _t(y0).requires_grad_(), _t(a).requires_grad_()

    def rhs(t, v, m):
        m = ap if m is None else m
        return 0.1 * (torch.tanh(v @ m) - 0.3 * v) + time_term * t

    stats = {}
    ys = P.odeint(rhs, yp, TS, ap if via == "args" else None, stats=stats,
                  **kw)
    lp = (ys * _t(wt)).sum()
    lp.backward()
    assert _loss_rel(lp.detach(), lj) <= LOSS
    assert _rel(yp.grad, dyj) <= GRAD
    assert _rel(ap.grad, daj) <= GRAD
    assert stats["backward_accepted"] >= len(TS) - 1
    assert stats["backward_nfe"] > stats["backward_steps"]


def test_odeint_default_adjoint_matches_jax_default():
    """Neither side names an adjoint: both default to backsolve."""
    a, y0, wt = _tanh_problem(2)
    lj, (dyj, daj) = _jax_tanh_grads(a, y0, wt, 0.0, **TOL)
    yp, ap = _t(y0).requires_grad_(), _t(a).requires_grad_()
    ys = P.odeint(lambda t, v, m: 0.1 * (torch.tanh(v @ m) - 0.3 * v), yp,
                  TS, ap, **TOL)
    assert ys.grad_fn is not None and "Backsolve" in ys.grad_fn.name()
    (ys * _t(wt)).sum().backward()
    assert _rel(yp.grad, dyj) <= GRAD and _rel(ap.grad, daj) <= GRAD


def test_backsolve_vs_checkpoint_gap():
    """The two adjoints differentiate different things (the continuous
    solution, the discrete solve); their gap is stated, not bounded."""
    a, y0, wt = _tanh_problem(3)
    grads = {}
    for adjoint in ("backsolve", "checkpoint"):
        yp, ap = _t(y0).requires_grad_(), _t(a).requires_grad_()
        ys = P.odeint(lambda t, v, m: 0.1 * (torch.tanh(v @ m) - 0.3 * v),
                      yp, TS, ap, adjoint=adjoint, rtol=1e-4, atol=1e-4)
        (ys * _t(wt)).sum().backward()
        grads[adjoint] = (yp.grad.numpy(), ap.grad.numpy())
    gaps = [_rel(b, c) for b, c in zip(grads["backsolve"],
                                       grads["checkpoint"])]
    print(f"backsolve vs checkpoint at rtol = atol = 1e-4: dy0 "
          f"{gaps[0]:.3e}, dA {gaps[1]:.3e} of the largest entry")
    assert all(np.isfinite(g).all() for pair in grads.values()
               for g in pair)


def test_backsolve_refuses_closed_over_non_leaf():
    """A tensor computed before the solve from a parameter and closed over
    by the right-hand side: its gradient cannot be routed, so the solve
    raises instead of dropping it; passed through ``args`` it works."""
    a, y0, _ = _tanh_problem(4)
    w = _t(a).requires_grad_()
    m = w * 2.0  # not a leaf
    with pytest.raises(ValueError, match="pass it through args"):
        P.odeint(lambda t, v, _: torch.tanh(v @ m), _t(y0), TS, **TOL)
    ys = P.odeint(lambda t, v, mm: torch.tanh(v @ mm), _t(y0), TS, m, **TOL)
    ys.sum().backward()
    assert w.grad is not None and bool(torch.isfinite(w.grad).all())


def test_backsolve_without_grad_is_the_plain_solve():
    """Under ``no_grad``, or with nothing that requires grad, the solve is
    the forward alone (no autograd node), and equals the backsolve
    forward's values."""
    a, y0, _ = _tanh_problem(5)
    ap = _t(a).requires_grad_()

    def rhs(t, v, m):
        return 0.1 * (torch.tanh(v @ m) - 0.3 * v)

    ys = P.odeint(rhs, _t(y0), TS, ap, **TOL)
    with torch.no_grad():
        plain = P.odeint(rhs, _t(y0), TS, ap, **TOL)
    free = P.odeint(rhs, _t(y0), TS, _t(a), **TOL)
    assert plain.grad_fn is None and free.grad_fn is None
    np.testing.assert_array_equal(plain.numpy(), ys.detach().numpy())
    np.testing.assert_array_equal(free.numpy(), plain.numpy())


def test_solve_stats_matches_jax():
    a, y0, _ = _tanh_problem(6)
    kw = dict(rtol=1e-5, atol=1e-5)
    ys_j, att_j = jax_int.solve_stats(
        lambda t, v, m: 0.1 * (jnp.tanh(v @ m) - 0.3 * v), jnp.asarray(y0),
        jnp.asarray(TS), jnp.asarray(a), **kw)
    ys_p, att_p = P.solve_stats(
        lambda t, v, m: 0.1 * (torch.tanh(v @ m) - 0.3 * v), _t(y0), TS,
        _t(a), **kw)
    assert att_p.dtype == torch.int64 and att_p.shape == (len(TS) - 1,)
    assert att_p.tolist() == np.asarray(att_j).tolist()
    assert _rel(ys_p, ys_j) <= 1e-4


def test_neural_ode_keeps_the_checkpoint_default():
    """``NeuralGraphODE`` and the model builders keep JAX's
    ``adjoint="checkpoint"``; only the bare ``odeint`` defaults to
    backsolve."""
    assert P.NeuralGraphODE(P.Dense(2, 2)).adjoint == "checkpoint"
    assert J.NeuralGraphODE(J.Dense(2, 2)).adjoint == "checkpoint"
    assert P.vmh_model().adjoint == "checkpoint"
    assert port_train.Config().adjoint == "checkpoint"


# ------------------------------------------------------------------ models
def test_grand_backsolve_matches_jax():
    """``grand_model(8, 8, 3, adjoint="backsolve")`` on a 400-node
    synthetic Cora (dense adjacency): the masked cross-entropy and its
    gradient in every parameter (the encoder's through ``y0``, the ODE's
    closed over by its right-hand side, the decoder's outside the solve)."""
    kw = dict(num_nodes=400, num_edges=1600, num_features=8, seed=3)
    pre = dict(add_self_loops=True, dense=True)
    cj = J.precompute(jax_cora(**kw).graph, **pre)
    cp = P.precompute(P.synthetic_cora(**kw).graph, **pre)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(400, 8)).astype(np.float32)
    labels = rng.integers(0, 3, 400).astype(np.int32)
    mask = rng.random(400) < 0.3
    solve = dict(adjoint="backsolve", precomputed_self_loops=True, **TOL)
    mj = jax_grand(8, 8, 3, **solve)
    ps, st = J.setup(jax.random.PRNGKey(0), mj)
    st = J.update_graph(st, cj)

    def loss_j(p):
        return jl.masked_cross_entropy(mj(jnp.asarray(x), p, st)[0],
                                       jnp.asarray(labels), jnp.asarray(mask))

    want_loss, want_g = jax.value_and_grad(loss_j)(ps)
    model = P.grand_model(8, 8, 3, **solve)
    P.params_from_jax(model, _np(ps))
    P.update_graph(model, cp)
    loss = P.masked_cross_entropy(model(_t(x)), torch.from_numpy(labels),
                                  torch.from_numpy(mask))
    loss.backward()
    assert _loss_rel(loss.detach(), want_loss) <= LOSS
    assert model.layer_2.last_stats["backward_accepted"] >= 1
    for name, p in model.named_parameters():
        assert _rel(p.grad, _leaf_of(want_g, name)) <= GRAD, name


def _leaf_of(tree, dotted):
    """``layer_2.model.layer_1.weight`` → the JAX tree's entry: a
    single-child container (``NeuralGraphODE``) flattens its child."""
    node = tree
    for key in dotted.split("."):
        if key == "model":
            continue
        node = node[key]
    return node


def _vmh_pair(rng, adjoint):
    sj = J.rand_graph(40, 240, seed=int(rng.integers(1 << 30)))
    pos = rng.normal(size=(40, 2)).astype(np.float32)
    gj = J.precompute(sj.replace(ndata={"x": jnp.asarray(pos)}),
                      dense=False, pallas=True, tn=8, te=64)
    gp = P.precompute(P.GnnGraph.from_coo(
        np.asarray(sj.senders), np.asarray(sj.receivers), num_nodes=40,
        ndata={"x": pos}), dense=False, pallas=True)
    kw = dict(tspan=(0.0, 0.1), saveat=(0.0, 0.05, 0.1), adjoint=adjoint,
              **TOL)
    node_j = J.NeuralGraphODE(J.VMHConv(JMLP((4, 12, 12, 6), "tanh"),
                                        JMLP((7, 12, 1))), **kw)
    node_p = P.NeuralGraphODE(P.VMHConv(P.MLP((4, 12, 12, 6), "tanh"),
                                        P.MLP((7, 12, 1))), **kw)
    ps, st = J.setup(jax.random.PRNGKey(7), node_j)
    st = J.update_graph(st, gj)
    P.params_from_jax(node_p, _np(ps))
    P.update_graph(node_p, gp)
    return node_j, ps, st, node_p


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_vmh_backsolve_matches_jax(monkeypatch, mode):
    """``NeuralGraphODE(VMHConv, adjoint="backsolve")``: every weight
    reaches the right-hand side through the module, none through ``args``;
    on the fused path (``pallas``: K3's plain versions) each augmented
    evaluation differentiates through K3."""
    rng = np.random.default_rng(7)
    node_j, ps, st, node_p = _vmh_pair(rng, "backsolve")
    x = rng.normal(size=(40, 1)).astype(np.float32)

    def loss(ps):
        y, _ = node_j(jnp.asarray(x), ps, st)
        return jnp.mean(y ** 2)

    J.set_spmm_mode("xla")
    try:
        lj, gps = jax.value_and_grad(loss)(ps)
    finally:
        J.set_spmm_mode("auto")
    calls = []
    orig = port_fused.fused_mlp_aggregate
    monkeypatch.setattr(port_fused, "fused_mlp_aggregate",
                        lambda *a: (calls.append(1), orig(*a))[1])
    P.set_spmm_mode(mode)
    try:
        lp = torch.mean(node_p(_t(x)) ** 2)
        forward_calls = len(calls)
        lp.backward()
    finally:
        P.set_spmm_mode("auto")
    assert (len(calls) > forward_calls > 0) == (mode == "pallas")
    assert _loss_rel(lp.detach(), lj) <= LOSS
    for name, p in node_p.named_parameters():
        _, sub, layer, leaf = name.split(".")
        assert p.grad is not None, name
        assert _rel(p.grad, gps[sub][layer][leaf]) <= GRAD, name
    stats = node_p.last_stats
    print(f"VMH backsolve: forward {stats['accepted']} accepted steps, "
          f"backward {stats['backward_accepted']} accepted of "
          f"{stats['backward_steps']}, {stats['backward_nfe']} rhs evals")


def _jax_train_vmh():
    spec = importlib.util.spec_from_file_location(
        "jax_train_vmh", os.path.join(REPO, "examples", "train_vmh.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_vmh_backsolve_epochs_match_jax():
    """Two Rprop epochs of ``train_vmh`` with ``adjoint="backsolve"`` (2
    sims, 60 points, hidden 8) give the JAX script's loss per epoch; the
    script's ``--adjoint`` flag reaches the model."""
    jmod = _jax_train_vmh()
    jcfg = jmod.Config(num_sims=2, num_points=60, hidden=8, epochs=2,
                       log_every=1, adjoint="backsolve")
    want = [r["train_mse"] for r in jmod.main(jcfg).history]
    cfg = port_train.Config(num_sims=2, num_points=60, hidden=8, epochs=2,
                            log_every=1, adjoint="backsolve")
    model, u = port_train.setup(cfg, "cpu")
    assert model.adjoint == "backsolve"
    data = jax_dataset(num_sims=2, num_points=60, seed=0)
    saveat = tuple(np.asarray(data.ts))
    ps, _ = J.setup(jax.random.PRNGKey(cfg.seed), jax_vmh_model(
        1, 2, hidden=cfg.hidden, msg_dim=cfg.msg_dim, depth=cfg.depth,
        tspan=(saveat[0], saveat[-1]), saveat=saveat))
    P.params_from_jax(model, _np(ps))
    got = port_train.train(model, u, cfg)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    args = port_train.parse_args(["--device", "cpu", "--adjoint",
                                  "backsolve"])
    assert port_train.config_from_args(args).adjoint == "backsolve"
