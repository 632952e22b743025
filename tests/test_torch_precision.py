"""The precision policy (``nn/precision.py``): the port's ``Precision`` /
``bf16`` against the JAX package's, on the CPU.

- The JAX package's own three cases (``tests/test_precision.py``): f32
  output and f32 masters, f32 master gradients, ``compute_dtype=f32`` an
  exact no-op.
- ``bf16(layer)`` against JAX's ``bf16(layer)`` for ``GCNConv``,
  ``VMHConv``, ``MPPDEConv(aggr="max")`` and ``GNOConv`` at small widths,
  output and the gradients of the input and of every master parameter:
  max |port − JAX| within 1e-2 of the largest value (both round the same
  operands to bf16; they round intermediate results at different places).
  Both packages run their kernel path (``pallas``: the port's plain K1,
  K3, K5 and K6 versions on the CPU, JAX's Pallas kernels in interpret
  mode; the two share the arg-max tie rule) and their exact path. Each layer
  runs on a graph whose node data are f32, as the JAX wrapper leaves them
  (the edge features then promote to f32 and the kernels read f32
  features with bf16 weights), and on one whose node data the caller gave
  in bf16 (every kernel operand bf16). On the bf16 graph the whole layer
  computes in bf16, and there the gradients are held to 3e-2: every
  elementwise op rounds to bf16 (2^-8 relative), PyTorch after each op and
  XLA once per fused chain, and a gradient that sums cancelling terms
  (a bias gradient over the nodes) differs by a few ulps of its largest
  entry (measured: up to 1.8e-2). ``MPPDEConv(aggr="max")`` on the bf16
  graph is held on its output only: two bf16 messages of one receiver
  within a rounding of each other can swap the arg-max between the two
  packages, which moves a gradient entry by O(1).
- The models the port trains, wrapped whole: ``bf16(MPPDESolver)`` and
  ``bf16(GNOModel)`` forward and gradients, and ``NeuralGraphODE(bf16(
  VMHConv))`` on a fixed-step solve (``adjoint="grid"``), each against
  JAX at 1e-2. An adaptive solve with a bf16 right-hand side is compared
  on its accepted steps and at the solver's tolerance.
"""
import functools
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
from neuralgraphpde.models import GNOModel as JGNOModel  # noqa: E402
from neuralgraphpde.models import MPPDESolver as JMPPDESolver  # noqa: E402
from neuralgraphpde.nn.basic import MLP as JMLP  # noqa: E402
import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.ops import fused as port_fused  # noqa: E402

BF16 = 1e-2  # max |port − JAX| over max |JAX|
BF16_GRAPH_GRAD = 3e-2  # the gradients of a layer on a bf16 graph
N = 40


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
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


def _graphs(ndata, seed=3, n=N, e=200, gdata=None, dtype="f32"):
    """The same random graph (a ring, so that every node receives an edge,
    plus random edges; receivers sorted by ``precompute``) in both
    packages, with ``ndata`` (numpy arrays) in f32 or in bf16."""
    rng = np.random.default_rng(seed)
    s = np.concatenate([np.arange(n), rng.integers(0, n, e)]).astype(
        np.int32)
    r = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, e)]
                       ).astype(np.int32)
    if dtype == "bf16":
        nd_j = {k: jnp.asarray(v).astype(jnp.bfloat16)
                for k, v in ndata.items()}
        nd_p = {k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in ndata.items()}
    else:
        nd_j = {k: jnp.asarray(v) for k, v in ndata.items()}
        nd_p = {k: torch.from_numpy(v) for k, v in ndata.items()}
    gj = J.GnnGraph.from_coo(s, r, num_nodes=n, ndata=nd_j, gdata=gdata)
    gp = P.GnnGraph.from_coo(s, r, num_nodes=n, ndata=nd_p, gdata=gdata)
    return (J.precompute(gj, dense=False, pallas=True, tn=8, te=32),
            P.precompute(gp, dense=False, pallas=True))


# ------------------------------------------------- the JAX package's cases
def test_bf16_forward_close_and_f32_out():
    rng = np.random.default_rng(0)
    _, gp = _graphs({"x": rng.normal(size=(N, 2)).astype(np.float32)})
    inner = P.VMHConv(P.MLP((4, 16, 8), "tanh",
                            generator=torch.Generator().manual_seed(0)),
                      P.MLP((9, 16, 1),
                            generator=torch.Generator().manual_seed(1)))
    model = P.bf16(inner)
    P.update_graph(model, gp)
    x = _t(rng.normal(size=(N, 1)))
    y = model(x)
    assert y.dtype == torch.float32
    # the parameters are the masters: still f32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(y.detach().numpy(), inner(x).detach().numpy(),
                               atol=3e-2, rtol=3e-2)


def test_bf16_gradients_master_dtype():
    rng = np.random.default_rng(1)
    _, gp = _graphs({"x": rng.normal(size=(N, 2)).astype(np.float32)})
    model = P.Precision(P.GCNConv(4, 4, add_self_loops=False,
                                  generator=torch.Generator().manual_seed(1)))
    P.update_graph(model, gp)
    (model(_t(rng.normal(size=(N, 4)))) ** 2).sum().backward()
    grads = [p.grad for p in model.parameters()]
    assert grads and all(g.dtype == torch.float32 for g in grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_bf16_custom_compute_dtype_passthrough():
    """compute_dtype=f32 is an exact no-op wrapper."""
    rng = np.random.default_rng(2)
    _, gp = _graphs({"x": rng.normal(size=(N, 2)).astype(np.float32)})
    inner = P.GCNConv(3, 5, add_self_loops=False,
                      generator=torch.Generator().manual_seed(2))
    model = P.Precision(inner, compute_dtype=torch.float32)
    P.update_graph(model, gp)
    x = _t(rng.normal(size=(N, 3)))
    np.testing.assert_array_equal(model(x).detach().numpy(),
                                  inner(x).detach().numpy())


def test_precision_flattens_its_child_parameters():
    """A single-child container: ``params_from_jax`` copies the wrapped
    layer's own JAX tree, as ``setup`` of JAX's ``Precision`` lays it out."""
    layer_j = J.GCNConv(3, 5, "tanh", add_self_loops=False)
    ps, _ = J.setup(jax.random.PRNGKey(0), J.bf16(layer_j))
    model = P.bf16(P.GCNConv(3, 5, "tanh", add_self_loops=False))
    P.params_from_jax(model, _np(ps))
    np.testing.assert_array_equal(model.layer.weight.detach().numpy(),
                                  np.asarray(ps["weight"]))


# ------------------------------------------------------ layers against JAX
def _gcn(rng):
    return (J.GCNConv(4, 4, "tanh", add_self_loops=False),
            P.GCNConv(4, 4, "tanh", add_self_loops=False), 4,
            {"x": rng.normal(size=(N, 2)).astype(np.float32)}, None)


def _vmh(rng):
    return (J.VMHConv(JMLP((4, 12, 12, 6), "tanh"), JMLP((7, 12, 1))),
            P.VMHConv(P.MLP((4, 12, 12, 6), "tanh"), P.MLP((7, 12, 1))), 1,
            {"x": rng.normal(size=(N, 2)).astype(np.float32)},
            "fused_mlp_aggregate")


def _mppde_max(rng):
    h, k = 6, 3  # hidden, bundle; one position coordinate, no θ
    return (J.MPPDEConv(JMLP((2 * h + k + 1, 8, h), "swish"),
                        JMLP((2 * h, 8, h), "swish"), aggr="max"),
            P.MPPDEConv(P.MLP((2 * h + k + 1, 8, h), "swish"),
                        P.MLP((2 * h, 8, h), "swish"), aggr="max"), h,
            {"u": rng.normal(size=(N, k)).astype(np.float32),
             "x": rng.normal(size=(N, 1)).astype(np.float32)},
            "segment_max_aggregate")


def _gno(rng):
    return (J.GNOConv(3, 4, JMLP((6, 8, 12), "relu"), "tanh"),
            P.GNOConv(3, 4, P.MLP((6, 8, 12), "relu"), "tanh"), 3,
            {"a": rng.normal(size=(N, 1)).astype(np.float32),
             "x": rng.normal(size=(N, 2)).astype(np.float32)},
            "fused_gno_aggregate")


_LAYERS = {"GCNConv": _gcn, "VMHConv": _vmh, "MPPDEConv-max": _mppde_max,
           "GNOConv": _gno}
# where each layer looks its kernel's differentiable call up
_KERNEL_MODULES = {"fused_mlp_aggregate": port_fused,
                   "fused_gno_aggregate": port_fused,
                   "segment_max_aggregate": importlib.import_module(
                       "neuralgraphpde_torch.ops.spmm")}


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("name,graph_dtype", [
    (name, dtype) for name in sorted(_LAYERS) for dtype in ("f32", "bf16")
    if (name, dtype) != ("MPPDEConv-max", "bf16")])
def test_bf16_layer_matches_jax(monkeypatch, name, mode, graph_dtype):
    rng = np.random.default_rng(sorted(_LAYERS).index(name))
    layer_j, layer_p, width, ndata, kernel = _LAYERS[name](rng)
    gj, gp = _graphs(ndata, seed=5, dtype=graph_dtype)
    model_j, model_p = J.bf16(layer_j), P.bf16(layer_p)
    ps, st = J.setup(jax.random.PRNGKey(4), model_j)
    st = J.update_graph(st, gj)
    x = rng.normal(size=(N, width)).astype(np.float32)

    def loss(ps, x):
        y, _ = model_j(x, ps, st)
        return jnp.sum(y ** 2), y

    J.set_spmm_mode(mode)
    try:
        with pltpu.force_tpu_interpret_mode():
            (_, want), (gps, gx) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(x))
    finally:
        J.set_spmm_mode("auto")
    P.params_from_jax(model_p, _np(ps))
    P.update_graph(model_p, gp)
    if kernel is not None:
        calls = _spy(monkeypatch, _KERNEL_MODULES[kernel], kernel)
    xp = _t(x).requires_grad_()
    P.set_spmm_mode(mode)
    try:
        y = model_p(xp)
    finally:
        P.set_spmm_mode("auto")
    if kernel is not None:
        assert bool(calls) == (mode == "pallas")
    (y ** 2).sum().backward()
    bound = BF16 if graph_dtype == "f32" else BF16_GRAPH_GRAD
    assert y.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel(y.detach().numpy(), want) <= BF16
    assert xp.grad.dtype == torch.float32
    assert _rel(xp.grad.numpy(), gx) <= bound
    names = [n for n, _ in model_p.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(gps))
    for pname, p in model_p.named_parameters():
        assert p.grad.dtype == torch.float32, pname
        want_g = _leaf(gps, pname.split(".", 1)[1])
        assert _rel(p.grad.numpy(), want_g) <= bound, pname


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_bf16_max_layer_on_bf16_graph_matches_jax(mode):
    """``bf16(MPPDEConv(aggr="max"))`` on a graph with bf16 node data: bf16
    messages into the segment max (K6's plain version in ``pallas`` mode),
    the output within 1e-2 of JAX's."""
    rng = np.random.default_rng(sorted(_LAYERS).index("MPPDEConv-max"))
    layer_j, layer_p, width, ndata, _ = _mppde_max(rng)
    gj, gp = _graphs(ndata, seed=5, dtype="bf16")
    model_j, model_p = J.bf16(layer_j), P.bf16(layer_p)
    ps, st = J.setup(jax.random.PRNGKey(4), model_j)
    st = J.update_graph(st, gj)
    x = rng.normal(size=(N, width)).astype(np.float32)
    J.set_spmm_mode(mode)
    try:
        with pltpu.force_tpu_interpret_mode():
            want, _ = model_j(jnp.asarray(x), ps, st)
    finally:
        J.set_spmm_mode("auto")
    P.params_from_jax(model_p, _np(ps))
    P.update_graph(model_p, gp)
    P.set_spmm_mode(mode)
    try:
        with torch.no_grad():
            got = model_p(_t(x))
    finally:
        P.set_spmm_mode("auto")
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= BF16


def test_bf16_kernel_operands_follow_jax(monkeypatch):
    """What the fused kernels read under the policy, as in JAX: on an f32
    graph, f32 features with bf16 weights (K3, K5) and f32 messages (K6);
    on a bf16 graph, bf16 throughout."""
    from neuralgraphpde_torch.kernels import fused_mlp_kernels as K3
    from neuralgraphpde_torch.kernels import gno_kernels as K5
    from neuralgraphpde_torch.kernels import segment_kernels as K6

    seen = []

    def spy(module, name, pick):
        orig = getattr(module, name)

        def wrapped(*a, **k):
            seen.append((name, [t.dtype for t in pick(a)]))
            return orig(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    spy(K3, "fused_mlp_plain", lambda a: [a[2], a[3][0]])
    spy(K5, "fused_gno_plain", lambda a: a[2:5])
    spy(K6, "segment_max_plain", lambda a: [a[0]])
    f32, bf = torch.float32, torch.bfloat16
    expect = {"f32": {"VMHConv": [f32, bf], "GNOConv": [f32, bf, bf],
                      "MPPDEConv-max": [f32]},
              "bf16": {"VMHConv": [bf, bf], "GNOConv": [bf, bf, bf],
                       "MPPDEConv-max": [bf]}}
    for graph_dtype, cases in expect.items():
        for name, dtypes in cases.items():
            rng = np.random.default_rng(0)
            _, layer, width, ndata, _ = _LAYERS[name](rng)
            _, gp = _graphs(ndata, dtype=graph_dtype)
            model = P.bf16(layer)
            P.update_graph(model, gp)
            seen.clear()
            P.set_spmm_mode("pallas")
            try:
                with torch.no_grad():
                    model(_t(rng.normal(size=(N, width))))
            finally:
                P.set_spmm_mode("auto")
            assert [d for _, d in seen] == [dtypes], (graph_dtype, name)


# ------------------------------------------------------- models against JAX
def test_bf16_mppde_solver_matches_jax():
    """``bf16(MPPDESolver)`` (K 4, hidden 8, depth 2) on a 1-D chain, its
    convs on the fused K3 path: loss and every master gradient."""
    n, k, h = 32, 4, 8
    rng = np.random.default_rng(8)
    pos = np.linspace(0, 1, n, dtype=np.float32)[:, None]
    s = np.concatenate([np.arange(n), (np.arange(n) + 1) % n])
    r = np.concatenate([(np.arange(n) + 1) % n, np.arange(n)])
    gj = J.precompute(J.GnnGraph.from_coo(s, r, num_nodes=n,
                                          ndata={"x": jnp.asarray(pos)}),
                      dense=False, pallas=True, tn=8, te=32)
    gp = P.precompute(P.GnnGraph.from_coo(s, r, num_nodes=n,
                                          ndata={"x": torch.from_numpy(pos)}),
                      dense=False, pallas=True)
    model_j = J.bf16(JMPPDESolver(bundle=k, hidden=h, depth=2))
    ps, st = J.setup(jax.random.PRNGKey(8), model_j)
    st = J.update_graph(st, gj)
    u = rng.normal(size=(n, k)).astype(np.float32)
    target = rng.normal(size=(n, k)).astype(np.float32)

    def loss(ps):
        y, _ = model_j(jnp.asarray(u), ps, st)
        return jnp.mean((y - target) ** 2)

    J.set_spmm_mode("xla")
    try:
        lj, gps = jax.value_and_grad(loss)(ps)
    finally:
        J.set_spmm_mode("auto")
    model_p = P.bf16(P.MPPDESolver(bundle=k, hidden=h, depth=2))
    P.params_from_jax(model_p, _np(ps))
    P.update_graph(model_p, gp)
    P.set_spmm_mode("pallas")
    try:
        lp = torch.mean((model_p(_t(u)) - _t(target)) ** 2)
    finally:
        P.set_spmm_mode("auto")
    lp.backward()
    assert abs(float(lp) - float(lj)) / abs(float(lj)) <= BF16
    for pname, p in model_p.named_parameters():
        want = _leaf(gps, pname.split(".", 1)[1])
        assert _rel(p.grad.numpy(), want) <= BF16, pname


def test_bf16_gno_model_matches_jax():
    """``bf16(GNOModel)`` (width 4, kernel width 8, depth 2) on a radius
    graph, its convs on the fused K5 path: loss and every master
    gradient."""
    rng = np.random.default_rng(9)
    pts = rng.random((36, 2)).astype(np.float32)
    gj = J.precompute(J.graph.builders.radius_graph(pts, 0.3).replace(
        ndata={"x": jnp.asarray(pts)}), dense=False, pallas=True, tn=8,
        te=32)
    gp = P.radius_graph(pts, 0.3)
    gp = P.precompute(gp.copy(ndata={"x": torch.from_numpy(pts)}),
                      dense=False, pallas=True)
    kw = dict(width=4, ker_width=8, depth=2)
    model_j = J.bf16(JGNOModel(**kw))
    ps, st = J.setup(jax.random.PRNGKey(9), model_j)
    st = J.update_graph(st, gj)
    a = rng.normal(size=(36, 1)).astype(np.float32)
    target = rng.normal(size=(36, 1)).astype(np.float32)

    def loss(ps):
        y, _ = model_j(jnp.asarray(a), ps, st)
        return jnp.mean((y - target) ** 2)

    J.set_spmm_mode("xla")
    try:
        lj, gps = jax.value_and_grad(loss)(ps)
    finally:
        J.set_spmm_mode("auto")
    model_p = P.bf16(P.GNOModel(**kw))
    P.params_from_jax(model_p, _np(ps))
    P.update_graph(model_p, gp)
    P.set_spmm_mode("pallas")
    try:
        lp = torch.mean((model_p(_t(a)) - _t(target)) ** 2)
    finally:
        P.set_spmm_mode("auto")
    lp.backward()
    assert abs(float(lp) - float(lj)) / abs(float(lj)) <= BF16
    for pname, p in model_p.named_parameters():
        want = _leaf(gps, pname.split(".", 1)[1])
        assert _rel(p.grad.numpy(), want) <= BF16, pname


def _node_vmh_pair(adjoint, rng, **kw):
    pos = rng.normal(size=(N, 2)).astype(np.float32)
    gj, gp = _graphs({"x": pos}, seed=7)
    ode = dict(tspan=(0.0, 0.1), saveat=(0.0, 0.05, 0.1), adjoint=adjoint,
               **kw)
    node_j = J.NeuralGraphODE(J.bf16(J.VMHConv(JMLP((4, 12, 12, 6), "tanh"),
                                               JMLP((7, 12, 1)))), **ode)
    node_p = P.NeuralGraphODE(P.bf16(P.VMHConv(P.MLP((4, 12, 12, 6), "tanh"),
                                               P.MLP((7, 12, 1)))), **ode)
    ps, st = J.setup(jax.random.PRNGKey(7), node_j)
    st = J.update_graph(st, gj)
    P.params_from_jax(node_p, _np(ps))
    P.update_graph(node_p, gp)
    return node_j, ps, st, node_p


def test_bf16_node_vmh_grid_solve_matches_jax():
    """``NeuralGraphODE(bf16(VMHConv))`` on a fixed-step RK4 solve (8 steps
    per save interval): the state stays f32, the right-hand side computes
    in bf16. Loss and every master gradient at 1e-2."""
    rng = np.random.default_rng(10)
    node_j, ps, st, node_p = _node_vmh_pair("grid", rng, solver="rk4")
    x = rng.normal(size=(N, 1)).astype(np.float32)

    def loss(ps):
        y, _ = node_j(jnp.asarray(x), ps, st)
        return jnp.mean(y ** 2)

    J.set_spmm_mode("xla")
    try:
        lj, gps = jax.value_and_grad(loss)(ps)
    finally:
        J.set_spmm_mode("auto")
    P.set_spmm_mode("pallas")
    try:
        ys = node_p(_t(x))
        lp = torch.mean(ys ** 2)
    finally:
        P.set_spmm_mode("auto")
    assert ys.dtype == torch.float32
    lp.backward()
    assert abs(float(lp) - float(lj)) / abs(float(lj)) <= BF16
    for pname, p in node_p.named_parameters():
        want = _leaf(gps, pname.split(".", 2)[2])
        assert _rel(p.grad.numpy(), want) <= BF16, pname


def test_bf16_node_vmh_adaptive_steps_match_jax():
    """The adaptive solve with a bf16 right-hand side (Tsit5, the VMH
    tolerances rtol 1e-5 / atol 1e-3): bf16 rounding enters the embedded
    error estimate, so the check is the accepted steps of JAX's tstop
    solve (``solve_stats``) and the saves within 1e-2."""
    rng = np.random.default_rng(11)
    tol = dict(rtol=1e-5, atol=1e-3)
    node_j, ps, st, node_p = _node_vmh_pair("checkpoint", rng,
                                            interpolation="tstop", **tol)
    x = rng.normal(size=(N, 1)).astype(np.float32)
    model_j, model_st = node_j.model, st["model"]

    def rhs(t, u, p):
        return model_j(u, p, model_st)[0]

    J.set_spmm_mode("xla")
    try:
        ys_j, attempts = J.ode.solve_stats(rhs, jnp.asarray(x),
                                           jnp.asarray(node_j.saveat), ps,
                                           **tol)
    finally:
        J.set_spmm_mode("auto")
    P.set_spmm_mode("pallas")
    try:
        with torch.no_grad():
            ys_p, attempts_p = P.solve_stats(
                lambda t, u, _: node_p.model(u), _t(x), node_p.saveat, **tol)
    finally:
        P.set_spmm_mode("auto")
    assert attempts_p.tolist() == np.asarray(attempts).tolist()
    assert _rel(ys_p.numpy(), ys_j) <= BF16
