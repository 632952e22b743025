"""Graph layer of the port against the JAX package: builders, synthetic
Cora, transforms, ``GnnGraph``, segment reductions, ``precompute``'s
cache and path choice, and ``aggregate_neighbors``' max/min dispatch.
Host-built arrays must be identical; reductions agree to f32 rounding
(rtol 1e-6, atol 1e-6); a max or min is exact."""
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
from neuralgraphpde.data import synthetic_cora as jax_cora  # noqa: E402
from neuralgraphpde.models import grand_model as jax_grand  # noqa: E402
from neuralgraphpde.ops.scatter import segment_reduce as jax_reduce  # noqa
import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.ops import fused as port_fused  # noqa: E402
from neuralgraphpde_torch.ops.scatter import segment_reduce  # noqa: E402

port_spmm = importlib.import_module("neuralgraphpde_torch.ops.spmm")
jax_spmm = importlib.import_module("neuralgraphpde.ops.spmm")
jax_dia_kernels = importlib.import_module("neuralgraphpde.kernels.dia_kernels")
jax_seg_kernels = importlib.import_module(
    "neuralgraphpde.kernels.segment_kernels")
jax_dia = importlib.import_module("neuralgraphpde.ops.dia")

CLOSE = dict(rtol=1e-6, atol=1e-6)


def _same_coo(gj, gp):
    assert (gp.num_nodes, gp.num_edges) == (gj.num_nodes, gj.num_edges)
    np.testing.assert_array_equal(gp.senders.numpy(), np.asarray(gj.senders))
    np.testing.assert_array_equal(gp.receivers.numpy(),
                                  np.asarray(gj.receivers))
    assert gp.receivers_sorted == gj.receivers_sorted


@pytest.mark.parametrize("name,args,kw", [
    ("rand_graph", (50, 300), dict(seed=3)),
    ("rand_graph", (64, 200), dict(seed=4, bidirected=True)),
    ("grid_graph_2d", (7, 5), dict()),
    ("grid_graph_2d", (6, 9), dict(diagonals=True)),
    ("grid_graph_2d", (8, 4), dict(periodic=True, diagonals=True)),
    ("grid_graph_1d", (9,), dict()),
    ("grid_graph_1d", (16,), dict(periodic=True, stencil=2)),
    ("grid_graph_1d", (7,), dict(stencil=3)),
])
def test_builders_identical(name, args, kw):
    _same_coo(getattr(J, name)(*args, **kw), getattr(P, name)(*args, **kw))


def test_synthetic_cora_identical():
    kw = dict(num_nodes=300, num_edges=1200, num_features=70, seed=5)
    dj, dp = jax_cora(**kw), P.synthetic_cora(**kw)
    _same_coo(dj.graph, dp.graph)
    for field in ("features", "labels", "train_mask", "val_mask",
                  "test_mask"):
        np.testing.assert_array_equal(getattr(dp, field), getattr(dj, field))


def test_transforms_identical():
    gj = J.rand_graph(40, 160, seed=1)
    gp = P.rand_graph(40, 160, seed=1)
    _same_coo(J.add_self_loops(gj), P.add_self_loops(gp))
    w = np.random.default_rng(1).random(160).astype(np.float32)
    np.testing.assert_allclose(
        P.degree(gp, edge_weight=torch.from_numpy(w)).numpy(),
        np.asarray(J.degree(gj, edge_weight=jnp.asarray(w))), **CLOSE)
    np.testing.assert_array_equal(
        P.degree(gp, direction="out").numpy(),
        np.asarray(J.degree(gj, direction="out")))
    sj, perm_j = J.sort_by_receiver(gj, return_perm=True)
    sp, perm_p = P.sort_by_receiver(gp, return_perm=True)
    _same_coo(sj, sp)
    np.testing.assert_array_equal(perm_p, perm_j)
    np.testing.assert_array_equal(P.csr_offsets(sp).numpy(),
                                  np.asarray(J.csr_offsets(sj)))
    np.testing.assert_array_equal(P.to_dense_adjacency(gp).numpy(),
                                  np.asarray(J.to_dense_adjacency(gj)))


def test_gnngraph_from_coo_copy_to():
    s, r = [2, 0, 1, 0], [1, 2, 0, 0]
    e = np.arange(4, dtype=np.float32)
    gj = J.GnnGraph.from_coo(s, r, edata=e, sort_by_receiver=True)
    gp = P.GnnGraph.from_coo(s, r, edata=e, sort_by_receiver=True)
    _same_coo(gj, gp)
    np.testing.assert_array_equal(gp.edata["e"].numpy(),
                                  np.asarray(gj.edata["e"]))
    gc = P.precompute(gp, dense=True, pallas=True).copy(ndata=np.ones(3))
    assert gc.ndata["x"].shape == (3, 1) and "tcsr" in gc.cache
    moved = gc.to("cpu")
    assert moved.cache["tcsr"].col.device.type == "cpu"
    assert moved.host_coo is gc.host_coo


@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "min", "prod"])
def test_segment_reduce_matches_jax(aggr):
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(90, 3)).astype(np.float32)
    ids = rng.integers(0, 25, 90).astype(np.int32)  # some segments empty
    want = np.asarray(jax_reduce(jnp.asarray(vals), jnp.asarray(ids), 30,
                                 aggr))
    got = segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids), 30,
                         aggr).numpy()
    np.testing.assert_allclose(got, want, **CLOSE)


def _grid(nx=40, ny=30, **kw):
    return (J.grid_graph_2d(nx, ny, diagonals=True, **kw),
            P.grid_graph_2d(nx, ny, diagonals=True, **kw))


_GRAPHS = {
    "cora_dense": lambda: (jax_cora(num_nodes=512, num_edges=2048,
                                    num_features=8).graph,
                           P.synthetic_cora(num_nodes=512, num_edges=2048,
                                            num_features=8).graph),
    "rand_k1": lambda: (J.rand_graph(2048, 8192, seed=0),
                        P.rand_graph(2048, 8192, seed=0)),
    "grid": _grid,
}


@pytest.mark.parametrize("graph,kw", [
    ("cora_dense", dict(add_self_loops=True)),
    ("cora_dense", dict(add_self_loops=True, dense=False, pallas=True)),
    ("rand_k1", dict(add_self_loops=True)),
    ("grid", dict(add_self_loops=True, dense=False)),  # fused: dia_norm
    ("grid", dict(dense=False)),  # examples' pattern: unfused dia
    ("grid", dict(add_self_loops=True, dense=False, gcn_fused=False)),
])
def test_precompute_cache_matches_jax(graph, kw):
    gj, gp = _GRAPHS[graph]()
    cj, cp = J.precompute(gj, **kw), P.precompute(gp, **kw)
    assert sorted(cp.cache) == sorted(cj.cache)
    _same_coo(cj, cp)
    for key in ("in_degree", "adj", "csr_offsets", "orig_edge_pos"):
        if key in cj.cache:
            np.testing.assert_array_equal(cp.cache[key].numpy(),
                                          np.asarray(cj.cache[key]))
    for key in ("dia", "dia_rev", "dia_norm", "dia_norm_rev"):
        if key in cj.cache:
            assert cp.cache[key].offsets == cj.cache[key].offsets
            np.testing.assert_array_equal(cp.cache[key].values.numpy(),
                                          np.asarray(cj.cache[key].values))


def test_precompute_divergence_hybrid_dia():
    """A periodic grid is almost-DIA: both packages attach the hybrid
    stencil + COO remainder (``dia``, ``dia_rev``, ``dia_rem``) with the
    same arrays, and no normalized stencil (the remainder does not ride the
    fused kernel)."""
    gj, gp = (J.grid_graph_2d(64, 48, periodic=True),
              P.grid_graph_2d(64, 48, periodic=True))
    kw = dict(dense=False, bsr=True)
    cj, cp = J.precompute(gj, **kw), P.precompute(gp, **kw)
    assert sorted(cp.cache) == sorted(cj.cache)
    assert {"dia", "dia_rev", "dia_rem", "tcsr"} <= set(cp.cache)
    for key in ("dia", "dia_rev"):
        assert cp.cache[key].offsets == cj.cache[key].offsets
        np.testing.assert_array_equal(cp.cache[key].values.numpy(),
                                      np.asarray(cj.cache[key].values))
    for a, b in zip(cp.cache["dia_rem"], cj.cache["dia_rem"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _path_spies(monkeypatch):
    """Record which aggregation each package runs for one GCNConv call."""
    calls = []

    def spy(module, name, label, interpret=False):
        orig = getattr(module, name)

        def wrapped(*a, **k):
            calls.append(label)
            if interpret:
                with pltpu.force_tpu_interpret_mode():
                    return orig(*a, **k)
            return orig(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    spy(jax_dia_kernels, "dia_gcn_rhs", "jax:fused", interpret=True)
    spy(jax_dia_kernels, "dia_spmm_pallas", "jax:stencil", interpret=True)
    spy(jax_dia, "dia_spmm", "jax:stencil")
    spy(jax_seg_kernels, "tiled_segment_spmm", "jax:k1", interpret=True)
    spy(jax_spmm, "spmm_xla", "jax:xla")
    spy(jax_spmm, "spmm_dense", "jax:dense")
    spy(port_fused, "dia_gcn_rhs", "port:fused")
    spy(port_spmm, "dia_spmm_stencil", "port:stencil")
    spy(port_spmm, "segment_spmm", "port:k1")
    spy(port_spmm, "spmm_xla", "port:xla")
    spy(port_spmm, "spmm_dense", "port:dense")
    return calls


@pytest.mark.parametrize("graph,mode", [
    ("grid", "auto"), ("grid", "bsr"), ("grid", "pallas"), ("grid", "xla"),
    ("rand", "auto"), ("rand", "pallas"), ("rand", "xla"),
    ("rand_dense", "auto"), ("rand_dense", "pallas")])
def test_gcnconv_path_choice_matches_jax(monkeypatch, graph, mode):
    """On the CPU both packages pick the same aggregation for each mode
    (JAX's TPU-only gates are false there, as the port's card-only gates
    are for CPU tensors)."""
    if graph == "grid":
        gj, gp = _grid()
        kw = dict(add_self_loops=True, dense=False)
    else:
        gj, gp = J.rand_graph(1100, 4400, seed=2), P.rand_graph(1100, 4400,
                                                                seed=2)
        kw = dict(add_self_loops=True, dense=graph == "rand_dense")
    cj, cp = J.precompute(gj, **kw), P.precompute(gp, **kw)
    layer_j = J.GCNConv(6, 6, "tanh", add_self_loops=False)
    ps, st = J.setup(jax.random.PRNGKey(0), layer_j)
    st = J.update_graph(st, cj)
    layer_p = P.update_graph(P.GCNConv(6, 6, "tanh", add_self_loops=False),
                             cp)
    x = np.random.default_rng(3).normal(size=(gj.num_nodes, 6)).astype(
        np.float32)
    calls = _path_spies(monkeypatch)
    J.set_spmm_mode(mode)
    P.set_spmm_mode(mode)
    try:
        layer_j(jnp.asarray(x), ps, st)
        with torch.no_grad():
            layer_p(torch.from_numpy(x))
    finally:
        J.set_spmm_mode("auto")
        P.set_spmm_mode("auto")
    jax_calls = [c.split(":")[1] for c in calls if c.startswith("jax")]
    port_calls = [c.split(":")[1] for c in calls if c.startswith("port")]
    assert jax_calls and port_calls == jax_calls, calls


def test_update_graph_and_params_from_jax():
    gp = P.precompute(P.add_self_loops(P.rand_graph(20, 60, seed=0)))
    model = P.grand_model(5, 4, 3, precomputed_self_loops=True)
    P.update_graph(model, gp)
    convs = [m for m in model.modules() if isinstance(m, P.GCNConv)]
    assert len(convs) == 3 and all(c.graph is gp for c in convs)
    ps, _ = J.setup(jax.random.PRNGKey(1), jax_grand(5, 4, 3))
    tree = jax.tree_util.tree_map(np.asarray, ps)
    P.params_from_jax(model, tree)
    np.testing.assert_array_equal(
        model.layer_2.model.layer_2.weight.detach().numpy(),
        tree["layer_2"]["layer_2"]["weight"])
    del tree["layer_3"]["bias"]
    with pytest.raises(KeyError):
        P.params_from_jax(model, tree)


def test_precompute_weights_follow_the_receiver_sort():
    """``edge_weight`` arrives in the caller's edge order; precompute sorts
    the edges by receiver and must move the weights with them. The JAX
    package does not (``ops/spmm.py``: its ``in_degree`` and tiled layouts
    read the unsorted weights), so the port is held to the weighted degree
    of the unsorted graph, not to JAX's cache."""
    gj, gp = J.rand_graph(30, 120, seed=5), P.rand_graph(30, 120, seed=5)
    w = np.random.default_rng(0).random(120).astype(np.float32)
    want = np.asarray(J.degree(gj, edge_weight=jnp.asarray(w)))
    cp = P.precompute(gp, dense=True, pallas=True, edge_weight=w)
    np.testing.assert_allclose(cp.cache["in_degree"].numpy(), want, **CLOSE)
    x = np.random.default_rng(1).normal(size=(30, 4)).astype(np.float32)
    want_spmm = np.asarray(jax_spmm.spmm_xla(gj, jnp.asarray(x),
                                             jnp.asarray(w)))
    got = port_spmm.spmm_pallas(cp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want_spmm, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sort", [True, False])
def test_aggregate_neighbors_max_min_matches_jax(monkeypatch, sort):
    """In ``pallas`` mode max and min take the segment-max kernel (K6's
    plain version on the CPU) on a receiver-sorted graph, and JAX's Pallas
    kernel (interpret mode) on the same graph; both give the scatter
    reference's values exactly, −inf / +inf on empty receivers included.
    A graph whose edges are not sorted by receiver (``csr=False`` keeps the
    builder's order) takes the scatter path in both packages (JAX's
    guard)."""
    rng = np.random.default_rng(2)
    n, e, f = 64, 400, 12
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n - 4, e).astype(np.int32)  # 4+ empty receivers
    kw = dict(dense=False, pallas=True, csr=sort)
    gj = J.precompute(J.GnnGraph.from_coo(s, r, num_nodes=n), tn=8, te=64,
                      **kw)
    gp = P.precompute(P.GnnGraph.from_coo(s, r, num_nodes=n), **kw)
    _same_coo(gj, gp)
    assert gp.receivers_sorted == sort
    monkeypatch.setattr(jax_spmm, "_pallas_available", lambda: True)
    calls = []
    orig = port_spmm.segment_max_aggregate

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(port_spmm, "segment_max_aggregate", spy)
    m = rng.normal(size=(e, f)).astype(np.float32)
    P.set_spmm_mode("pallas")
    try:
        for aggr in ("max", "min"):
            with pltpu.force_tpu_interpret_mode():
                want = np.asarray(J.aggregate_neighbors(gj, aggr,
                                                        jnp.asarray(m)))
            got = P.aggregate_neighbors(gp, aggr, torch.from_numpy(m))
            ref = segment_reduce(torch.from_numpy(m), gp.receivers, n, aggr)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got.numpy(), ref.numpy())
            assert np.isinf(got.numpy()[n - 4:]).all()
    finally:
        P.set_spmm_mode("auto")
    assert len(calls) == (2 if sort else 0)
