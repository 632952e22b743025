"""GRAND training: the port against the JAX package on the CPU.

``masked_cross_entropy`` and ``accuracy`` on the same arrays; GRAND's loss
and parameter gradients against ``jax.grad`` on every storage the SpMM
dispatch can hold (dense adjacency, the segment kernel's CSR, DIA, DIA with
a COO remainder, dense and packed block bands), with the JAX parameters
copied by ``params_from_jax``. The JAX side runs its exact gather/scatter
path (``set_spmm_mode("xla")``); the port runs the path under test, whose
kernels take their plain versions here, with the kernels' VJPs
(``autograd.Function``s) in the backward. Solver tolerance 1e-6: both
sides accept the same steps, loss within rel 1e-5, each gradient within
1e-4 of its largest entry (at 1e-5 the step sizes, set from error ratios
at f32 rounding level, still move the gradients by up to 4e-4 of their
largest entry over three steps, the dense path's included; at 1e-6 by at
most 3e-5). Then the ported ``train_grand_cora`` for a few
epochs: the loss falls, and its first loss equals JAX's at the same
parameters (rel 1e-4: dopri5 at the script's rtol 1e-3, where a change of
summation order moves later step sizes).
"""
import importlib

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
from neuralgraphpde.graph import reorder as jro  # noqa: E402
from neuralgraphpde.models import grand_model as jax_grand  # noqa: E402
from neuralgraphpde.train import losses as jl  # noqa: E402
import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.examples import train_grand_cora as T  # noqa: E402
from neuralgraphpde_torch.ops import fused as port_fused  # noqa: E402

port_spmm = importlib.import_module("neuralgraphpde_torch.ops.spmm")
LOSS, GRAD = 1e-5, 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(50, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 50).astype(np.int32)
    for mask in (rng.random(50) < 0.3, np.zeros(50, bool)):
        args_j = (jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
        args_p = (torch.from_numpy(logits), torch.from_numpy(labels),
                  torch.from_numpy(mask))
        np.testing.assert_allclose(
            float(P.masked_cross_entropy(*args_p)),
            float(jl.masked_cross_entropy(*args_j)), rtol=1e-6)
        assert float(P.accuracy(*args_p)) == float(jl.accuracy(*args_j))
    lt = torch.from_numpy(logits).requires_grad_()
    P.masked_cross_entropy(lt, *args_p[1:]).backward()
    want = jax.grad(jl.masked_cross_entropy)(*args_j)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want), atol=1e-7)


def _graphs(storage):
    """(JAX graph, port graph, node count, permutation or None, port
    mode, the cache key the storage lives under)."""
    if storage in ("dense", "tcsr"):
        kw = dict(num_nodes=400, num_edges=1600, num_features=8, seed=3)
        gj, gp = jax_cora(**kw).graph, P.synthetic_cora(**kw).graph
        pre = dict(add_self_loops=True, dense=storage == "dense",
                   pallas=storage == "tcsr")
        mode, key = ("auto", "adj") if storage == "dense" else ("pallas",
                                                                "tcsr")
    elif storage in ("dia", "dia_rem"):
        kw = dict(diagonals=True, periodic=storage == "dia_rem")
        gj, gp = J.grid_graph_2d(24, 20, **kw), P.grid_graph_2d(24, 20, **kw)
        pre = dict(add_self_loops=True, dense=False, pallas=False, bsr=True)
        mode = "bsr"
        key = "dia_norm" if storage == "dia" else "dia_rem"
    else:
        pts = np.random.default_rng(0).random(
            (2000 if storage == "pbanded" else 1200, 2)).astype(np.float32)
        gj, gp = J.delaunay_graph(pts), P.delaunay_graph(pts)
        pre = dict(add_self_loops=True, dense=False, auto_reorder=True)
        mode, key = "bsr", storage + "_norm"
    cj, cp = J.precompute(gj, **pre), P.precompute(gp, **pre)
    assert key in cp.cache and sorted(cp.cache) == sorted(cj.cache)
    order = cp.cache.get("node_order")
    return cj, cp, gj.num_nodes, None if order is None else order.numpy(), \
        mode, key


@pytest.mark.parametrize("storage", ["dense", "tcsr", "dia", "dia_rem",
                                     "banded", "pbanded"])
def test_grand_gradients_match_jax(monkeypatch, storage):
    """The masked cross-entropy of ``grand_model(8, 8, 3)`` and its
    gradient with respect to every parameter. On the meshes the node ids
    changed (``auto_reorder``): features, labels and the mask are permuted
    with ``permute_nodes``, and the logits map back with
    ``unpermute_nodes``."""
    cj, cp, n, order, mode, key = _graphs(storage)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    mask = rng.random(n) < 0.1
    if order is not None:
        x, labels, mask = (jro.permute_nodes(a, order)
                           for a in (x, labels, mask))
    solve = dict(rtol=1e-6, atol=1e-6, precomputed_self_loops=True)
    mj = jax_grand(8, 8, 3, **solve)
    ps, st = J.setup(jax.random.PRNGKey(0), mj)
    st = J.update_graph(st, cj)

    def loss_j(p):
        return jl.masked_cross_entropy(mj(jnp.asarray(x), p, st)[0],
                                       jnp.asarray(labels), jnp.asarray(mask))

    J.set_spmm_mode("xla")
    try:
        want_loss, want_g = jax.jit(jax.value_and_grad(loss_j))(ps)
    finally:
        J.set_spmm_mode("auto")
    model = P.grand_model(8, 8, 3, **solve)
    P.params_from_jax(model, jax.tree_util.tree_map(np.asarray, ps))
    P.update_graph(model, cp)
    calls = []
    for module, name in ((port_fused, "dia_gcn_rhs"),
                         (port_fused, "banded_gcn_rhs"),
                         (port_fused, "pbanded_gcn_rhs"),
                         (port_spmm, "dia_spmm_stencil"),
                         (port_spmm, "segment_spmm")):
        orig = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    P.set_spmm_mode(mode)
    try:
        logits = model(torch.from_numpy(x))
        loss = P.masked_cross_entropy(logits, torch.from_numpy(labels),
                                      torch.from_numpy(mask))
        loss.backward()
    finally:
        P.set_spmm_mode("auto")
    expect = {"dense": set(), "tcsr": {"segment_spmm"},
              "dia": {"dia_gcn_rhs"}, "dia_rem": {"dia_spmm_stencil"},
              "banded": {"banded_gcn_rhs"},
              "pbanded": {"pbanded_gcn_rhs"}}[storage]
    assert set(calls) == expect, calls
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= LOSS * abs(float(want_loss))
    # JAX's gradient tree, laid out on the port's parameters
    want_p = P.params_from_jax(P.grand_model(8, 8, 3, **solve),
                               jax.tree_util.tree_map(np.asarray, want_g))
    for (name, p), ref in zip(model.named_parameters(),
                              want_p.parameters()):
        assert p.grad is not None, name
        assert _rel(p.grad.numpy(), ref.detach().numpy()) <= GRAD, name
    if order is not None:  # logits back in the original numbering
        back = P.unpermute_nodes(logits.detach(), order)
        np.testing.assert_array_equal(back.numpy()[order],
                                      logits.detach().numpy())


def test_train_grand_cora_short():
    """Three epochs of the ported trainer on a 300-node synthetic Cora: the
    first loss equals JAX's at the same parameters, and the loss after the
    third step is lower."""
    cfg = T.Config(num_nodes=300, num_edges=1200, num_features=64, epochs=3)
    model, tensors = T.setup(cfg, "cpu")
    data = jax_cora(num_nodes=300, num_edges=1200, num_features=64,
                    num_classes=7, seed=0)
    gj = J.precompute(J.add_self_loops(data.graph))
    assert sorted(model.layer_1.graph.cache) == sorted(gj.cache)
    mj = jax_grand(64, 64, 7, solver="dopri5", rtol=1e-3, atol=1e-3,
                   precomputed_self_loops=True)
    ps, st = J.setup(jax.random.PRNGKey(0), mj)
    st = J.update_graph(st, gj)
    want = float(jl.masked_cross_entropy(
        mj(jnp.asarray(data.features), ps, st)[0],
        jnp.asarray(data.labels), jnp.asarray(data.train_mask)))
    P.params_from_jax(model, jax.tree_util.tree_map(np.asarray, ps))
    history = T.train(model, tensors, cfg).history
    assert [rec["step"] for rec in history] == [1]
    assert abs(history[0]["loss"] - want) <= 1e-4 * want
    x, y, train_m, _ = tensors
    with torch.no_grad():
        after = float(P.masked_cross_entropy(model(x), y, train_m))
    assert after < history[0]["loss"]


def test_load_cora_matches_jax(tmp_path):
    """The LINQS reader on a small pair of files (one of them gzipped):
    the same features, labels, split and mirrored edges as JAX's, and
    ``cora_dataset`` with a path reads them."""
    import gzip

    from neuralgraphpde.data import loaders as jld

    rng = np.random.default_rng(4)
    ids = [f"p{i}" for i in range(60)]
    labels = rng.choice(["Theory", "Rule", "Neural"], 60)
    with open(tmp_path / "cora.content", "w") as f:
        for pid, lab in zip(ids, labels):
            words = "\t".join(str(v) for v in rng.integers(0, 2, 6))
            f.write(f"{pid}\t{words}\t{lab}\n")
    with gzip.open(tmp_path / "cora.cites.gz", "wt") as f:
        for _ in range(150):
            a, b = rng.choice(ids, 2)
            f.write(f"{a}\t{b}\n")
        f.write("p0\tmissing\n")
    kw = dict(n_train_per_class=5, n_val=10, n_test=20)
    dj = jld.load_cora(str(tmp_path), **kw)
    dp = P.load_cora(str(tmp_path), **kw)
    for field in ("features", "labels", "train_mask", "val_mask",
                  "test_mask"):
        np.testing.assert_array_equal(getattr(dp, field), getattr(dj, field))
    assert dp.num_classes == dj.num_classes == 3
    np.testing.assert_array_equal(dp.graph.senders.numpy(),
                                  np.asarray(dj.graph.senders))
    np.testing.assert_array_equal(dp.graph.receivers.numpy(),
                                  np.asarray(dj.graph.receivers))
    np.testing.assert_array_equal(
        P.cora_dataset(str(tmp_path)).features, dp.features)
