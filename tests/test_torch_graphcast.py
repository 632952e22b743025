"""GraphCast on the port (``GraphCast``, ``InteractionConv``, ``LayerNorm``,
``adamw``) on the CPU at a small size (refinement 2, a 19 × 36 grid, latent
16, 2 processor layers), against the plain reference of the benchmark's
``graphcast-0p25`` configuration (``bench_torch/reference/
graphcast-0p25.py``) on the traffic generator's graphs and seeded random
weights (every leaf drawn, the LayerNorms' too).

Tolerances and why:

- forward and loss: within 1e-5 of the largest value (the split first
  layer, ``W_e e + (W_s v_s)[s] + (W_r v_r)[r]``, against the
  reference's product of the concatenation: the same sums in another
  order);
- gradients: each leaf within 1e-4 of its largest entry (sums over every
  edge and node in another order);
- AdamW steps: each step's loss within 1e-5 (relative), each leaf's
  change within 1e-3 of its largest entry (Adam's first update is about
  ``lr · sign(g)`` where ``|g| ≫ ε``, so an entry whose gradient is within
  rounding of zero may move ±lr in opposite directions);
- recomputation against the plain call: the same bits, forward and
  gradients (the same operations on the same rows); in receiver blocks:
  the forward within 1e-6 of its largest value (a block's products run on
  fewer rows, which BLAS may sum otherwise), gradients within 1e-5 of each
  leaf's largest entry (the blocks' cotangents of the sender term are
  summed block by block; measured ≤ 3.1e-6);
- one AdamW step: the loss within 1e-5 and the step's numbers by the
  benchmark's measure (``compare.training``) within 1e-4 (a single first
  step moves an entry by ``lr · g / (|g| + ε)``, which rounding moves
  where ``|g|`` is near ``ε``, so entries are not compared one by one);
- ``adamw`` against the reference's AdamW: 1e-6 of each parameter's
  largest entry over three steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.models import graphcast as gc  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench_torch.core import cell as cells  # noqa: E402
from bench_torch.core import compare  # noqa: E402
from bench_torch.core import train as bench_train  # noqa: E402
from bench_torch.core.cell import draw_weights  # noqa: E402
from bench_torch.reference.adamw import AdamW  # noqa: E402

CPU = torch.device("cpu")
PROG = cells.load_module(cells.HERE / "configs" / "graphcast-0p25.py")
REF = cells.load_module(cells.HERE / "reference" / "graphcast-0p25.py")
CFG = {**cells.read_json(cells.HERE / "configs" / "graphcast-0p25.json"),
       "latent": 16, "processor_layers": 2, "blocks": {"grid2mesh": 2,
                                                        "mesh2grid": 3}}
SPEC = dict(splits=2, n_lat=19, n_lon=36, radius_fraction=0.6,
            mesh_nodes=162, mesh_edges=1260, grid2mesh_edges=1236,
            mesh2grid_edges=2052, inputs=CFG["grid_in"],
            targets=CFG["grid_out"])
TRAFFIC = {"task": "train", "samples": 3, "episode_steps": 3,
           "weights_seed": 0, "graphcast": SPEC}


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.fixture(scope="module")
def setup():
    data = PROG.make_data(CFG, TRAFFIC, 2 ** 31 + 22, CPU)
    spec = PROG.weight_spec(CFG, data)
    weights = draw_weights(spec, 5, CPU)
    gen = torch.Generator().manual_seed(7)
    for name, shape, kind in spec:  # no leaf left at zero
        if kind == "zeros":
            weights[name] = 0.1 * torch.randn(shape, generator=gen)
    return data, weights


def _model(data, weights, recompute=False, blocks=(1, 1)):
    spec = data["spec"]
    graphs = P.graphcast_graphs(spec["splits"], spec["n_lat"],
                                spec["n_lon"], spec["radius_fraction"])
    model = P.GraphCast(CFG["grid_in"], CFG["grid_out"], CFG["latent"],
                        CFG["processor_layers"], recompute=recompute)
    model.set_graphs(gc.precompute_graphs(graphs, blocks))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name] + float(name.endswith(PROG.LN_SCALE)))
    return model


def _ref_params(weights):
    return {k: (v.clone() + float(k.endswith("layer_3.weight")))
            .requires_grad_() for k, v in weights.items()}


def test_weight_spec_names_every_parameter(setup):
    data, weights = setup
    model = _model(data, weights)
    spec = PROG.weight_spec(CFG, data)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: s for n, s, _ in spec}


def test_published_size_has_its_parameter_count():
    with torch.device("meta"):
        model = P.GraphCast()
    # latent 512, 16 layers: ~35.6 M from the published widths (the paper: 36.7 M)
    assert sum(p.numel() for p in model.parameters()) == 35_580_643


def test_forward_matches_the_reference(setup):
    data, weights = setup
    model = _model(data, weights)
    x = data["inputs"][0]
    got = model(x)
    want = REF.forward(CFG, _ref_params(weights), x,
                       REF._graphs(data, CPU))
    assert got.shape == (data["num_grid"], CFG["grid_out"])
    assert _rel(got, want) <= 1e-5


def test_loss_gradients_and_steps_match_the_reference(setup):
    data, weights = setup
    prog = PROG.train_program(CFG, data, CPU, weights)
    checked = bench_train.first_steps(prog)
    ref = REF.train(CFG, data, weights, 3, CPU)
    for a, b in zip(checked["losses"], ref["losses"]):
        assert abs(a - b) / abs(b) <= 1e-5
    assert set(checked["grads"]) == set(ref["grads"])
    for k in ref["grads"]:
        assert _rel(checked["grads"][k], ref["grads"][k]) <= 1e-4, k
    for k in ref["change"]:
        assert _rel(checked["change"][k], ref["change"][k]) <= 1e-3, k
    numbers = compare.training(checked, ref)
    assert all(v <= 1e-3 for v in numbers.values()), numbers


def test_one_adamw_step_matches_the_reference(setup):
    data, weights = setup
    prog = PROG.train_program(CFG, data, CPU, weights)
    before = {k: p.detach().clone() for k, p in prog.params.items()}
    loss, forwards = prog.step()
    ref = REF.train(CFG, data, weights, 1, CPU)
    got = dict(losses=[float(loss)], grads=prog.first_grads(),
               change={k: p.detach() - before[k]
                       for k, p in prog.params.items()})
    numbers = compare.training(got, ref)
    assert numbers["loss_gap"] <= 1e-5
    assert max(numbers.values()) <= 1e-4, numbers
    # 4 interaction networks forward, each recomputed once
    assert forwards == 8


def test_recomputed_blocks_match_the_plain_call(setup):
    data, weights = setup
    x = data["inputs"][1]
    runs = []
    for recompute, blocks in ((False, (1, 1)), (True, (1, 1)),
                              (True, (2, 3))):
        model = _model(data, weights, recompute, blocks)
        counts = (gc.interaction_forwards, gc.chunks, gc.recomputed_blocks)
        out = model(x)
        (out ** 2).mean().backward()
        runs.append((out.detach(), {n: p.grad for n, p in
                                    model.named_parameters()},
                     [b - a for a, b in zip(counts, (
                         gc.interaction_forwards, gc.chunks,
                         gc.recomputed_blocks))]))
    (out0, g0, c0), (out1, g1, c1), (out2, g2, c2) = runs
    assert c0 == [4, 0, 0]  # forwards, chunks, recomputed units
    assert c1 == [8, 0, 4]
    assert c2 == [8, 5, 7]  # 2 + 3 blocks, each recomputed; 2 processor
    assert torch.equal(out1, out0) and _rel(out2, out0) <= 1e-6
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k
        assert _rel(g2[k], g0[k]) <= 1e-5, k


def test_recomputation_is_spanned():
    """Every recomputed unit runs in an ``ngpde.recompute`` span, and the
    model's parts and its convs in theirs."""
    gr = P.graphcast_graphs(1, 7, 12)
    model = P.GraphCast(10, 3, 8, 2, recompute=True,
                        generator=torch.Generator().manual_seed(0))
    model.set_graphs(gc.precompute_graphs(gr, (2, 2)))
    x = torch.randn(84, 10)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x).sum().backward()
    names = [e.name for e in prof.events()]
    assert names.count("ngpde.recompute") == 2 + 2 + 2
    assert names.count("ngpde.conv.InteractionConv") == 4
    for part in ("encoder", "processor", "decoder"):
        assert names.count(f"ngpde.graphcast.{part}") == 1
    assert names.count("ngpde.dispatch.scatter") == 2 + 2 + 2 + 2 + 2 + 2


def test_inference_runs_no_checkpoint():
    gr = P.graphcast_graphs(1, 7, 12)
    model = P.GraphCast(10, 3, 8, 1, recompute=True,
                        generator=torch.Generator().manual_seed(0))
    model.set_graphs(gc.precompute_graphs(gr, (2, 2)))
    x = torch.randn(84, 10)
    before = gc.recomputed_blocks
    with torch.no_grad():
        a = model(x)
    model_plain = P.GraphCast(10, 3, 8, 1,
                              generator=torch.Generator().manual_seed(0))
    model_plain.set_graphs(gc.precompute_graphs(gr))
    assert _rel(a, model_plain(x)) <= 1e-6
    assert gc.recomputed_blocks == before


def test_interaction_conv_keeps_its_edges():
    """The processor's conv returns ``e + m`` and ``v + φ_v([v, Σ m])``;
    a conv that embeds its edges returns none."""
    gr = P.graphcast_graphs(1, 7, 12)
    g = P.precompute(gr.mesh, dense=False)
    conv = P.InteractionConv(6, g, generator=torch.Generator().manual_seed(1))
    v, e = torch.randn(g.num_nodes, 6), torch.randn(g.num_edges, 6)
    out = conv(v, v, e)
    w = conv.edge_mlp
    s, r = g.senders.long(), g.receivers.long()
    m = w(torch.cat([e, v[s], v[r]], dim=-1))
    agg = torch.zeros_like(v).index_add_(0, r, m)
    assert torch.allclose(out.edges, e + m, atol=1e-5)
    assert torch.allclose(out.nodes, v + conv.node_mlp(
        torch.cat([v, agg], dim=-1)), atol=1e-5)
    assert out.grad_fn is out.nodes.grad_fn
    bip = P.InteractionConv(6, P.precompute(gr.mesh2grid, dense=False),
                            edge_in=4, keep_edges=False)
    res = bip(torch.randn(42, 6), torch.randn(84, 6),
              gr.mesh2grid.edata["e"])
    assert res.edges is None and res.nodes.shape == (84, 6)


def test_layer_norm_and_mlp():
    ln = P.LayerNorm(5)
    with torch.no_grad():
        ln.weight.normal_()
        ln.bias.normal_()
    x = torch.randn(7, 5)
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    want = (x - mu) / torch.sqrt(var + 1e-5) * ln.weight + ln.bias
    assert torch.allclose(ln(x), want, atol=1e-5)
    mlp = P.MLP((5, 8, 3), "swish", layer_norm=True,
                generator=torch.Generator().manual_seed(0))
    assert mlp.layer_names == ("layer_1", "layer_2", "layer_3")
    assert isinstance(mlp.layer_3, P.LayerNorm)
    out = mlp(x)
    assert torch.allclose(out.mean(-1), torch.zeros(7), atol=1e-5)
    plain = P.MLP((5, 8, 3), "swish",
                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(plain.layer_1.weight, mlp.layer_1.weight)


def test_adamw_matches_the_reference_update():
    gen = torch.Generator().manual_seed(3)
    params = {k: torch.randn(s, generator=gen) for k, s in
              (("a", (4, 5)), ("b", (1, 5)))}
    port = {k: v.clone().requires_grad_() for k, v in params.items()}
    opt = P.adamw(port.values(), 1e-2, 0.9, 0.95, 1e-8, 0.1)
    assert isinstance(opt, torch.optim.AdamW)
    ref = {k: v.clone() for k, v in params.items()}
    ref_opt = AdamW(1e-2, 0.9, 0.95, 1e-8, 0.1)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=gen)
                 for k, v in params.items()}
        for k, p in port.items():
            p.grad = grads[k].clone()
        opt.step()
        ref_opt.update(ref, grads)
    for k in params:
        assert _rel(port[k], ref[k]) <= 1e-6
        assert not torch.equal(port[k].detach(), params[k])


def test_area_weights():
    lat, _ = P.graph.sphere.lat_lon_grid(721, 4)
    w = gc.area_weights(lat)
    assert np.isclose(w.mean(), 1.0)
    rows = w.reshape(721, 4)[:, 0]
    assert np.argmax(rows) == 360 and rows[0] == rows[-1] > 0
    assert np.allclose(rows, rows[::-1])
