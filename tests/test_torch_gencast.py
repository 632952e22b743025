"""GenCast on the port (``GenCast``, ``ConditionalLayerNorm``,
``TransformerBlock``, ``MeshAttention``, ``edm_weighted_mse``, ``adamw``)
on the CPU at a small size (refinement 2, a 19 × 36 grid, 2 hops, latent
32, 2 processor layers of 4 heads), against the plain reference of the
benchmark's ``gencast-0p25`` configuration (``bench_torch/reference/
gencast-0p25.py``) on the traffic generator's graphs (the mesh in the
refinement's order, where the port runs it in ``mesh_order``) and seeded
random weights (every leaf drawn, the biases too).

Tolerances and why:

- loss: each step's within 1e-5 (relative): the port's split first layer
  of the interaction networks and its attention in 64-node tiles sum in
  another order than the reference's concatenations and dense blocks;
- gradients: each leaf within 1e-4 of the larger of its largest entry
  and the median leaf's (the key projections' biases have a gradient of
  zero but for rounding: a softmax does not change when one constant is
  added to a row's scores);
- the parameters' change over three AdamW steps: each leaf within 1e-3 of
  its largest entry (Adam's first update is about ``lr · sign(g)``, which
  rounding flips where ``|g|`` is near zero), over the leaves whose
  gradient is at least a thousandth of the median leaf's, as the
  benchmark compares them;
- recomputation against the plain call: the same bits without receiver
  blocks (the same operations on the same rows); in blocks, the forward
  within 1e-6 and each gradient within 1e-5 by the gradients' measure
  (the blocks' products run on fewer rows, and the conditioning vector's
  gradient is summed block by block).
"""
import statistics
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.models import gencast as gm  # noqa: E402
from neuralgraphpde_torch.models import graphcast as gc  # noqa: E402
from neuralgraphpde_torch.train import losses  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench_torch.core import cell as cells  # noqa: E402
from bench_torch.core import compare  # noqa: E402
from bench_torch.core import train as bench_train  # noqa: E402
from bench_torch.core.cell import draw_weights  # noqa: E402

CPU = torch.device("cpu")
PROG = cells.load_module(cells.HERE / "configs" / "gencast-0p25.py")
REF = cells.load_module(cells.HERE / "reference" / "gencast-0p25.py")
CFG = {**cells.read_json(cells.HERE / "configs" / "gencast-0p25.json"),
       "latent": 32, "processor_layers": 2, "head_dim": 8, "ffw_hidden": 64,
       "blocks": {"grid2mesh": 2, "mesh2grid": 3}}
SPEC = {**cells.read_json(cells.HERE / "traffic" /
                          "era5-synthetic-0p25-13l.json")["gencast"],
        "splits": 2, "n_lat": 19, "n_lon": 36, "hops": 2, "mesh_nodes": 162,
        "mesh_edges": 960, "grid2mesh_edges": 1236, "mesh2grid_edges": 2052}
TRAFFIC = {"task": "train", "samples": 3, "episode_steps": 3,
           "weights_seed": 0, "gencast": SPEC}


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _leaves_close(got: dict, want: dict, tol: float) -> list:
    """The leaves of ``got`` off ``want`` by more than ``tol`` of the
    larger of their largest entry and the median leaf's."""
    top = {k: float(g.abs().max()) for k, g in want.items()}
    med = statistics.median(top.values())
    return [k for k, g in want.items()
            if float((got[k] - g).abs().max()) > tol * max(top[k], med)]


@pytest.fixture(scope="module")
def setup():
    data = PROG.make_data(CFG, TRAFFIC, 2 ** 31 + 24, CPU)
    spec = PROG.weight_spec(CFG, data)
    weights = draw_weights(spec, 5, CPU)
    gen = torch.Generator().manual_seed(7)
    for name, shape, kind in spec:  # no leaf left at zero
        if kind == "zeros":
            weights[name] = 0.1 * torch.randn(shape, generator=gen)
    return data, weights


def _small_model(recompute, blocks=(2, 2)):
    gr = P.gencast_graphs(1, 7, 12)
    model = P.GenCast(20, 4, 16, 2, 2, 32, recompute=recompute,
                      generator=torch.Generator().manual_seed(0))
    return model.set_graphs(gm.precompute_graphs(gr, 2, blocks))


def test_weight_spec_names_every_parameter(setup):
    data, _ = setup
    model = P.GenCast(CFG["grid_in"], CFG["grid_out"], CFG["latent"],
                      CFG["processor_layers"], CFG["heads"],
                      CFG["ffw_hidden"])
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: s for n, s, _ in PROG.weight_spec(CFG, data)}


def test_published_size_has_its_parameter_count():
    with torch.device("meta"):
        model = P.GenCast()
    # 16 blocks of 3,185,152 (Q, K, V, O 1,050,624; FFW 2,099,712; two
    # conditional LayerNorms 34,816); Grid2Mesh and Mesh2Grid 2,154,496
    # each; the embedders, the grid update, the output MLP and the noise
    # encoder 1,553,028
    assert sum(p.numel() for p in model.parameters()) == 56_824_452


def test_loss_gradients_and_steps_match_the_reference(setup):
    data, weights = setup
    prog = PROG.train_program(CFG, data, CPU, weights)
    checked = bench_train.first_steps(prog)
    ref = REF.train(CFG, data, weights, 3, CPU)
    for a, b in zip(checked["losses"], ref["losses"]):
        assert abs(a - b) / abs(b) <= 1e-5
    assert set(checked["grads"]) == set(ref["grads"])
    assert _leaves_close(checked["grads"], ref["grads"], 1e-4) == []
    top = {k: float(g.abs().max()) for k, g in ref["grads"].items()}
    med = statistics.median(top.values())
    for k in ref["change"]:
        if top[k] >= 1e-3 * med:
            assert _rel(checked["change"][k], ref["change"][k]) <= 1e-3, k
    numbers = compare.training(checked, ref)
    assert all(v <= 1e-3 for v in numbers.values()), numbers


def test_conditional_layer_norm_with_zero_weights_is_layer_norm():
    cln = P.ConditionalLayerNorm(6, 3,
                                 generator=torch.Generator().manual_seed(0))
    x, c = torch.randn(5, 6), torch.randn(1, 3)
    assert not torch.allclose(cln(x, c), P.LayerNorm(6)(x))
    with torch.no_grad():
        for p in cln.parameters():
            p.zero_()
    assert torch.equal(cln(x, c), P.LayerNorm(6)(x))
    mlp = P.MLP((4, 8, 6), "swish", layer_norm=True, cond=3)
    assert isinstance(mlp.layer_3, P.ConditionalLayerNorm)
    assert isinstance(P.MLP((4, 8, 6), layer_norm=True).layer_3, P.LayerNorm)


def test_edm_coefficients_and_loss_weight():
    c_skip, c_out, c_in, c_noise = gm.edm_coefficients(torch.tensor(1.0))
    assert float(c_skip) == 0.5 and float(c_noise) == 0.0
    assert math.isclose(float(c_out), 2 ** -0.5, rel_tol=1e-7)
    assert math.isclose(float(c_in), 2 ** -0.5, rel_tol=1e-7)
    c_skip, c_out, c_in, _ = gm.edm_coefficients(
        torch.tensor(1e-4, dtype=torch.float64))
    assert abs(float(c_skip) - 1) < 1e-7 and abs(float(c_in) - 1) < 1e-7
    assert abs(float(c_out) - 1e-4) < 1e-11
    d, t = torch.randn(7, 3), torch.randn(7, 3)
    w_n, w_c = torch.rand(7), torch.rand(3)
    sigma = torch.tensor(0.5)
    assert torch.allclose(losses.edm_weighted_mse(d, t, sigma, w_n, w_c),
                          5.0 * losses.weighted_mse(d, t, w_n, w_c))


def test_denoiser_is_preconditioned():
    """``D(z; σ) = c_skip z + c_out F([inputs, c_in z], c)``."""
    model = _small_model(False)
    x, z, sigma = torch.randn(84, 16), torch.randn(84, 4), torch.tensor(3.0)
    c_skip, c_out, c_in, c_noise = gm.edm_coefficients(sigma)
    cond = model.noise_encoder(gm.fourier_features(c_noise, 32, 16.0))
    f = model.network(torch.cat([x, c_in * z], dim=-1), cond)
    assert torch.allclose(model(x, z, sigma), c_skip * z + c_out * f)
    assert cond.shape == (1, 16)


def test_recomputation_gives_the_plain_bits_and_is_counted_and_spanned():
    x, z, sigma = torch.randn(84, 16), torch.randn(84, 4), torch.tensor(0.7)
    runs = []
    for recompute, blocks in ((False, (1, 1)), (True, (1, 1)),
                              (True, (2, 2))):
        model = _small_model(recompute, blocks)
        counts = (gm.interaction_forwards, gm.chunks, gm.recomputed_blocks)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = model(x, z, sigma)
            out.square().mean().backward()
        names = [e.name for e in prof.events()]
        runs.append((out.detach(), {n: p.grad for n, p in
                                    model.named_parameters()},
                     [b - a for a, b in zip(counts, (
                         gm.interaction_forwards, gm.chunks,
                         gm.recomputed_blocks))], names))
    (out0, g0, c0, n0), (out1, g1, c1, n1), (out2, g2, c2, n2) = runs
    assert torch.equal(out0, out1) and _rel(out2, out0) <= 1e-6
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert _leaves_close(g2, g0, 1e-5) == []
    assert c0 == [2, 0, 0]  # Grid2Mesh and Mesh2Grid forward
    assert c1 == [4, 0, 2 + 2]  # each recomputed; 2 processor layers
    assert c2 == [4, 4, 2 + 4]  # 2 + 2 receiver blocks, each recomputed
    assert [n.count("ngpde.recompute") for n in (n0, n1, n2)] == [0, 4, 6]
    for names in (n0, n1, n2):
        for part in ("encoder", "processor", "decoder"):
            assert names.count(f"ngpde.gencast.{part}") == 1
        assert names.count("ngpde.gencast.noise") == 2
    # the attention's span, once a layer forward and once a recomputation
    assert n0.count("ngpde.conv.MeshAttention") == 2
    assert n1.count("ngpde.conv.MeshAttention") == 4


def test_module_hooks_see_each_layer_once():
    model = _small_model(True)
    seen = []
    for block in model.processor:
        block.attention.register_forward_hook(
            lambda m, a, out: seen.append(m))
    x, z = torch.randn(84, 16), torch.randn(84, 4)
    model(x, z, torch.tensor(2.0)).sum().backward()
    assert seen == [b.attention for b in model.processor]


def test_graphcast_outputs_unchanged():
    """GraphCast shares ``MLP``, ``InteractionConv`` and the recomputation
    with GenCast: its forward and gradients on a fixed model and input,
    against the numbers the code before the conditioning gave (float64 sums
    of float32 results; 1e-6 relative leaves room for another BLAS)."""
    gr = P.graphcast_graphs(1, 7, 12)
    model = P.GraphCast(10, 3, 8, 2, recompute=True,
                        generator=torch.Generator().manual_seed(0))
    model.set_graphs(gc.precompute_graphs(gr, (2, 2)))
    x = torch.randn(84, 10, generator=torch.Generator().manual_seed(1))
    out = model(x)
    (out ** 2).sum().backward()
    got = [float(out.detach().double().sum()),
           float(out.detach().double().square().sum())] + [
        float(p.grad.double().square().sum())
        for p in list(model.parameters())[:6]]
    want = [13.86188502330333, 332.7152312094713, 152744.79807947588,
            103302.00250877005, 162954.1978264961, 419873.5371735144,
            50156.525453717884, 56018.01656207299]
    for a, b in zip(got, want):
        assert math.isclose(a, b, rel_tol=1e-6), (got, want)
