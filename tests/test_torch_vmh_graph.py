"""``VMHConv``'s forward as one replay of a captured CUDA graph
(``nn/conv.py::vmh_graph``, ``nn/graphed.py``).

On the CPU: every call that the gate turns away takes the eager path (a
CPU input, autograd on, a dict input, a graph without ``tcsr_edges``),
captures and replays nothing and gives the eager forward's bits; the key's
parameter addresses follow replaced tensors and not in-place updates, and
a tensor swapped in for one call (``torch.func.functional_call``, the
precision wrapper) keeps the call eager.

On a card (``cuda`` marker; skipped without one), at the ``vmh-convdiff``
cell's shapes (a 3,000-point Delaunay mesh, ϕ 4→60→60→60→40, γ
41→60→60→60→1): a replay equals the eager forward bit for bit (the same
kernels on the same inputs); a whole rollout of the trained surrogate
under ``inference_mode`` equals the eager rollout bit for bit, with one
capture and a replay for each of the initial step's two evaluations (the
attempts' evaluations run inside the solver's attempt graph); outputs do
not share storage; in-place and replaced parameters, a new graph and
alternating grad modes; the K3 envelope error raises as it does eagerly,
with no capture left behind; a forward that reads a value home runs
eagerly; the spans and the launch counters.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per process: the suite runs in several pytest-xdist
# workers at once, and many small ops gain nothing from more threads
torch.set_num_threads(1)

import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.kernels import fused_mlp_kernels as PK  # noqa
from neuralgraphpde_torch.nn import conv as port_conv  # noqa: E402
from neuralgraphpde_torch.ops import fused as port_fused  # noqa: E402
from neuralgraphpde_torch.nn import graphed  # noqa: E402
from neuralgraphpde_torch.ode import integrate as port_int  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SURROGATE = os.path.join(REPO, "bench_torch", "weights", "vmh-convdiff.pt")


def _counts():
    return (port_conv.vmh_graph.captures, port_conv.vmh_graph.replays,
            port_conv.vmh_graph.eager)


def _mesh(points, device="cpu", seed=0):
    pts = np.random.default_rng(seed).random((points, 2)).astype(np.float32)
    g = P.precompute(P.delaunay_graph(pts, ndata={"x": pts}), dense=False)
    return g.to(device), pts


def _conv(hidden=60, msg=40, depth=3, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    phi = P.MLP((4,) + (hidden,) * depth + (msg,), "tanh", generator=gen,
                device=device)
    gamma = P.MLP((1 + msg,) + (hidden,) * depth + (1,), "tanh",
                  generator=gen, device=device)
    return P.VMHConv(phi, gamma)


def _field(pts, device="cpu", k=1.0):
    u = np.sin(6 * k * pts[:, :1]) * np.cos(4 * pts[:, 1:])
    return torch.from_numpy(u.astype(np.float32)).to(device)


@pytest.fixture
def no_capture(monkeypatch):
    """Fail if anything tries to capture."""

    def refuse(*a, **k):
        raise AssertionError("the gate let a call through to a capture")

    monkeypatch.setattr(port_conv, "CapturedCall", refuse)


# ------------------------------------------------------------- CPU: the gate
@pytest.mark.parametrize("case", ["cpu input, no_grad, pallas",
                                  "cpu input, inference_mode, auto",
                                  "grad enabled, pallas", "dict input",
                                  "no tcsr_edges"])
def test_gate_keeps_the_eager_path(monkeypatch, no_capture, case):
    g, pts = _mesh(200)
    layer = _conv(hidden=12, msg=6)
    if case == "no tcsr_edges":
        g = dataclasses.replace(g, cache={k: v for k, v in g.cache.items()
                                          if k != "tcsr_edges"})
    P.update_graph(layer, g)
    x = _field(pts)
    fused = []
    orig = port_fused.fused_mlp_aggregate
    monkeypatch.setattr(port_fused, "fused_mlp_aggregate",
                        lambda *a: fused.append(1) or orig(*a))
    arg = {port_conv.INPUT_KEY: x} if case == "dict input" else x
    mode = "auto" if "auto" in case else "pallas"
    grad = torch.enable_grad() if case.startswith("grad") else (
        torch.inference_mode() if "inference" in case else torch.no_grad())
    P.set_spmm_mode(mode)
    try:
        before = _counts()
        with grad:
            got = layer(arg)
            want = layer._eager(arg)
        after = _counts()
    finally:
        P.set_spmm_mode("auto")
    assert after[:2] == before[:2]  # no capture, no replay
    assert after[2] - before[2] == (0 if case == "dict input" else 1)
    assert torch.equal(got, want)
    # the eager path is today's: K3's plain version where the fused gate
    # holds, the per-edge path where the graph lacks the edge-id layout
    assert bool(fused) == (mode == "pallas" and case != "no tcsr_edges")
    assert got.requires_grad == case.startswith("grad")


def test_param_ptrs_follow_replaced_tensors_not_inplace_updates():
    layer = _conv(hidden=12, msg=6)
    ptrs = graphed.param_ptrs(layer)
    assert len(ptrs) == 16  # 4 Dense layers in each MLP, weight and bias
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.5)
    assert graphed.param_ptrs(layer) == ptrs
    w = layer.gamma.layer_2.weight
    layer.gamma.layer_2.weight = torch.nn.Parameter(w.detach().clone())
    new = graphed.param_ptrs(layer)
    assert new != ptrs and sum(a != b for a, b in zip(new, ptrs)) == 1


def test_tensors_swapped_in_for_one_call_stay_eager(monkeypatch):
    """Under ``functional_call`` (and so the precision wrapper) ϕ's and γ's
    parameters are tensors made for the call: no key can hold them."""
    g, pts = _mesh(200)
    layer = _conv(hidden=12, msg=6)
    P.update_graph(layer, g)
    seen = []
    monkeypatch.setattr(P.VMHConv, "forward", lambda self, x: seen.append(
        graphed.param_ptrs(self)) or x)
    params = {k: v.detach().clone() for k, v in layer.named_parameters()}
    torch.func.functional_call(layer, params, (_field(pts),))
    with torch.no_grad():
        P.bf16(layer)(_field(pts))
        layer(_field(pts))
    assert seen[:2] == [None, None] and len(seen[2]) == 16


# ------------------------------------------------------------ CUDA cases
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def eager(monkeypatch):
    """A context in which every ``VMHConv`` call takes the eager path, and
    so does every solver attempt (``ode.integrate.attempt_graph``)."""

    class Eager:
        def __enter__(self):
            monkeypatch.setattr(port_conv, "vmh_graph", lambda conv, x: None)
            monkeypatch.setattr(graphed, "on_card", lambda x: False)

        def __exit__(self, *exc):
            monkeypatch.undo()

    return Eager()


def _cell_layer(cuda, seed=0):
    g, pts = _mesh(3000, cuda)
    layer = _conv(seed=seed, device=cuda)
    P.update_graph(layer, g)
    return layer, g, pts


@pytest.mark.cuda
@pytest.mark.parametrize("grad", ["no_grad", "inference_mode"])
def test_replay_equals_eager_cuda(cuda, eager, grad):
    layer, _, pts = _cell_layer(cuda)
    ctx = torch.no_grad if grad == "no_grad" else torch.inference_mode
    xs = [_field(pts, cuda, k) for k in (1.0, 0.7, 1.3)]
    with ctx():
        with eager:
            want = [layer(x) for x in xs]
        before, k3 = _counts(), PK.fused_mlp_fwd.launches
        got = [layer(x) for x in xs]
        after = _counts()
    assert after[0] - before[0] == 1 and after[1] - before[1] == 3
    # the warm-up launches K3 once; each replay adds its recorded launch
    assert PK.fused_mlp_fwd.launches - k3 == 1 + 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _surrogate(cuda):
    g, pts = _mesh(3000, cuda)
    model = P.vmh_model(1, 2, hidden=60, msg_dim=40, depth=3,
                        saveat=tuple(float(t) for t in
                                     np.linspace(0, 0.2, 21)),
                        rtol=1e-5, atol=1e-3, device=cuda)
    saved = torch.load(SURROGATE, map_location="cpu",
                       weights_only=True)["weights"]
    with torch.no_grad():
        for name, p in model.named_parameters():
            _, mlp, layer, kind = name.split(".")
            p.copy_(saved[f"{mlp}.{int(layer.split('_')[1]) - 1}.{kind}"])
    P.update_graph(model, g)
    return model, pts


@pytest.mark.cuda
def test_rollout_equals_eager_rollout_cuda(cuda, eager):
    """The trained surrogate's rollout: one capture; the initial step's
    evaluations replay, and the attempts' evaluations, recorded in the
    solver's attempt graph, replay with it; the eager rollout's bits and
    steps."""
    model, pts = _surrogate(cuda)
    u0 = _field(pts, cuda)

    def attempts():
        return port_int.attempt_graph.replays

    with torch.inference_mode():
        with eager:
            want = model(u0)
        want_stats = dict(model.last_stats)
        start = _counts()
        first = model(u0)  # captures VMHConv's graph and the attempt graph
        before, replays = _counts(), attempts()
        got = model(u0)
        after, replayed = _counts(), attempts() - replays
        stats = dict(model.last_stats)
        again = model(_field(pts, cuda, 0.8))
        last = _counts()
    assert stats == want_stats and stats["nfe"] > 40
    assert before[0] - start[0] == 1
    assert after[0] == before[0]
    assert replayed == stats["steps"]
    # the initial step's two evaluations; the attempts' six each are in
    # the attempt graph's replays
    assert after[1] - before[1] == stats["nfe"] - 6 * replayed == 2
    assert after[2] == before[2]
    assert torch.equal(first, want) and torch.equal(got, want)
    assert last[0] == after[0]  # the next request captures nothing
    assert last[1] - after[1] == 2
    assert torch.isfinite(again).all()


@pytest.mark.cuda
def test_outputs_keep_their_own_values_cuda(cuda):
    layer, _, pts = _cell_layer(cuda)
    x1, x2 = _field(pts, cuda), _field(pts, cuda, 1.5)
    with torch.inference_mode():
        y1 = layer(x1)
        keep = y1.clone()
        y2 = layer(x2)
    assert y1.untyped_storage().data_ptr() != y2.untyped_storage().data_ptr()
    assert torch.equal(y1, keep) and not torch.equal(y1, y2)


@pytest.mark.cuda
def test_parameters_inplace_and_replaced_cuda(cuda, eager):
    layer, g, pts = _cell_layer(cuda)
    x = _field(pts, cuda)

    def both():
        with eager:
            want = layer(x)
        before = _counts()
        got = layer(x)
        assert torch.equal(got, want)
        return _counts()[0] - before[0]

    with torch.no_grad():
        both()
        for p in layer.parameters():  # an optimizer's in-place step
            p.mul_(1.01)
        assert both() == 0
        w = layer.phi.layer_1.weight
        layer.phi.layer_1.weight = torch.nn.Parameter(w * 0.9)
        assert both() == 1
        P.update_graph(layer, g.copy(ndata={"x": g.ndata["x"] * 1.1}))
        assert both() == 1
        assert both() == 0


@pytest.mark.cuda
def test_alternating_grad_modes_cuda(cuda, eager):
    layer, _, pts = _cell_layer(cuda)
    x = _field(pts, cuda)
    with torch.no_grad(), eager:
        want = layer(x)
    modes = [torch.inference_mode, torch.no_grad, torch.enable_grad,
             torch.inference_mode, torch.inference_mode, torch.no_grad,
             torch.enable_grad, torch.no_grad]
    before = _counts()
    for mode in modes:
        with mode():
            got = layer(x)
        assert torch.equal(got.detach(), want), mode
    after = _counts()
    # inference tensors and normal ones are keyed apart: every switch
    # between the two captures anew; grad-enabled calls run eagerly
    assert after[0] - before[0] == 4
    assert after[1] - before[1] == 6 and after[2] - before[2] == 2


@pytest.mark.cuda
def test_envelope_error_raises_before_any_capture_cuda(cuda):
    layer, _, pts = _cell_layer(cuda)
    wide = _conv(hidden=1100, msg=40, device=cuda)
    P.update_graph(wide, layer.graph)
    x = _field(pts, cuda)
    with torch.enable_grad():
        with pytest.raises(ValueError, match="envelope"):
            wide(x)
    before = _counts()
    with torch.no_grad():
        with pytest.raises(ValueError, match="envelope"):
            wide(x)
    assert _counts()[:2] == before[:2]
    assert wide not in port_conv._CAPTURED


@pytest.mark.cuda
def test_forward_that_reads_home_runs_eagerly_cuda(cuda, eager):
    """A γ that reads a value home cannot be captured: the call warns and
    runs eagerly, and so does every later call under that key."""
    layer, _, pts = _cell_layer(cuda)

    class ReadsHome(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, h):
            return self.inner(h) * float(h.abs().max() > -1)

    layer.gamma = ReadsHome(layer.gamma)
    x = _field(pts, cuda)
    with torch.no_grad():
        with eager:
            want = layer(x)
        before = _counts()
        with pytest.warns(UserWarning, match="could not be captured"):
            got = layer(x)
        got2 = layer(x)
    after = _counts()
    assert torch.equal(got, want) and torch.equal(got2, want)
    assert after[:2] == before[:2] and after[2] - before[2] == 2


@pytest.mark.cuda
def test_spans_and_device_events_cuda(cuda):
    """A capture runs in ``ngpde.dispatch.vmh_capture``, a replay in
    ``ngpde.dispatch.vmh_graph`` without entering ``ngpde.dispatch.k3``,
    and the profiler sees the replayed kernels on the card."""
    layer, _, pts = _cell_layer(cuda)
    x = _field(pts, cuda)
    acts = torch.profiler.ProfilerActivity
    with torch.inference_mode():
        with torch.profiler.profile(activities=[acts.CPU]) as prof:
            layer(x)
        names = {e.name for e in prof.events()}
        assert "ngpde.dispatch.vmh_capture" in names
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            layer(x)
            torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert "ngpde.dispatch.vmh_graph" in names
    assert "ngpde.dispatch.k3" not in names
    assert "ngpde.dispatch.vmh_capture" not in names
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("fused_mlp_fwd" in n for n in device), device
