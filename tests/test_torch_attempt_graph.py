"""An adaptive solve's attempted step as one replay of a captured CUDA
graph (``ode/integrate.py::attempt_graph``, ``nn/graphed.py``).

On the CPU: every solve that the gate turns away runs its attempts eagerly
and captures nothing (a CPU state, autograd on, a right-hand side not
declared free of ``t``, a capture already in progress, parameters swapped
in for one call); with a stand-in capture that replays by running the
call again, the solver's use of the three state pairs gives the eager
solve's bits and counts (Tsit5 and dopri5, Hermite and tstop saves, with
rejected steps, and intervals that run out of attempts on a rejected
one); a capture that raises leaves a warning and the eager
path, once a key; the key follows replaced parameters, new graphs, the
SpMM mode, the tolerances and inference mode, and not in-place updates.
The card's gate is stood in for by patching ``nn.graphed.on_card`` (and
``torch.cuda``'s capture calls, which a CPU build cannot make).

On a card (``cuda`` marker; skipped without one): a rollout of the trained
``vmh-convdiff`` surrogate under ``inference_mode`` equals the eager
rollout bit for bit, with the same counts, one capture and a replay for
every attempt; a parameter updated in place is read and a replaced one
captures anew; the backsolve adjoint's forward replays and equals its
eager self, gradients included; solves under autograd stay eager; a GRAND
forward on a small grid replays and equals its eager self; the spans.
"""
import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread per process: the suite runs in several pytest-xdist
# workers at once, and many small ops gain nothing from more threads
torch.set_num_threads(1)

import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.kernels import rk_kernels as rk  # noqa: E402
from neuralgraphpde_torch.nn import conv as port_conv  # noqa: E402
from neuralgraphpde_torch.nn import graphed  # noqa: E402
from neuralgraphpde_torch.ode import integrate as port_int  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SURROGATE = os.path.join(REPO, "bench_torch", "weights", "vmh-convdiff.pt")
SAVES = tuple(float(t) for t in np.linspace(0, 0.2, 21))


def _counts():
    g = port_int.attempt_graph
    return g.captures, g.replays, g.eager


_COUNTED = ("nfe", "steps", "accepted", "combos", "combos_fused")


def _same_counts(a, b):
    return all(a[k] == b[k] for k in _COUNTED)


def _mlp_ode(scale=1.0, **kw):
    gen = torch.Generator().manual_seed(0)
    model = P.MLP((6, 16, 6), "tanh", generator=gen)
    with torch.no_grad():  # larger weights, stiffer dynamics
        for p in model.parameters():
            p.mul_(scale)
    return P.NeuralGraphODE(model, tspan=(0.0, 2.0), rtol=1e-5, atol=1e-5,
                            **kw)


def _state(seed=1):
    return torch.randn(20, 6, generator=torch.Generator().manual_seed(seed))


def _mesh(points, device="cpu", seed=0):
    pts = np.random.default_rng(seed).random((points, 2)).astype(np.float32)
    g = P.precompute(P.delaunay_graph(pts, ndata={"x": pts}), dense=False)
    return g.to(device), pts


def _field(pts, device="cpu", k=1.0):
    u = np.sin(6 * k * pts[:, :1]) * np.cos(4 * pts[:, 1:])
    return torch.from_numpy(u.astype(np.float32)).to(device)


@pytest.fixture
def card(monkeypatch):
    """The gate's device test and capture check as on a card with no
    capture running; ``VMHConv``'s own capture stays off."""
    monkeypatch.setattr(graphed, "on_card", lambda x: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(port_conv, "vmh_graph", lambda conv, x: None)


@pytest.fixture
def replayed(monkeypatch):
    """A stand-in capture whose replay runs the captured call again on its
    static inputs."""

    class Graph:
        def pool(self):
            return None

    class Replayed:
        def __init__(self, key, fn, *xs, keep=None, pool=None):
            self.key, self.fn, self.static_in = key, fn, xs
            self.graph = Graph()

        def replay(self):
            return self.fn(*self.static_in)

    monkeypatch.setattr(port_int, "CapturedCall", Replayed)


@pytest.fixture
def no_capture(monkeypatch):
    """Fail if anything tries to capture."""

    def refuse(*a, **k):
        raise AssertionError("the gate let a solve through to a capture")

    monkeypatch.setattr(port_int, "CapturedCall", refuse)


# ------------------------------------------------------------- CPU: the gate
@pytest.mark.parametrize("case", ["cpu state", "autograd on",
                                  "rhs not declared", "capture in progress",
                                  "parameters swapped in"])
def test_gate_keeps_the_eager_path(monkeypatch, no_capture, case):
    if case != "cpu state":
        monkeypatch.setattr(graphed, "on_card", lambda x: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: case == "capture in progress")
    ode = _mlp_ode()
    x = _state()
    grad = (torch.enable_grad() if case == "autograd on"
            else torch.no_grad())
    stats = {}
    before = _counts()
    with grad:
        if case == "rhs not declared":
            got = P.odeint(lambda t, u, a: ode.model(u), x, ode.tspan,
                           rtol=ode.rtol, atol=ode.atol, stats=stats)
        elif case == "parameters swapped in":
            params = {k: v.detach().clone()
                      for k, v in ode.named_parameters()}
            got = torch.func.functional_call(ode, params, (x,))
        else:
            got = ode(x)
    after = _counts()
    stats = stats or ode.last_stats
    assert after[:2] == before[:2]  # no capture, no replay
    assert after[2] - before[2] == stats["steps"] > 1
    with torch.no_grad():
        want = P.odeint(lambda t, u, a: ode.model(u), x, ode.tspan,
                        rtol=ode.rtol, atol=ode.atol)
    assert torch.equal(got.detach(), want)
    assert got.requires_grad == (case == "autograd on")


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda``'s stream and graph calls as ``CapturedCall`` makes
    them, on the CPU; the capture itself raises, as a call that reads a
    value home does on the card."""

    class Stream:
        def __init__(self, *a):
            pass

        def wait_stream(self, other):
            pass

    def graph(*a, **k):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(graphed, "_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)


def test_capture_that_raises_falls_back_to_eager(card, fake_cuda):
    """The capture runs the attempt once eagerly, then fails: a warning,
    the eager path's values and counts, and no second try under the same
    key."""
    ode = _mlp_ode()
    x = _state()
    with torch.no_grad():
        want = P.odeint(lambda t, u, a: ode.model(u), x, ode.tspan,
                        rtol=ode.rtol, atol=ode.atol)
        launches = (rk.rk_combine.launches, rk.rk_norm.launches)
        before = _counts()
        with pytest.warns(UserWarning, match="could not be captured"):
            got = ode(x)
        stats = dict(ode.last_stats)
        mid = _counts()
        again = ode(x)
        after = _counts()
    assert torch.equal(got, want) and torch.equal(again, want)
    assert mid[:2] == before[:2] and after[:2] == before[:2]
    assert mid[2] - before[2] == stats["steps"] == after[2] - mid[2]
    assert stats["nfe"] == 2 + 6 * stats["steps"]
    assert (rk.rk_combine.launches, rk.rk_norm.launches) == launches
    assert ode.model in port_int._ATTEMPTS


@pytest.mark.parametrize("solver", ["tsit5", "dopri5"])
@pytest.mark.parametrize("interpolation", ["hermite", "tstop"])
def test_replays_match_the_eager_solve(card, replayed, solver,
                                       interpolation):
    """The solver's side of the replays, with the stand-in capture: the
    three state pairs taken in turn, rejected and accepted attempts, the
    saves and the counts give the eager solve's bits."""
    ode = _mlp_ode(3.0, solver=solver, interpolation=interpolation,
                   saveat=(0.0, 0.3, 0.31, 1.0, 2.0))
    x = _state()
    want_stats = {}
    with torch.no_grad():
        want = P.odeint(lambda t, u, a: ode.model(u), x, ode.saveat,
                        solver=solver, rtol=ode.rtol, atol=ode.atol,
                        interpolation=interpolation, stats=want_stats)
        before = _counts()
        got = ode(x)
        after = _counts()
    stats = ode.last_stats
    assert torch.equal(got, want)
    assert _same_counts(stats, want_stats)
    assert stats["steps"] > stats["accepted"]  # a rejected attempt
    assert after[0] - before[0] == 1
    assert after[1] - before[1] == stats["steps"] and after[2] == before[2]
    # the saves own their memory: no pair of the graphs is returned
    pairs = [t.untyped_storage().data_ptr() for pair in
             port_int._ATTEMPTS[ode.model].pairs for t in pair]
    assert got.untyped_storage().data_ptr() not in pairs


@pytest.mark.parametrize("interpolation", ["hermite", "tstop"])
@pytest.mark.parametrize("max_steps", [4, 5, 6, 7])
def test_intervals_out_of_attempts_match_the_eager_solve(
        card, replayed, interpolation, max_steps):
    """Intervals that run out of attempts (``max_steps`` an interval), some
    on a rejected attempt after an accepted one: the saves read the state
    of the step before the current one, which no later attempt writes."""
    ode = _mlp_ode(3.0, interpolation=interpolation, max_steps=max_steps,
                   saveat=(0.0, 0.3, 0.31, 1.0, 2.0))
    x = _state()
    want_stats = {"attempts": []}
    with torch.no_grad():
        want = P.odeint(lambda t, u, a: ode.model(u), x, ode.saveat,
                        rtol=ode.rtol, atol=ode.atol, max_steps=max_steps,
                        interpolation=interpolation, stats=want_stats)
        got = ode(x)
    assert max_steps in want_stats["attempts"]  # an interval ran out
    assert torch.equal(got, want)
    assert _same_counts(ode.last_stats, want_stats)


def test_key_follows_what_a_replay_reads(monkeypatch, card):
    """A capture a key: in-place parameter updates and a second solve keep
    the key; a replaced parameter, a new graph, another SpMM mode, other
    tolerances and inference mode each make a new one."""
    made = []

    class Call:  # a capture that made no graph: the solve runs eagerly
        graph = None

        def __init__(self, key, fn, *xs, **kw):
            self.key = key
            made.append(key)

    monkeypatch.setattr(port_int, "CapturedCall", Call)
    g, pts = _mesh(200)
    gen = torch.Generator().manual_seed(0)
    phi = P.MLP((4, 12, 6), "tanh", generator=gen)
    gamma = P.MLP((7, 12, 1), "tanh", generator=gen)
    ode = P.NeuralGraphODE(P.VMHConv(phi, gamma), tspan=(0.0, 0.05),
                           rtol=1e-3, atol=1e-3)
    P.update_graph(ode, g)
    x = _field(pts)

    def new_keys(step=lambda: None):
        step()
        n = len(made)
        with torch.no_grad():
            ode(x)
        return len(made) - n

    assert new_keys() == 1
    assert new_keys() == 0
    with torch.no_grad():
        assert new_keys(lambda: [p.mul_(1.01) for p in ode.parameters()]) \
            == 0
    w = gamma.layer_1.weight
    assert new_keys(lambda: setattr(gamma.layer_1, "weight",
                                    torch.nn.Parameter(w.detach() * 0.9))) \
        == 1
    assert new_keys(lambda: P.update_graph(ode, g.copy(
        ndata={"x": g.ndata["x"] * 1.1}))) == 1
    try:
        assert new_keys(lambda: P.set_spmm_mode("pallas")) == 1
    finally:
        P.set_spmm_mode("auto")
    assert new_keys() == 1
    assert new_keys(lambda: setattr(ode, "rtol", 1e-4)) == 1
    n = len(made)
    with torch.inference_mode():
        ode(x)
    assert len(made) - n == 1


# ------------------------------------------------------------ CUDA cases
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def eager(monkeypatch):
    """A context in which every attempt and every ``VMHConv`` call runs
    eagerly."""

    class Eager:
        def __enter__(self):
            monkeypatch.setattr(graphed, "on_card", lambda x: False)
            monkeypatch.setattr(port_conv, "vmh_graph", lambda conv, x: None)

        def __exit__(self, *exc):
            monkeypatch.undo()

    return Eager()


def _surrogate(cuda, **kw):
    g, pts = _mesh(3000, cuda)
    model = P.vmh_model(1, 2, hidden=60, msg_dim=40, depth=3, saveat=SAVES,
                        rtol=1e-5, atol=1e-3, device=cuda, **kw)
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
    """The trained surrogate's rollout: one capture, a replay for every
    attempt, the eager rollout's bits and counts."""
    model, pts = _surrogate(cuda)
    u0 = _field(pts, cuda)
    with torch.inference_mode():
        with eager:
            want = model(u0)
        want_stats = dict(model.last_stats)
        before = _counts()
        got = model(u0)
        stats = dict(model.last_stats)
        mid = _counts()
        again = model(u0)
        after = _counts()
    assert _same_counts(stats, want_stats) and stats["nfe"] > 40
    assert _same_counts(model.last_stats, want_stats)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert mid[0] - before[0] == 1 and after[0] == mid[0]
    assert mid[1] - before[1] == stats["steps"] == after[1] - mid[1]
    assert after[2] == before[2]
    # the initial step's two evaluations run outside the attempt graph
    assert stats["nfe"] == 2 + 6 * stats["steps"]
    assert stats["combos"] == stats["combos_fused"]


@pytest.mark.cuda
def test_parameters_inplace_and_replaced_cuda(cuda, eager):
    model, pts = _surrogate(cuda)
    u0 = _field(pts, cuda)

    def both():
        with eager:
            want = model(u0)
        before = _counts()
        got = model(u0)
        assert torch.equal(got, want)
        assert _counts()[1] - before[1] == model.last_stats["steps"]
        return _counts()[0] - before[0]

    with torch.no_grad():
        both()
        for p in model.parameters():  # an optimizer's in-place step
            p.mul_(1.001)
        assert both() == 0
        w = model.model.gamma.layer_1.weight
        model.model.gamma.layer_1.weight = torch.nn.Parameter(w * 0.999)
        assert both() == 1
        assert both() == 0


@pytest.mark.cuda
def test_backsolve_forward_equals_eager_cuda(cuda, eager):
    """The backsolve adjoint's forward solve runs outside autograd and
    replays; its augmented backward stays eager. The values are the eager
    path's bits; the gradients differ from the eager path's no more than
    two eager runs differ (the backward's scatter-adds sum with atomics)."""
    model, pts = _surrogate(cuda, adjoint="backsolve")
    model.saveat = SAVES[:6]
    u0 = _field(pts, cuda)

    def run():
        ys = model(u0)
        grads = torch.autograd.grad((ys ** 2).sum(),
                                    list(model.parameters()))
        return ys.detach(), grads, dict(model.last_stats)

    with eager:
        want, want_grads, want_stats = run()
        _, rerun_grads, _ = run()
    before = _counts()
    got, grads, stats = run()
    after = _counts()
    assert torch.equal(got, want)
    for a, b, c in zip(grads, want_grads, rerun_grads):
        spread = float((c - b).abs().max())
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 10 * spread + 1e-6 * scale
    assert _same_counts(stats, want_stats)
    assert stats["backward_nfe"] == want_stats["backward_nfe"]
    assert after[1] - before[1] == stats["steps"]
    assert after[2] - before[2] == stats["backward_steps"]


@pytest.mark.cuda
def test_solves_under_autograd_stay_eager_cuda(cuda):
    model, pts = _surrogate(cuda)
    model.saveat = SAVES[:3]
    before = _counts()
    ys = model(_field(pts, cuda))
    after = _counts()
    assert ys.requires_grad
    assert after[:2] == before[:2]
    assert after[2] - before[2] == model.last_stats["steps"]


@pytest.mark.cuda
def test_grand_forward_equals_eager_cuda(cuda, eager):
    """GRAND's GCN right-hand side (fused K2 on a small grid) under
    ``no_grad``: the same logits, bit for bit, and the same counts."""
    g = P.precompute(P.grid_graph_2d(48, 40, diagonals=True),
                     add_self_loops=True, dense=False, pallas=False,
                     bsr=True).to(cuda)
    assert "dia_norm" in g.cache
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(g.num_nodes, 16)).astype(np.float32)).to(cuda)
    model = P.grand_model(16, 16, 3, rtol=1e-5, atol=1e-5,
                          precomputed_self_loops=True,
                          generator=torch.Generator().manual_seed(0),
                          device=cuda)
    P.update_graph(model, g)
    with torch.no_grad():
        with eager:
            want = model(x)
        want_stats = dict(model.layer_2.last_stats)
        before = _counts()
        got = model(x)
        after = _counts()
    stats = model.layer_2.last_stats
    assert torch.equal(got, want) and _same_counts(stats, want_stats)
    assert after[0] - before[0] == 1
    assert after[1] - before[1] == stats["steps"]


@pytest.mark.cuda
def test_spans_and_device_events_cuda(cuda):
    """A replayed attempt is one ``ngpde.dispatch.attempt_graph`` span
    inside ``ngpde.solver.attempt``; only the initial step's evaluations
    open ``ngpde.rhs``; the profiler sees the replayed kernels."""
    model, pts = _surrogate(cuda)
    u0 = _field(pts, cuda)
    acts = torch.profiler.ProfilerActivity
    with torch.inference_mode():
        with torch.profiler.profile(activities=[acts.CPU]) as prof:
            model(u0)
        names = [e.name for e in prof.events()]
        assert names.count("ngpde.dispatch.attempt_capture") == 1
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            model(u0)
            torch.cuda.synchronize()
    stats = model.last_stats
    # the host's spans (with the card traced, each range that launched
    # work also appears on the device's timeline)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    assert names.count("ngpde.dispatch.attempt_graph") == stats["steps"]
    assert names.count("ngpde.solver.attempt") == stats["steps"]
    assert names.count("ngpde.rhs") == 2
    assert "ngpde.dispatch.attempt_capture" not in names
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("fused_mlp_fwd" in n for n in device), device
    assert any("rk_combine_dh_kernel" in n for n in device), device
    assert any("rk_norm_dh_kernel" in n for n in device), device
