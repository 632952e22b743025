"""The port's profiler spans (``neuralgraphpde_torch.utils.profiling``) on
the CPU, on a tiny GRAND model (GCN right-hand side on a grid's DIA
storage) and a tiny VMH model (edge-MLP right-hand side):

- with no profiler running, no ``ngpde.*`` ``record_function`` is made or
  entered, and outputs, gradients and ``last_stats`` keep their bits under
  a profiler;
- under ``torch.profiler``, the spans count what the solver counts and nest
  as the layers do.
"""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.examples import train_vmh  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

MODELS = ("grand", "vmh")
# the conv class and the dispatch path each model's right-hand side takes
# on CPU tensors in each SpMM mode (``pallas`` runs the kernels' plain
# versions)
CONV = {("grand", "auto"): ("GCNConv", "spmm.bsr"),
        ("grand", "pallas"): ("GCNConv", "dia_fused"),
        ("vmh", "auto"): ("VMHConv", "per_edge"),
        ("vmh", "pallas"): ("VMHConv", "k3")}


def _grand():
    g = P.precompute(P.grid_graph_2d(5, 5), add_self_loops=True, dense=False,
                     bsr=True)
    model = P.grand_model(6, 8, 3, precomputed_self_loops=True,
                          generator=torch.Generator().manual_seed(0))
    P.update_graph(model, g)
    x = torch.randn(25, 6, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 3, (25,), generator=torch.Generator().manual_seed(2))
    mask = torch.ones(25, dtype=torch.bool)

    def loss_fn():
        return P.masked_cross_entropy(model(x), y, mask)

    return model, model.layer_2, x, loss_fn


def _vmh():
    pts = np.random.default_rng(0).random((30, 2))
    g = P.precompute(P.delaunay_graph(
        pts, ndata={"x": pts.astype(np.float32)}), dense=False)
    ts = (0.0, 0.05, 0.1)
    model = P.vmh_model(1, 2, hidden=8, msg_dim=4, depth=2, tspan=(0.0, 0.1),
                        saveat=ts, generator=torch.Generator().manual_seed(0))
    P.update_graph(model, g)
    u0 = torch.from_numpy(np.sin(3.0 * pts[:, :1]).astype(np.float32))
    target = torch.stack([u0 * (1.0 - t) for t in ts])

    def loss_fn():
        return P.rollout_mse(model(u0), target)

    return model, model, u0, loss_fn


BUILD = {"grand": _grand, "vmh": _vmh}


def _spans(prof):
    """``(name, start, end, thread)`` of every ``ngpde.*`` span."""
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name.startswith("ngpde.")]


def _parents(spans):
    """Each span's innermost enclosing ``ngpde.*`` span of its thread (None
    at the top), by index into ``spans``."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][3], spans[i][1], -spans[i][2]))
    parent, stack = [None] * len(spans), []
    for i in order:
        _, start, end, tid = spans[i]
        while stack and (spans[stack[-1]][3] != tid
                         or spans[stack[-1]][2] < end):
            stack.pop()
        parent[i] = stack[-1] if stack else None
        stack.append(i)
    return parent


def _within(spans, parent, i, name):
    """Whether span ``i`` lies inside a span called ``name``."""
    j = parent[i]
    while j is not None:
        if spans[j][0] == name:
            return True
        j = parent[j]
    return False


@pytest.mark.parametrize("which", MODELS)
def test_no_record_function_without_profiler(monkeypatch, which):
    """No profiler running: forward, backward and the optimizer make and
    enter no ``ngpde.*`` range; under a profiler the same spy sees them."""
    made = []
    real = torch.autograd.profiler.record_function

    class Spy(real):
        def __init__(self, name, *args):
            made.append(name)
            super().__init__(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    model, _, _, loss_fn = BUILD[which]()
    step = P.make_train_step(loss_fn, P.adam(model.parameters()))
    step()
    assert not [n for n in made if n.startswith("ngpde.")]
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    assert "ngpde.rhs" in made and "ngpde.train.optimizer" in made


@pytest.mark.parametrize("which", MODELS)
def test_results_keep_their_bits_under_profiler(which):
    """Outputs, gradients and the solver's counts are the same bits with and
    without a CPU profiler running."""
    model, ode, _, loss_fn = BUILD[which]()
    runs = []
    for profiled in (False, True):
        model.zero_grad(set_to_none=True)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                loss = loss_fn()
                loss.backward()
        else:
            loss = loss_fn()
            loss.backward()
        runs.append((loss.detach(), dict(ode.last_stats),
                     [p.grad.clone() for p in model.parameters()]))
    (l0, s0, g0), (l1, s1, g1) = runs
    assert torch.equal(l0, l1) and s0 == s1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("which,mode", sorted(CONV))
def test_solver_spans_count_what_the_solver_counts(which, mode):
    """One ``ngpde.rhs`` per evaluation, one attempt and one control span
    per attempted step, every evaluation inside the solve, and each
    evaluation's conv layers, each with one dispatch span naming the path
    taken."""
    model, ode, x, _ = BUILD[which]()
    P.set_spmm_mode(mode)
    try:
        with torch.no_grad(), profile(
                activities=[ProfilerActivity.CPU]) as prof:
            model(x)
    finally:
        P.set_spmm_mode("auto")
    stats = ode.last_stats
    spans = _spans(prof)
    parent = _parents(spans)
    count = Counter(s[0] for s in spans)
    assert count["ngpde.rhs"] == stats["nfe"] > 0
    assert count["ngpde.solver.attempt"] == stats["steps"]
    assert count["ngpde.solver.control"] == stats["steps"]
    assert count["ngpde.solve"] == count["ngpde.solver.init_step"] == 1
    rhs = [i for i, s in enumerate(spans) if s[0] == "ngpde.rhs"]
    assert all(_within(spans, parent, i, "ngpde.solve") for i in rhs)
    cls, path = CONV[which, mode]
    per_rhs = 2 if which == "grand" else 1  # the GCN stack's depth
    for i in rhs:
        convs = [j for j, p in enumerate(parent) if p == i]
        assert [spans[j][0] for j in convs] == [f"ngpde.conv.{cls}"] * per_rhs
        for j in convs:
            kids = [spans[k][0] for k, p in enumerate(parent) if p == j]
            assert kids == [f"ngpde.dispatch.{path}"]


@pytest.mark.parametrize("which", MODELS)
def test_train_step_spans(which):
    """One ``make_train_step`` step: one backward span, then one optimizer
    span, neither inside the other."""
    model, _, _, loss_fn = BUILD[which]()
    step = P.make_train_step(loss_fn, P.adam(model.parameters()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    train = sorted((s for s in _spans(prof)
                    if s[0].startswith("ngpde.train.")), key=lambda s: s[1])
    assert [s[0] for s in train] == ["ngpde.train.backward",
                                     "ngpde.train.optimizer"]
    assert train[0][2] <= train[1][1]


def test_full_batch_epoch_spans():
    """``full_batch_grad`` then ``Rprop.step``, as the VMH training cell
    runs them: a backward span per simulation, then one optimizer span."""
    model, _, u0, _ = _vmh()
    u = torch.stack([torch.stack([u0 * (1.0 - t), u0 * (1.0 - 2 * t),
                                  u0 * (1.0 - 3 * t)])
                     for t in (0.1, 0.2)])
    opt = P.rprop(model.parameters(), 1e-6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_vmh.full_batch_grad(model, u)
        opt.step()
    train = sorted((s for s in _spans(prof)
                    if s[0].startswith("ngpde.train.")), key=lambda s: s[1])
    assert [s[0] for s in train] == ["ngpde.train.backward"] * 2 + [
        "ngpde.train.optimizer"]


def test_backsolve_spans():
    """A backsolve: its forward is one solve; its backward one solve a save
    interval, and one ``ngpde.rhs`` for each evaluation either counts."""
    w = torch.tensor([[-0.5, 0.2], [0.1, -0.3]], requires_grad=True)

    def rhs(t, y, a):
        return torch.tanh(y @ w)

    y0 = torch.tensor([[1.0, -0.5], [0.3, 0.8]])
    ts = (0.0, 0.5, 1.0)
    stats = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ys = P.odeint(rhs, y0, ts, rtol=1e-5, atol=1e-5, adjoint="backsolve",
                      stats=stats)
        ys.sum().backward()
    count = Counter(s[0] for s in _spans(prof))
    assert count["ngpde.rhs"] == stats["nfe"] + stats["backward_nfe"]
    assert count["ngpde.solve"] == 1 + len(ts) - 1
    assert count["ngpde.solver.attempt"] == (stats["steps"]
                                             + stats["backward_steps"])


def test_grid_solve_spans():
    """``odeint_grid``: one solve span, one ``ngpde.rhs`` per stage."""

    def rhs(t, y, a):
        return -y

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        P.odeint_grid(rhs, torch.ones(3), (0.0, 0.5, 1.0), solver="rk4",
                      steps_per_interval=3)
    count = Counter(s[0] for s in _spans(prof))
    assert count["ngpde.solve"] == 1
    assert count["ngpde.rhs"] == 2 * 3 * 4


def test_path_profile_idle_share_uses_the_unprofiled_wall(monkeypatch):
    """``tools/profile_paths.path_profile``: the idle share divides the
    profiled run's device busy time by the un-profiled run's wall, not by
    the profiled wall (which the profiler inflates)."""
    import time

    from neuralgraphpde_torch.tools import profile_paths

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    # 2 ms busy on the device, a profiled wall of 10 s
    monkeypatch.setattr(profile_paths, "profile",
                        lambda fn: ([("k", 0.0, 2000.0, "kernel")], 10.0))

    def path():
        time.sleep(0.02)
        return {}

    rec = profile_paths.path_profile("fake", "auto", path)
    assert rec["profiled_wall_s"] == 10.0 and rec["wall_s"] >= 0.02
    assert rec["idle_share"] == pytest.approx(
        1.0 - 2.0 / (rec["wall_s"] * 1e3), rel=1e-12)
