"""The benchmark's readers of the program's spans (``bench_torch/core/
spans.py``, ``bench_torch/metrics/spans.py``) on a trace built by hand,
against numbers worked out by hand, and on a real CPU profile of a tiny
GRAND solve.

The hand-built trace (µs; main thread 1, autograd thread 2), one step
``bench.step`` over [0, 1000]:

    ngpde.solve            0 – 900
      solver.init_step    10 – 100
        rhs               15 – 60      launch c1 at 30 -> kernel 40–50
      solver.attempt     100 – 800
        rhs              110 – 200     launches c2, c3 -> kernels 135–165,
          conv.VMHConv   115 – 195                        170–180
            dispatch.k3  120 – 190
        rhs              250 – 350     launch c4 -> kernel 265–300;
                                       c7 -> a memcpy 310–320 (no kernel)
        solver.control   400 – 700     launch c5 -> kernel 460–470
    ngpde.train.backward 950 – 1000
    thread 2: launches c6, c8 -> kernels 905–915, 935–945; an autograd op
    650 – 750 over the middle of the gap 470–905

Idle gaps (middle -> innermost main-thread span): 0–40 (rhs) 40,
50–135 (init_step) 85, 165–170 (dispatch.k3) 5, 180–265 (attempt) 85,
300–310 (rhs) 10, 320–460 (attempt) 140, 470–905 (attempt, not the
autograd op) 435, 915–935 (none) 20, 945–1000 (train.backward) 55:
solver 745, rhs 55, trainer 55, outside 20 of 875 µs. Kernels launched in
an ``ngpde.rhs`` span of the main thread: c1–c4, 4 over 3 evaluations.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bench_torch.core import spans  # noqa: E402
from bench_torch.core.trace import Trace, profile  # noqa: E402
from bench_torch.metrics import spans as readers  # noqa: E402


def _host(name, ts, end, tid=1, cat="user_annotation"):
    return dict(ph="X", cat=cat, name=name, tid=tid, ts=ts, dur=end - ts)


def _launch(corr, ts, tid=1):
    return dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", tid=tid,
                ts=ts, dur=2, args=dict(correlation=corr))


def _device(corr, ts, end, cat="kernel"):
    return dict(ph="X", cat=cat, name=f"k{corr}", tid=7, ts=ts, dur=end - ts,
                args=dict(correlation=corr))


def _events(with_spans=True):
    events = [_host("bench.step", 0, 1000)]
    if with_spans:
        events += [
            _host("ngpde.solve", 0, 900),
            _host("ngpde.solver.init_step", 10, 100),
            _host("ngpde.rhs", 15, 60),
            _host("ngpde.solver.attempt", 100, 800),
            _host("ngpde.rhs", 110, 200),
            _host("ngpde.conv.VMHConv", 115, 195),
            _host("ngpde.dispatch.k3", 120, 190),
            _host("ngpde.rhs", 250, 350),
            _host("ngpde.solver.control", 400, 700),
            _host("ngpde.train.backward", 950, 1000),
        ]
    events += [
        _host("autograd::engine::evaluate_function: MmBackward0", 650, 750,
              tid=2, cat="cpu_op"),
        _launch(1, 30), _launch(2, 130), _launch(3, 140), _launch(4, 260),
        _launch(7, 305), _launch(5, 450), _launch(6, 902, tid=2),
        _launch(8, 930, tid=2),
        _device(1, 40, 50), _device(2, 135, 165), _device(3, 170, 180),
        _device(4, 265, 300), _device(7, 310, 320, cat="gpu_memcpy"),
        _device(5, 460, 470), _device(6, 905, 915), _device(8, 935, 945),
    ]
    return events


def test_rhs_launches_by_hand():
    tr = Trace(_events(), 1)
    assert spans.rhs_launches(tr) == (4, 3)
    assert readers.rhs_launches(dict(trace=tr)) == pytest.approx(4 / 3)


def test_solver_idle_share_by_hand():
    tr = Trace(_events(), 1)
    idle = spans.idle_by_layer(tr)
    want = dict(solver=745e-6, rhs=55e-6, trainer=55e-6, outside=20e-6)
    assert idle == pytest.approx(want)
    assert readers.solver_idle_share(dict(trace=tr)) == pytest.approx(
        100.0 * 745 / 875)
    split = spans.idle_shares(tr)
    assert split == pytest.approx({k: 100.0 * v / 875e-6
                                   for k, v in want.items()})
    assert sum(split.values()) == pytest.approx(100.0)


def test_span_counts_by_hand():
    tr = Trace(_events() + _events()[1:11], 2)  # the spans twice, 2 steps
    counts = spans.span_counts(tr)
    assert counts["ngpde.rhs"] == 3.0
    assert counts["ngpde.dispatch.k3"] == counts["ngpde.solve"] == 1.0


@pytest.mark.parametrize("ctx", [
    dict(trace=Trace(_events(with_spans=False), 1)),  # a program with none
    dict(),  # a run that hands no trace
], ids=["no_spans", "no_trace"])
def test_readers_read_nothing_without_spans(ctx):
    assert readers.rhs_launches(ctx) is None
    assert readers.solver_idle_share(ctx) is None


def test_readers_on_a_cpu_profile():
    """A real profile (CPU, so no device events): the main thread's
    ``ngpde.rhs`` spans are the solve's evaluations, no kernel is counted,
    and the idle split sums to 100 (one gap here, the whole window, given
    to one layer)."""
    import neuralgraphpde_torch as P

    g = P.precompute(P.grid_graph_2d(5, 5), add_self_loops=True)
    model = P.grand_model(6, 8, 3, precomputed_self_loops=True,
                          generator=torch.Generator().manual_seed(0))
    P.update_graph(model, g)
    x = torch.randn(25, 6, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        events, _ = profile(lambda: model(x), 2)
    tr = Trace(events, 2)
    nfe = model.layer_2.last_stats["nfe"]
    assert spans.rhs_launches(tr) == (0, 2 * nfe)
    assert spans.span_counts(tr)["ngpde.rhs"] == nfe
    assert readers.rhs_launches(dict(trace=tr)) == 0.0
    split = spans.idle_shares(tr)
    assert sorted(split.values()) == pytest.approx([0.0, 0.0, 0.0, 100.0])
