"""The program's own spans in a profiled run (``ngpde.*`` ranges that
``neuralgraphpde_torch.utils.profiling.annotate`` opens while a profiler
runs), read against the device events of the same trace: the kernels
launched inside right-hand-side evaluations, and the device's idle time
split by the program's layer that the host was in.

Only spans of the thread that ran the steps count: the autograd engine's
thread on the card opens none on the checkpoint adjoint's replay, and an
aten op on any thread is not a span of the program."""
from __future__ import annotations

import bisect
from collections import Counter

from .trace import Trace

PREFIX = "ngpde."
RHS = "ngpde.rhs"
LAYERS = ("solver", "rhs", "trainer", "outside")


def layer_of(name: str) -> str:
    """The layer a span belongs to: ``solver`` (``ngpde.solve``,
    ``ngpde.solver.*``), ``trainer`` (``ngpde.train.*``), or ``rhs`` (an
    evaluation, a conv layer's call and its dispatch, also a conv outside a
    solve such as GRAND's encoder)."""
    if name == "ngpde.solve" or name.startswith("ngpde.solver."):
        return "solver"
    if name.startswith("ngpde.train."):
        return "trainer"
    return "rhs"


def program_spans(tr: Trace) -> list:
    """``(start, stop, name)`` of the main thread's ``ngpde.*`` spans, by
    start."""
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in tr.host
                  if e["tid"] == tr.main_tid
                  and e["name"].startswith(PREFIX))


def span_counts(tr: Trace) -> dict:
    """``ngpde.*`` spans a step or request, by name, on every thread."""
    counts = Counter(e["name"] for e in tr.host
                     if e["name"].startswith(PREFIX))
    return {n: c / tr.reps for n, c in sorted(counts.items())}


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def rhs_launches(tr: Trace) -> tuple:
    """``(kernels, evaluations)``: the device kernels whose launch lies in
    an ``ngpde.rhs`` span of the main thread (tied by correlation id), and
    the number of those spans."""
    spans = [(a, b) for a, b, n in program_spans(tr) if n == RHS]
    merged = _union(spans)
    starts = [a for a, _ in merged]
    kernels = 0
    for e in tr.device:
        if e.get("cat") != "kernel":
            continue
        where = tr.launch.get(e.get("args", {}).get("correlation"))
        if where is None or where[0] != tr.main_tid:
            continue
        j = bisect.bisect_right(starts, where[1]) - 1
        kernels += j >= 0 and where[1] < merged[j][1]
    return kernels, len(spans)


def idle_gaps_us(tr: Trace) -> list:
    """``(start, stop)`` of the device's idle gaps inside the steps, as
    ``Trace.idle_gaps`` finds them."""
    gaps, end = [], tr.start
    for s, t in sorted((e["ts"], e["ts"] + e["dur"]) for e in tr.device):
        if s > end:
            gaps.append((end, s))
        end = max(end, t)
    if tr.stop > end:
        gaps.append((end, tr.stop))
    return gaps


def idle_by_layer(tr: Trace) -> dict:
    """Seconds of device idle time a step, by the layer of the innermost
    ``ngpde.*`` span of the main thread open at each gap's middle
    (``outside`` where none is)."""
    spans = program_spans(tr)
    out = dict.fromkeys(LAYERS, 0.0)
    stack, i = [], 0
    for a, b in sorted(idle_gaps_us(tr), key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(spans) and spans[i][0] <= mid:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        layer = layer_of(stack[-1][2]) if stack else "outside"
        out[layer] += (b - a) / 1e6 / tr.reps
    return out


def idle_shares(tr: Trace):
    """``idle_by_layer`` in % of the idle time (the diagnostic
    ``idle_by_program_span``); None when the device never idled."""
    idle = idle_by_layer(tr)
    total = sum(idle.values())
    return {k: 100.0 * v / total for k, v in idle.items()} if total else None
