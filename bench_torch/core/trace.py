"""Device time from ``torch.profiler``'s trace (CUPTI): busy time, the
largest device operations, idle gaps by what the host was doing, and the
device time of a layer's calls by their profiler ranges.

``busy_us`` and the reading of device events follow the port's
``tools/profile_paths.py`` (copied: the yardstick stays with the
benchmark)."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from .layers import RANGE

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
STEP = "bench.step"
EVALUATE = "autograd::engine::evaluate_function: "
NAME = 120  # characters of a device operation's name kept


def busy_us(spans) -> float:
    """Length of the union of ``(start, dur)`` intervals."""
    total, end = 0.0, -float("inf")
    for start, dur in sorted(spans):
        stop = start + dur
        if start >= end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def profile(fn, reps: int):
    """Run ``fn`` ``reps`` times under the profiler, each in a
    ``bench.step`` range. Returns ``(trace events, host seconds)``."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            with torch.autograd.profiler.record_function(STEP):
                fn()
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X"], seconds


class Trace:
    """The events of one profiled run of ``reps`` steps."""

    def __init__(self, events, reps: int):
        self.reps = reps
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        steps = [e for e in self.host if e["name"] == STEP]
        self.main_tid = steps[0]["tid"] if steps else None
        self.start = min(e["ts"] for e in steps) if steps else 0.0
        self.stop = (max(e["ts"] + e["dur"] for e in steps) if steps
                     else 0.0)
        self.launch = {e["args"]["correlation"]: (e["tid"], e["ts"])
                       for e in events if e.get("cat") in LAUNCH_CATS
                       and "correlation" in e.get("args", {})}

    def busy_s(self) -> float:
        return busy_us([(e["ts"], e["dur"]) for e in self.device]) / 1e6

    def unlinked(self) -> int:
        """Device events with no launch event to tie them to the host."""
        return sum(e.get("args", {}).get("correlation") not in self.launch
                   for e in self.device)

    def top_ops(self, k: int = 10):
        """``[name, seconds a step]`` of the device operations that took
        most time, by name."""
        by_name = defaultdict(float)
        for e in self.device:
            by_name[e["name"][:NAME]] += e["dur"] / 1e6 / self.reps
        return sorted(([n, s] for n, s in by_name.items()),
                      key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10):
        """``[host op, seconds a step]``: the device's idle time inside the
        steps, each gap given to the innermost host operation running at
        its middle (of any thread, the one that started last; the steps'
        own range stands for host code between operations), summed by
        that operation's name."""
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        gaps, end = [], self.start
        for s, t in spans:
            if s > end:
                gaps.append((end, s))
            end = max(end, t)
        if self.stop > end:
            gaps.append((end, self.stop))
        ops = defaultdict(list)
        for e in self.host:
            name = "host code between operations" if e["name"] == STEP \
                else e["name"]
            ops[e["tid"]].append((e["ts"], e["ts"] + e["dur"], name))
        for v in ops.values():
            v.sort()
        stacks = {tid: [] for tid in ops}
        nexts = dict.fromkeys(ops, 0)
        by_name = defaultdict(float)
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            tops = []
            for tid, lst in ops.items():
                stack, i = stacks[tid], nexts[tid]
                while i < len(lst) and lst[i][0] <= mid:
                    while stack and stack[-1][1] <= lst[i][0]:
                        stack.pop()
                    stack.append(lst[i])
                    i += 1
                nexts[tid] = i
                while stack and stack[-1][1] <= mid:
                    stack.pop()
                if stack:
                    tops.append(stack[-1])
            name = max(tops)[2] if tops else "(no host op)"
            by_name[name] += (b - a) / 1e6 / self.reps
        return sorted(([n, s] for n, s in by_name.items()),
                      key=lambda kv: -kv[1])[:k]

    def layer_device_s(self, calls) -> tuple:
        """Device seconds of the hooked calls' forward ranges and of the
        backward of the nodes they made, and the sum of those calls'
        least times: ``(device s, bound s, forward calls, backward
        calls)``. ``calls``: ``LayerCalls.calls`` in call order; each
        call's bound counts its backward only where the trace holds that
        backward."""
        from .peaks import bound_s

        ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.host
                        if e["name"] == RANGE and e["tid"] == self.main_tid)
        if len(ranges) != len(calls):
            raise RuntimeError(f"{len(ranges)} {RANGE} ranges in the trace "
                               f"for {len(calls)} calls")
        seq_lo = [c[0] for c in calls if c[0] is not None and c[1] > c[0]]
        seq_call = [i for i, c in enumerate(calls)
                    if c[0] is not None and c[1] > c[0]]
        bwd = defaultdict(list)  # tid -> [(start, stop, call)]
        for e in self.host:
            seq = e.get("args", {}).get("Sequence number")
            if seq is None or not e["name"].startswith(EVALUATE):
                continue
            j = bisect.bisect_left(seq_lo, seq) - 1
            if j >= 0 and seq <= calls[seq_call[j]][1]:
                bwd[e["tid"]].append((e["ts"], e["ts"] + e["dur"],
                                      seq_call[j]))
        for v in bwd.values():
            v.sort()
        starts = [r[0] for r in ranges]
        bstarts = {tid: [v[0] for v in lst] for tid, lst in bwd.items()}
        device = 0.0
        with_bwd = set()
        for e in self.device:
            where = self.launch.get(e.get("args", {}).get("correlation"))
            if where is None:
                continue
            tid, ts = where
            if tid == self.main_tid:
                j = bisect.bisect_right(starts, ts) - 1
                if j >= 0 and ts < ranges[j][1]:
                    device += e["dur"]
                    continue
            if tid in bwd:
                j = bisect.bisect_right(bstarts[tid], ts) - 1
                if j >= 0 and ts < bwd[tid][j][1]:
                    device += e["dur"]
        for lst in bwd.values():
            with_bwd.update(c for _, _, c in lst)
        bound = sum(bound_s(c[2].ops, c[2].bytes) for c in calls)
        bound += sum(bound_s(calls[i][3].ops, calls[i][3].bytes)
                     for i in with_bwd)
        return device / 1e6, bound, len(calls), len(with_bwd)
