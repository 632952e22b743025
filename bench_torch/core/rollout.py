"""A rollout cell: a closed loop of one client. Each request sends one
initial field from the host, the trained surrogate's forward solve runs
over the save times, and the trajectory comes back to the host; the
latency runs from send to result. Requests cycle through a pool of fields
drawn from the seed."""
from __future__ import annotations

import random
import statistics
import time
from collections import Counter

import numpy as np
import torch

from . import compare
from .cell import initial_weights, read_metrics
from .trace import Trace, profile
from .train import free, halves, phases
from ..traffic.generate import streams

WARMUP = 3
PROFILED = 32


def run(cell, seed: int, seconds: float, trace: bool, device,
        clock) -> dict:
    """One run; ``clock()`` gives seconds since the process started."""
    cfg, mod = cell.config, cell.program
    marks = [clock()]
    data = mod.make_data(cfg, cell.traffic, seed, device)
    # one trained surrogate, committed with the benchmark, serves every
    # seed's requests on the mesh it was trained on
    weights = initial_weights(cell, data, device)
    marks.append(clock())
    prog = mod.rollout_program(cfg, data, device, weights)
    marks.append(clock())
    fields = data["fields"]
    for i in range(WARMUP):
        prog.request(fields[i])
    setup_s = clock()
    marks.append(setup_s)

    pick = random.Random(streams(seed)[3])
    sample_size = cell.traffic["sample"]
    sample, longest = [], None  # (index, trajectory), a reservoir
    lat, stamps, evals, bad = [], [], [], 0
    i = 0
    t0 = time.perf_counter()
    while True:
        sent = time.perf_counter()
        traj, stats = prog.request(fields[i % len(fields)])
        done = time.perf_counter()
        lat.append(done - sent)
        stamps.append(done)
        evals.append(stats["nfe"])
        bad += not bool(torch.isfinite(traj).all())
        if len(sample) < sample_size:
            sample.append((i, traj))
        else:
            j = pick.randrange(i + 1)
            if j < sample_size:
                sample[j] = (i, traj)
        if longest is None or stats["nfe"] > longest[2]:
            longest = (i, traj, stats["nfe"])
        i += 1
        if done - t0 >= seconds:
            break
    wall = stamps[-1] - t0
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    result = dict(attempted=i, failed=bad,
                  diagnostics=dict(requests=i,
                                   p50_ms=statistics.median(lat) * 1e3,
                                   evals_a_request=sum(evals) / i,
                                   evals_counts=dict(sorted(
                                       Counter(evals).items())),
                                   request_ms_halves=halves(stamps, t0),
                                   program_s=prog.build_s,
                                   setup_phases_s=phases(marks)))
    metrics = {
        "rollout_p95_ms": {"value": float(np.percentile(lat, 95)) * 1e3,
                           "unit": "ms"},
        "setup_s": {"value": setup_s, "unit": "s"}}
    if trace:
        reps = min(PROFILED, i)
        k = iter(range(i, i + reps))
        profiled = []
        events, prof_wall = profile(lambda: profiled.append(prog.request(
            fields[next(k) % len(fields)])[1]["nfe"]), reps)
        tr = Trace(events, reps)
        ctx = dict(task="rollout", requests=i, window_s=wall, evals=evals,
                   precompute_s=prog.precompute_s, busy_s=tr.busy_s(),
                   profiled_evals=sum(profiled))
        metrics = read_metrics(cell.per_layer, ctx)
        result.update(busy_s=tr.busy_s(), window_s=prof_wall,
                      breakdown=dict(device_ops=tr.top_ops(),
                                     idle_gaps=tr.idle_gaps()))
        result["diagnostics"]["unlinked_device_events"] = tr.unlinked()

    prog.close()
    del prog
    free(device)
    chosen = sample + ([longest[:2]] if all(longest[0] != s[0]
                                            for s in sample) else [])
    ref = [cell.reference.rollout(cfg, data, weights,
                                  fields[j % len(fields)].to(device))
           for j, _ in chosen]
    got, ref = [t for _, t in chosen], [r.cpu() for r in ref]
    numbers = compare.trajectories(got, ref, cell.saves_compared)
    result["diagnostics"].update(requests_compared=len(chosen),
                                 gap_by_save=compare.by_save(got, ref))
    result.update(metrics=metrics, memory_peak_bytes=peak, numbers=numbers)
    return result
