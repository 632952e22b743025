"""A training cell: set-up builds the configuration's training step and
drives it from the seed through its first three steps (the steps the
reference follows); the window then replays episodes of those steps with
the same step object for ``--seconds``, each episode from the state set-up
started in. Each step ends in the loss read on the host."""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from . import compare
from .cell import initial_weights, read_metrics
from .layers import LayerCalls
from .trace import Trace, profile

CHECKED_STEPS = 3
LONG_STEP_S = 0.25  # a step longer than this is profiled alone


def _snapshot(params: dict) -> dict:
    return {k: p.detach().clone() for k, p in params.items()}


def first_steps(prog) -> dict:
    """Drive a fresh training step object through its first
    ``CHECKED_STEPS`` steps: each step's loss, the first gradient as the
    optimizer holds it, and the parameters' change."""
    init = _snapshot(prog.params)
    losses = []
    for k in range(CHECKED_STEPS):
        loss, _ = prog.step()
        losses.append(float(loss))
        if k == 0:
            grads = {n: g.detach().clone() for n, g in
                     prog.first_grads().items()}
    change = {k: p.detach() - init[k] for k, p in prog.params.items()}
    return dict(losses=losses, grads=grads, change=change)


def _state(prog) -> dict:
    """A copy of the step object's parameters and optimizer state."""
    return dict(params=_snapshot(prog.params),
                opt={k: {name: v.clone() if torch.is_tensor(v) else v
                         for name, v in prog.opt.state[p].items()}
                     for k, p in prog.params.items()})


@torch.no_grad()
def _restore(prog, state: dict) -> None:
    """Put the step object back in ``state``, in place; an optimizer state
    that was empty is dropped, so the next step starts it anew."""
    for k, p in prog.params.items():
        p.copy_(state["params"][k])
        saved = state["opt"][k]
        if not saved:
            prog.opt.state.pop(p, None)
            continue
        held = prog.opt.state[p]
        for name, v in saved.items():
            if torch.is_tensor(v):
                held[name].copy_(v)
            else:
                held[name] = v


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(cell, seed: int, seconds: float, trace: bool, device,
        clock) -> dict:
    """One run; ``clock()`` gives seconds since the process started."""
    cfg, mod = cell.config, cell.program
    marks = [clock()]
    data = mod.make_data(cfg, cell.traffic, seed, device)
    weights = initial_weights(cell, data, device)
    _sync(device)
    marks.append(clock())
    prog = mod.train_program(cfg, data, device, weights)
    marks.append(clock())
    # the window replays episodes of the job's first steps: back to the
    # state set-up started from (the same object), so that every window
    # and every seed does the same work however many steps it holds
    episode = cell.traffic["episode_steps"]
    start = _state(prog)
    checked = first_steps(prog)
    _sync(device)
    setup_s = clock()
    marks.append(setup_s)

    stamps, evals, flops, bad = [], [], [], 0
    t0 = time.perf_counter()
    while True:
        if len(stamps) % episode == 0:
            _restore(prog, start)
        loss, solves = prog.step()
        value = float(loss)
        stamps.append(time.perf_counter())
        bad += not math.isfinite(value)
        evals.append(mod.evals(cfg, solves))
        flops.append(mod.step_flops(cfg, data, solves))
        if stamps[-1] - t0 >= seconds:
            break
    wall = stamps[-1] - t0
    steps = len(stamps)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)

    result = dict(attempted=steps, failed=bad,
                  diagnostics=dict(steps=steps,
                                   evals_a_step=sum(evals) / steps,
                                   step_ms_halves=halves(stamps, t0),
                                   program_s=prog.build_s,
                                   setup_phases_s=phases(marks)))
    # the cell's own name for a step's time (train_step_ms, epoch_ms)
    step_metric = next(m["name"] for m in cell.end_to_end
                       if m["name"] != "setup_s")
    metrics = {step_metric: {
                   "value": wall / steps * 1e3, "unit": "ms"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    if trace:
        _restore(prog, start)
        metrics, extra = _traced(cell, prog, data, stamps, evals, flops,
                                 wall)
        extra["diagnostics"].update(result["diagnostics"])
        result.update(extra)

    prog.close()
    del prog, loss
    free(device)
    ref = cell.reference.train(cfg, data, weights, CHECKED_STEPS, device)
    numbers = compare.training(checked, ref)
    result.update(metrics=metrics, memory_peak_bytes=peak, numbers=numbers)
    return result


def _traced(cell, prog, data, stamps, evals, flops, wall):
    """The per-layer metrics: counters of the un-profiled window, then a
    few steps under the profiler with the layer's calls in ranges."""
    cfg, mod = cell.config, cell.program
    reps = (1 if wall / len(stamps) > LONG_STEP_S
            else cell.traffic["episode_steps"])
    calls = LayerCalls(prog.conv_modules,
                       lambda m, x, out: mod.conv_work(cfg, data, m, x, out))
    profiled = []
    with calls:
        events, prof_wall = profile(
            lambda: profiled.append(mod.evals(cfg, prog.step()[1])), reps)
    tr = Trace(events, reps)
    conv = tr.layer_device_s(calls.calls)
    ctx = dict(task="train", steps=len(stamps), window_s=wall,
               evals=evals, flops=flops, precompute_s=prog.precompute_s,
               busy_s=tr.busy_s(), profiled_evals=sum(profiled),
               conv_device_s=conv[0], conv_bound_s=conv[1])
    extra = dict(busy_s=tr.busy_s(), window_s=prof_wall,
                 breakdown=dict(device_ops=tr.top_ops(),
                                idle_gaps=tr.idle_gaps()),
                 diagnostics=dict(unlinked_device_events=tr.unlinked(),
                                  conv_calls=conv[2],
                                  conv_calls_with_backward=conv[3]))
    return read_metrics(cell.per_layer, ctx), extra


def halves(stamps, t0) -> list:
    """Median ms a step in the window's first and second halves: a drift
    inside one run shows as two different numbers."""
    ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
    h = max(1, len(ms) // 2)
    return [statistics.median(ms[:h]), statistics.median(ms[h:] or ms)]


def phases(marks) -> dict:
    """Set-up's parts in seconds from its clock's marks: process start to
    the harness (imports, the card), inputs and weights, the program
    (``precompute`` in it), the checked or warm-up steps."""
    names = ("imports", "inputs", "program", "first_steps")
    return {n: b - a for n, a, b in zip(names, [0.0] + marks, marks)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
