"""The readers that metrics of one quantity in cells of different
end-to-end metrics share (``<quantity>.train`` and ``<quantity>.epoch``):
each metric's own file names its reader here."""
from bench_torch.core.peaks import F32_FLOP_PER_S


def mfu(ctx):
    """The whole training step's share of the card's f32 peak: the
    operations of the window's steps (the configuration's count from shapes
    and each step's solver counts) over the window's wall time at 67
    TFLOP/s, in %."""
    if ctx["task"] != "train" or not ctx["flops"]:
        return None
    return 100.0 * sum(ctx["flops"]) / (ctx["window_s"] * F32_FLOP_PER_S)


def conv_roofline(ctx):
    """The conv layers' share of their roofline over the profiled steps, in
    %: the sum over their calls (forward, and backward where the trace
    holds it) of the least time the work counted from shapes can take, over
    the device time of every kernel launched inside those calls' ranges or
    by the backward of the autograd nodes they made, whatever the kernels
    are named."""
    if ctx["task"] != "train" or not ctx.get("conv_device_s"):
        return None
    return 100.0 * ctx["conv_bound_s"] / ctx["conv_device_s"]


def rhs_evals(ctx):
    """Right-hand-side evaluations a step or a request, forward and (in
    training) replayed backward, over the window (the solver's
    ``last_stats``)."""
    if not ctx["evals"]:
        return None
    return sum(ctx["evals"]) / len(ctx["evals"])


def idle_share(ctx):
    """The device's idle share, in %: 1 − the busy time (the union of the
    device events) of the profiled steps or requests over the window's
    un-profiled wall time, each per right-hand-side evaluation, since the
    solver's evaluations vary."""
    if not ctx["busy_s"] or not ctx["evals"]:
        return None
    busy = ctx["busy_s"] / ctx["profiled_evals"]
    wall = ctx["window_s"] / sum(ctx["evals"])
    return 100.0 * (1.0 - busy / wall)
