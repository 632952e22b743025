"""Readers of the program's own spans (``core/spans.py``), for the metrics
of one quantity in cells of different end-to-end metrics
(``rhs.launches.*``, ``solver.idle_share.*``). Each reads the traced run's
``Trace`` from ``ctx["trace"]`` and returns None where the run holds none,
or no ``ngpde.rhs`` span (a program that opens no spans)."""
from bench_torch.core import spans


def _trace(ctx):
    tr = ctx.get("trace")
    if tr is None or not any(n == spans.RHS
                             for _, _, n in spans.program_spans(tr)):
        return None
    return tr


def rhs_launches(ctx):
    """Device kernels launched inside an ``ngpde.rhs`` span of the main
    thread, a span: forward evaluations only (autograd's replay opens no
    span)."""
    tr = _trace(ctx)
    if tr is None:
        return None
    kernels, evals = spans.rhs_launches(tr)
    return kernels / evals


def solver_idle_share(ctx):
    """The share of the device's idle time in the profiled steps whose gap
    has a solver span (``ngpde.solve``, ``ngpde.solver.*``) as the innermost
    ``ngpde.*`` span of the main thread at its middle, in %."""
    tr = _trace(ctx)
    shares = None if tr is None else spans.idle_shares(tr)
    return None if shares is None else shares["solver"]
