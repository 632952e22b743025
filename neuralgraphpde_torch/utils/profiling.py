"""Program spans for ``torch.profiler`` (counterpart of
``neuralgraphpde.utils.profiling.annotate``).

``annotate(name)`` is a ``record_function`` range while a profiler runs and
one shared no-op context otherwise: an idle ``record_function`` still costs
microseconds to enter and leave, the check one C call. The spans land in
the profiler's own trace, beside the device events on its clock.
Every name starts with ``ngpde.``:

- ``ngpde.solve``: one adaptive or fixed-grid solve (``odeint``,
  ``odeint_grid``, ``solve_stats``), or one save interval of a backsolve's
  backward;
- ``ngpde.solver.init_step``, ``ngpde.solver.attempt`` (one per attempted
  step), ``ngpde.solver.control`` (the error ratio read home and the next
  step size);
- ``ngpde.rhs``: one right-hand-side evaluation that the solver counts;
- ``ngpde.conv.<Class>``: one conv layer's forward, and inside it
  ``ngpde.dispatch.<path>``, the path taken (for ``VMHConv`` with autograd
  off: ``ngpde.dispatch.vmh_graph``, one replay of its captured CUDA
  graph, and ``ngpde.dispatch.vmh_capture`` where a call captures it);
- ``ngpde.gno.kernel_net``: a ``GKNModel`` forward's one evaluation of
  its kernel network's layers but the last, on every edge;
- ``ngpde.train.backward``, ``ngpde.train.optimizer``.
"""
from __future__ import annotations

import contextlib
import functools

import torch

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A ``record_function(name)`` range while a profiler runs, else a
    no-op context."""
    if _profiling():
        return torch.autograd.profiler.record_function(name)
    return _OFF


def annotated(name: str):
    """Decorator: the function's calls run inside ``annotate(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
