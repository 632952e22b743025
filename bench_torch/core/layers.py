"""Profiler ranges around a layer's calls, pushed from module hooks, and
the work each call does, counted from its shapes.

Each call of a hooked module runs inside a ``bench.conv`` range and
records the sequence numbers of the autograd nodes it created: those
above a probe node made on entry, up to its output's node. The backward
of those nodes shows in the trace as ``autograd::engine::
evaluate_function`` events with the same sequence numbers, so its kernels
are the call's too, whatever they are named."""
from __future__ import annotations

from typing import Callable, List

import torch

RANGE = "bench.conv"


def _sequence_nr() -> int:
    """The sequence number of a fresh autograd node: every node made after
    it has a larger one."""
    with torch.enable_grad():
        probe = torch.zeros((), requires_grad=True) * 1
    return probe.grad_fn._sequence_nr()


class LayerCalls:
    """While attached, records every call of ``modules``: ``(lo, hi,
    forward work, backward work)``, its nodes' sequence numbers in ``(lo,
    hi]`` (``hi = lo`` when it made none). ``work(module, x, out)``
    returns ``(forward Work, backward Work)`` of the call."""

    def __init__(self, modules: List[torch.nn.Module], work: Callable):
        self.modules, self.work = modules, work
        self.calls: list = []
        self._open: list = []
        self._handles: list = []

    def _pre(self, module, args):
        rf = torch.autograd.profiler.record_function(RANGE)
        rf.__enter__()
        lo = _sequence_nr() if torch.is_grad_enabled() else None
        self._open.append((rf, lo))

    def _post(self, module, args, out):
        rf, lo = self._open.pop()
        rf.__exit__(None, None, None)
        hi = lo
        if lo is not None and out.grad_fn is not None:
            hi = out.grad_fn._sequence_nr()
        fwd, bwd = self.work(module, args[0], out)
        self.calls.append((lo, hi, fwd, bwd))

    def __enter__(self):
        for m in self.modules:
            self._handles.append(m.register_forward_pre_hook(self._pre))
            self._handles.append(m.register_forward_hook(self._post))
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles.clear()
