"""One captured CUDA graph in place of a layer's eager forward.

A layer whose forward launches many small kernels on fixed shapes spends
more host time on Python, the dispatcher and the launches than the card
spends on the work. ``CapturedCall`` records such a forward once as a
``torch.cuda.CUDAGraph`` and replays it: one launch of the whole graph,
the same kernels with the same launch configurations on the same inputs.

- Capture: ``fn(x)`` runs once eagerly on the capture stream first, so
  that an error raises exactly as it does eagerly before anything is
  recorded, and lazily made state (cuBLAS's workspace for the stream, the
  kernels' modules) exists before the capture; then ``fn`` runs again
  under ``torch.cuda.graph`` on a static copy of the input. A forward that
  cannot be captured (one that reads a value home, say) leaves the call
  without a graph (``graph is None``), and the caller runs it eagerly.
- Replay: the input is copied into the static input, the graph replays on
  the current stream, and a copy of the static output comes back (a
  solver keeps several evaluations alive at once, each with its own
  values).
- What a replay reads: every tensor ``fn`` closed over, at the address it
  had at capture. In-place updates (an optimizer's step) are read as they
  stand; a replaced tensor is not, so the caller's key must change with
  the addresses (``param_ptrs``).
- Launch counters: the kernel wrappers count each launch in Python
  (``kernels.launch_counts``), and a capture records launches without
  running them.
  A capture takes back what it added to the counters, and each replay adds
  it again, so the counters keep counting launches on the card.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch
from torch import nn

from ..kernels import add_launch_counts, launch_counts

# one capture stream a device, as ``torch.cuda.graph``'s own: cuBLAS keeps
# a workspace (32 MiB on the H100) for every stream it runs on
_STREAMS = {}


def _ptrs(module: nn.Module, out: list) -> bool:
    for p in module._parameters.values():
        if p is not None:
            if not isinstance(p, nn.Parameter):
                return False
            out.append(p.data_ptr())
    for child in module._modules.values():
        if child is not None and not _ptrs(child, out):
            return False
    return True


def param_ptrs(module: nn.Module) -> Optional[tuple]:
    """The data pointers of every parameter under ``module``, in
    registration order; None when one of them is not a registered
    ``Parameter`` (a tensor swapped in for one call, as
    ``torch.func.functional_call`` and the precision wrapper do, would
    have a graph captured anew on every call)."""
    out = []
    return tuple(out) if _ptrs(module, out) else None


class CapturedCall:
    """``fn`` captured for inputs like ``x`` under ``key``; ``keep`` holds
    objects whose identity the key names, so that their ids stay theirs."""

    def __init__(self, key, fn: Callable, x: torch.Tensor, keep=None):
        self.key, self.keep = key, keep
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.added = {}
        side = _STREAMS.get(x.device)
        if side is None:
            side = _STREAMS[x.device] = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            fn(x)
        torch.cuda.current_stream(x.device).wait_stream(side)
        self.static_in = torch.empty_like(x, memory_format=torch.
                                          contiguous_format).copy_(x)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                self.static_out = fn(self.static_in)
        except RuntimeError as err:
            warnings.warn(f"the forward could not be captured as a CUDA "
                          f"graph and runs eagerly: {err}", stacklevel=3)
            self.static_in = self.static_out = None
            return
        finally:
            after = launch_counts()
            self.added = {k: after[k] - n for k, n in before.items()
                          if after[k] != n}
            add_launch_counts({k: -n for k, n in self.added.items()})
        self.graph = graph

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.static_in.copy_(x)
        self.graph.replay()
        add_launch_counts(self.added)
        return self.static_out.clone()
