"""One captured CUDA graph in place of a layer's eager forward, or of a
solver's attempted step.

A layer whose forward launches many small kernels on fixed shapes spends
more host time on Python, the dispatcher and the launches than the card
spends on the work. ``CapturedCall`` records such a call once as a
``torch.cuda.CUDAGraph`` and replays it: one launch of the whole graph,
the same kernels with the same launch configurations on the same inputs.

- Capture: ``fn(*xs)`` runs once eagerly on the capture stream first, so
  that an error raises exactly as it does eagerly before anything is
  recorded, and lazily made state (cuBLAS's workspace for the stream, the
  kernels' modules) exists before the capture; then ``fn`` runs again
  under ``torch.cuda.graph`` on the same inputs, which become the static
  inputs every replay reads (the caller's buffers). A call that cannot be
  captured (one that reads a value home, say) leaves it without a graph
  (``graph is None``), and the caller runs it eagerly.
- Replay: ``call(x)`` copies a layer's one input into the static input,
  replays the graph on the current stream and returns a copy of the static
  output (a solver keeps several evaluations alive at once, each with its
  own values). ``replay()`` alone returns the static outputs themselves,
  for a caller that manages the static inputs and outputs itself.
- What a replay reads: every tensor ``fn`` closed over, at the address it
  had at capture, and every global setting it read then. In-place updates
  (an optimizer's step) are read as they stand; a replaced tensor or a
  changed setting is not, so the caller's key must change with them:
  ``capture_key`` is the gate and key of every captured call of a module,
  to which a caller adds only the terms it reads itself.
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

from ..graph.gnngraph import GnnGraph
from ..kernels import add_launch_counts, launch_counts
from ..ops.spmm import get_spmm_mode

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


def held_graphs(module: nn.Module) -> tuple:
    """The graphs the layers under ``module`` hold (``layer.graph``, which
    ``update_graph`` replaces), each once, in the order of
    ``module.modules()``."""
    out = {}
    for m in module.modules():
        g = getattr(m, "graph", None)
        if isinstance(g, GnnGraph):
            out.setdefault(id(g), g)
    return tuple(out.values())


def on_card(x: torch.Tensor) -> bool:
    """``x`` is on the card (a test stands another answer in)."""
    return x.is_cuda


def capture_key(module: nn.Module, x: torch.Tensor) -> Optional[tuple]:
    """The gate and key of a captured call of ``module`` on inputs like
    ``x``: ``(key, graphs)``, or None where the call runs eagerly.

    Eager: autograd on (a graph records no backward), ``x`` not on the card,
    a capture in progress on the stream (the caller is being recorded into
    an outer graph, which takes its kernels directly), or a parameter that
    is not a registered ``Parameter`` (``param_ptrs``). The key: ``x``'s
    shape, dtype and device, inference mode, the parameters' addresses, the
    ids of the graphs the module holds and the SpMM mode; ``graphs``, to be
    held with the capture so that those ids stay theirs."""
    if (torch.is_grad_enabled() or not on_card(x)
            or torch.cuda.is_current_stream_capturing()):
        return None
    ptrs = param_ptrs(module)
    if ptrs is None:
        return None
    graphs = held_graphs(module)
    return (x.shape, x.dtype, x.device, torch.is_inference_mode_enabled(),
            ptrs, tuple(map(id, graphs)), get_spmm_mode()), graphs


class CapturedCall:
    """``fn`` captured on the static inputs ``xs`` under ``key``; ``keep``
    holds objects whose identity the key names, so that their ids stay
    theirs. ``pool``: another capture's memory pool to share, for calls
    that never run at once and read nothing another leaves in the pool
    but their static outputs."""

    def __init__(self, key, fn: Callable, *xs: torch.Tensor, keep=None,
                 pool=None):
        self.key, self.keep = key, keep
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.added = {}
        device = xs[0].device
        side = _STREAMS.get(device)
        if side is None:
            side = _STREAMS[device] = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(*xs)
        torch.cuda.current_stream(device).wait_stream(side)
        self.static_in = xs
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side):
                self.static_out = fn(*self.static_in)
        except RuntimeError as err:
            warnings.warn(f"a call could not be captured as a CUDA graph "
                          f"and runs eagerly: {err}", stacklevel=3)
            self.static_in = self.static_out = None
            return
        finally:
            after = launch_counts()
            self.added = {k: after[k] - n for k, n in before.items()
                          if after[k] != n}
            add_launch_counts({k: -n for k, n in self.added.items()})
        self.graph = graph

    def replay(self):
        """Replay on the current stream; the static outputs."""
        self.graph.replay()
        add_launch_counts(self.added)
        return self.static_out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.static_in[0].copy_(x)
        return self.replay().clone()
