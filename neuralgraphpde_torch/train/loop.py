"""Training loop pieces (counterparts of ``make_train_step`` and
``MetricsLogger`` in ``neuralgraphpde.train.loop``).

The JAX step is a pure function of ``(params, opt_state, *batch)``; here
the parameters and the optimizer state live in the module and the
``torch.optim`` optimizer, so a step takes the batch alone.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import torch

from ..utils.profiling import annotate


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    has_aux: bool = False):
    """``step(*batch) -> (loss, aux)``: zero the gradients, evaluate
    ``loss_fn(*batch)`` (``(loss, aux)`` with ``has_aux``), backpropagate,
    apply one optimizer update. ``loss`` is returned detached, on its
    device; ``aux`` is None without ``has_aux``. Under a profiler the
    backward and the update run in ``ngpde.train.backward`` and
    ``ngpde.train.optimizer`` spans."""

    def step(*batch):
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(*batch)
        loss, aux = out if has_aux else (out, None)
        with annotate("ngpde.train.backward"):
            loss.backward()
        with annotate("ngpde.train.optimizer"):
            optimizer.step()
        return loss.detach(), aux

    return step


@dataclasses.dataclass
class MetricsLogger:
    """Minimal metrics sink: in-memory history and an optional JSONL
    file."""

    path: Optional[str] = None
    history: List[Dict] = dataclasses.field(default_factory=list)
    _t0: float = dataclasses.field(default_factory=time.time)

    def log(self, step: int, **metrics):
        rec = {"step": step, "wall_time": time.time() - self._t0}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec
