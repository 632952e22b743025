"""Optimizers with the JAX package's names and defaults (counterparts of
``neuralgraphpde.train.optim``): ``adam`` and Rprop−; and ``adamw``, which
the JAX package does not have.

``adam`` is ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8 added outside the square root, no weight decay): the same update
as ``optax.adam``. ``adamw`` is ``torch.optim.AdamW``, Adam with decoupled
weight decay, ``p ← p − lr · (m̂ / (√v̂ + eps) + wd · p)`` (``optax.adamw``'s
update; torch scales ``p`` by ``1 − lr · wd`` first, the same to
rounding).

Rprop− (resilient backprop) is a sign-based step per parameter entry.

For each entry, with ``s = g · g_prev``: the step size grows by
``eta_plus`` (capped at ``step_max``) when ``s > 0``, shrinks by
``eta_minus`` (floored at ``step_min``) when ``s < 0``, and is kept when
``s == 0``, so it is clamped only in the direction it moves. On a sign
change the gradient is zeroed for this step (no update), and the gradient
stored for the next step is the one after that zeroing. The update is
``−sign(g) · step``. ``torch.optim.Rprop`` clamps in both directions on
every step, so it differs from this where a step size starts outside
``[step_min, step_max]``.
"""
from __future__ import annotations

from typing import Iterable

import torch

from ..utils.profiling import annotate


def adam(params: Iterable, learning_rate: float = 1e-2) -> torch.optim.Adam:
    """``torch.optim.Adam`` with the JAX ``adam``'s default learning rate and
    optax's moments (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def adamw(params: Iterable, learning_rate: float = 1e-3,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` with optax's ``adamw`` argument names and
    defaults (GraphCast trains with b2 0.95 and weight decay 0.1)."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(b1, b2),
                             eps=eps, weight_decay=weight_decay)


class Rprop(torch.optim.Optimizer):
    """Rprop− with the JAX package's update rule (module docstring); under
    a profiler its update runs in an ``ngpde.train.optimizer`` span."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 etas=(0.5, 1.2), step_sizes=(1e-8, 50.0)):
        super().__init__(params, dict(lr=lr, etas=tuple(etas),
                                      step_sizes=tuple(step_sizes)))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        with annotate("ngpde.train.optimizer"):
            for group in self.param_groups:
                eta_minus, eta_plus = group["etas"]
                step_min, step_max = group["step_sizes"]
                for p in group["params"]:
                    if p.grad is None:
                        continue
                    state = self.state[p]
                    if not state:
                        state["step_size"] = torch.full_like(p, group["lr"])
                        state["prev_grad"] = torch.zeros_like(p)
                    g, eta = p.grad, state["step_size"]
                    sign = g * state["prev_grad"]
                    eta = torch.where(
                        sign > 0, torch.clamp(eta * eta_plus, max=step_max),
                        torch.where(
                            sign < 0,
                            torch.clamp(eta * eta_minus, min=step_min), eta))
                    g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
                    p.add_(-torch.sign(g_eff) * eta)
                    state["step_size"] = eta
                    state["prev_grad"] = g_eff
        return loss


def rprop(params: Iterable, learning_rate: float = 1e-3,
          eta_minus: float = 0.5, eta_plus: float = 1.2,
          step_min: float = 1e-8, step_max: float = 50.0) -> Rprop:
    """``Rprop`` with the JAX ``rprop``'s argument names and defaults."""
    return Rprop(params, lr=learning_rate, etas=(eta_minus, eta_plus),
                 step_sizes=(step_min, step_max))
