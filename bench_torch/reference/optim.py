"""Plain optimizer updates, written from their published rules."""
from __future__ import annotations

import torch


class Adam:
    """Adam (Kingma and Ba): ``m ← β1 m + (1 − β1) g``, ``v ← β2 v + (1 −
    β2) g²``, ``θ ← θ − lr · m̂ / (√v̂ + ε)`` with the bias corrections."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m, self.v = {}, {}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        self.t += 1
        for k, p in params.items():
            g = grads[k]
            m = self.m.get(k, torch.zeros_like(p)) * self.b1 + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(p)) * self.b2 + (
                1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            m_hat = m / (1 - self.b1 ** self.t)
            v_hat = v / (1 - self.b2 ** self.t)
            p -= self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)


class RpropMinus:
    """Rprop− (Riedmiller and Braun): per entry, with ``s = g · g_prev``,
    the step grows by ``eta_plus`` (capped) when ``s > 0``, shrinks by
    ``eta_minus`` (floored) when ``s < 0`` and then skips the update and
    forgets the gradient, and stays when ``s = 0``; ``θ ← θ − sign(g) ·
    step``."""

    def __init__(self, lr: float, etas=(0.5, 1.2), step_sizes=(1e-8, 50.0)):
        self.lr = lr
        self.eta_minus, self.eta_plus = etas
        self.step_min, self.step_max = step_sizes
        self.step, self.prev = {}, {}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        for k, p in params.items():
            g = grads[k]
            step = self.step.get(k, torch.full_like(p, self.lr))
            prev = self.prev.get(k, torch.zeros_like(p))
            s = g * prev
            grow = torch.clamp(step * self.eta_plus, max=self.step_max)
            shrink = torch.clamp(step * self.eta_minus, min=self.step_min)
            step = torch.where(s > 0, grow, torch.where(s < 0, shrink, step))
            g = torch.where(s < 0, torch.zeros_like(g), g)
            p -= torch.sign(g) * step
            self.step[k], self.prev[k] = step, g
