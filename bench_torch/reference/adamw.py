"""Plain AdamW, written from its published rule (Loshchilov and Hutter,
decoupled weight decay)."""
from __future__ import annotations

import torch


class AdamW:
    """``m ← β1 m + (1 − β1) g``, ``v ← β2 v + (1 − β2) g²``, ``θ ← θ − lr ·
    (m̂ / (√v̂ + ε) + wd · θ)`` with the bias corrections, the decay on
    every parameter."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd = weight_decay
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
            p -= self.lr * (m_hat / (torch.sqrt(v_hat) + self.eps)
                            + self.wd * p)
