"""Plain PyTorch ``vmh-convdiff``: ϕ on every edge of the traffic's edge
list, the mean at the receivers by a scatter-add, γ per node, the plain
Tsit5 solve over the save times, the rollout MSE per simulation, and the
plain Rprop− update."""
from __future__ import annotations

import torch

from bench_torch.reference.optim import RpropMinus
from bench_torch.reference.tsit5 import solve


def _mlp(h, p, name, layers):
    for k in range(layers):
        h = h @ p[f"{name}.{k}.weight"] + p[f"{name}.{k}.bias"]
        if k < layers - 1:
            h = torch.tanh(h)
    return h


def make_rhs(cfg, data, p, device):
    s = torch.as_tensor(data["senders"], dtype=torch.int64, device=device)
    r = torch.as_tensor(data["receivers"], dtype=torch.int64, device=device)
    pos = torch.as_tensor(data["pos"], device=device)
    n, layers = data["num_nodes"], cfg["depth"] + 1
    deg = torch.zeros(n, device=device).index_add_(
        0, r, torch.ones(len(r), device=device)).clamp_min(1.0)
    dpos = pos[s] - pos[r]

    def rhs(t, u):
        ui, uj = u[r], u[s]
        msg = _mlp(torch.cat([ui, uj - ui, dpos], dim=-1), p, "phi", layers)
        m = torch.zeros(n, msg.shape[1], device=device).index_add_(
            0, r, msg) / deg[:, None]
        return _mlp(torch.cat([u, m], dim=-1), p, "gamma", layers)

    return rhs


def train(cfg, data, weights, steps, device):
    """``steps`` full-batch Rprop− steps from ``weights``: each step's loss
    (the mean over simulations of each one's rollout MSE), the first
    gradient and the parameters' change."""
    p = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
    rhs = make_rhs(cfg, data, p, device)
    opt = RpropMinus(cfg["lr"], cfg["etas"], cfg["step_sizes"])
    u = data["u"]
    sims = u.shape[0]
    out = dict(losses=[], grads=None)
    for k in range(steps):
        grads = {name: torch.zeros_like(v) for name, v in p.items()}
        total = 0.0
        for sim in range(sims):
            ys, _ = solve(rhs, u[sim, 0], data["ts"], cfg["rtol"],
                          cfg["atol"], cfg["max_steps"])
            loss = torch.mean((ys - u[sim]) ** 2) / sims
            for name, g in zip(p, torch.autograd.grad(loss,
                                                      list(p.values()))):
                grads[name] += g
            total += float(loss.detach())
        out["losses"].append(total)
        if k == 0:
            out["grads"] = grads
        opt.update(p, grads)
    out["change"] = {k: p[k].detach() - weights[k] for k in p}
    return out


@torch.no_grad()
def rollout(cfg, data, weights, u0):
    """The trajectory ``(T, M, 1)`` from the initial field ``u0``."""
    rhs = make_rhs(cfg, data, weights, u0.device)
    ys, _ = solve(rhs, u0, data["ts"], cfg["rtol"], cfg["atol"],
                  cfg["max_steps"])
    return ys
