"""Plain PyTorch ``grand-gcn``: the GCN as a gather and a scatter-add over
the self-looped edge list in the traffic's own node numbering, the
plain Tsit5 solve, the masked cross-entropy written out, and the plain
Adam update."""
from __future__ import annotations

import numpy as np
import torch

from bench_torch.reference.optim import Adam
from bench_torch.reference.tsit5 import solve

ACT = {"relu": torch.relu, "tanh": torch.tanh}


def _graph(data, device):
    n = data["num_nodes"]
    loops = np.arange(n)
    s = torch.as_tensor(np.concatenate([data["senders"], loops]),
                        dtype=torch.int64, device=device)
    r = torch.as_tensor(np.concatenate([data["receivers"], loops]),
                        dtype=torch.int64, device=device)
    deg = torch.zeros(n, device=device).index_add_(
        0, r, torch.ones(len(r), device=device))
    return s, r, deg.rsqrt()


def gcn(x, w, b, act, s, r, c):
    """``act(D^-1/2 (A + I) D^-1/2 x W + b)``, summed at the receivers."""
    z = (x * c[:, None]).index_select(0, s)
    agg = torch.zeros_like(x).index_add_(0, r, z) * c[:, None]
    return ACT[act](agg @ w + b)


def loss_and_stats(cfg, data, p, s, r, c):
    h = gcn(data["x"], p["encoder.weight"], p["encoder.bias"],
            cfg["encoder_activation"], s, r, c)

    def rhs(t, u):
        for k in range(cfg["rhs_depth"]):
            u = gcn(u, p[f"rhs.{k}.weight"], p[f"rhs.{k}.bias"],
                    cfg["rhs_activation"], s, r, c)
        return u

    ys, stats = solve(rhs, h, cfg["tspan"], cfg["rtol"], cfg["atol"])
    logits = ys[-1] @ p["decoder.weight"] + p["decoder.bias"]
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(1, data["y"][:, None])[:, 0]
    mask = data["mask"].to(logp.dtype)
    return -(picked * mask).sum() / mask.sum(), stats


def train(cfg, data, weights, steps, device):
    """``steps`` Adam steps from ``weights``: each step's loss, the first
    gradient, and the parameters' change."""
    s, r, c = _graph(data, device)
    p = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
    b1, b2 = cfg["betas"]
    opt = Adam(cfg["lr"], b1, b2, cfg["eps"])
    out = dict(losses=[], grads=None)
    for k in range(steps):
        loss, _ = loss_and_stats(cfg, data, p, s, r, c)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        out["losses"].append(float(loss.detach()))
        if k == 0:
            out["grads"] = grads
        opt.update(p, grads)
    out["change"] = {k: p[k].detach() - weights[k] for k in p}
    return out
