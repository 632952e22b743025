"""Plain PyTorch ``gno-darcy``: the graph kernel network's equations as
written, ``v_{t+1} = ReLU(W v_t + mean_{j→i} κ(e_ij) v_t(j) + b)``, with
the kernel matrix of every edge, ``κ(e) = reshape(φ(e), width × width)``,
formed by the whole kernel network at every iteration as one ``(E, width,
width)`` tensor, the messages summed at the receivers by ``index_add_``
and divided by the in-degree; the MSE of one sample a step (over the nodes
in ``loss_nodes`` where the inputs name some), gradients by autograd and
the plain Adam update. Each iteration's messages are recomputed in the
backward (``torch.utils.checkpoint``), so one iteration's kernel matrices
are alive at a time. Loading the module turns TF32 off, so its products
run in true float32; the control (``bench_torch/control.py``) turns TF32
on around a call of ``train`` after that."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bench_torch.reference.optim import Adam

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _graph(data, device):
    s = torch.as_tensor(data["senders"], dtype=torch.int64, device=device)
    r = torch.as_tensor(data["receivers"], dtype=torch.int64, device=device)
    deg = torch.zeros(data["num_nodes"], device=device).index_add_(
        0, r, torch.ones(len(r), device=device))
    return s, r, deg


def kernel_matrices(cfg, p, e_feat):
    """``κ(e)`` for every edge, ``(E, width, width)``: the kernel network
    (ReLU after every layer but the last) on the edges' features."""
    h, layers = e_feat, 3
    for i in range(layers):
        h = h @ p[f"kernel.{i}.weight"] + p[f"kernel.{i}.bias"]
        if i < layers - 1:
            h = torch.relu(h)
    w = cfg["width"]
    return h.reshape(-1, w, w)


def mean_messages(kappa, v, s, r, deg):
    """``mean_{e→i} κ_e^T v[s_e]``: every edge's message ``Σ_i v[s_e, i]
    κ_e[i, o]``, summed at its receiver, over the receiver's in-degree."""
    msg = torch.einsum("eio,ei->eo", kappa, v[s])
    agg = torch.zeros((len(deg), kappa.shape[2]), dtype=msg.dtype,
                      device=msg.device).index_add_(0, r, msg)
    return agg / deg[:, None]


def forward(cfg, p, feats, a, pos, s, r, deg):
    """The solution ``(N, out)`` of one sample: ``feats`` ``(N, 6)``, ``a``
    ``(N, 1)``, ``pos`` ``(N, 2)``; an edge's features ``[a_i, x_i, a_j,
    x_j]``, i the receiver."""
    e_feat = torch.cat([a[r], pos[r], a[s], pos[s]], dim=-1)

    def message(v):
        return mean_messages(kernel_matrices(cfg, p, e_feat), v, s, r, deg)

    v = feats @ p["lift.weight"] + p["lift.bias"]
    for _ in range(cfg["depth"]):
        m = checkpoint(message, v, use_reentrant=False)
        v = torch.relu(v @ p["root.weight"] + m + p["root.bias"])
    return v @ p["proj.weight"] + p["proj.bias"]


def loss(cfg, data, p, k, s, r, deg):
    """Step ``k``'s loss: sample ``k`` modulo the samples."""
    i = k % data["feats"].shape[0]
    out = forward(cfg, p, data["feats"][i], data["a"][i], data["pos"], s, r,
                  deg)
    err = (out - data["y"][i]) ** 2
    keep = data.get("loss_nodes")
    return err.mean() if keep is None else err[keep].mean()


def train(cfg, data, weights, steps, device):
    """``steps`` Adam steps from ``weights``, one sample each: each step's
    loss, the first gradient, and the parameters' change."""
    s, r, deg = _graph(data, device)
    p = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
    b1, b2 = cfg["betas"]
    opt = Adam(cfg["lr"], b1, b2, cfg["eps"])
    out = dict(losses=[], grads=None)
    for k in range(steps):
        value = loss(cfg, data, p, k, s, r, deg)
        grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
        out["losses"].append(float(value.detach()))
        if k == 0:
            out["grads"] = grads
        opt.update(p, grads)
    out["change"] = {k: p[k].detach() - weights[k] for k in p}
    return out
