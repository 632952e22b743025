"""Plain PyTorch ``graphcast-0p25``: GraphCast's equations as the paper
writes them, on the traffic generator's graphs (``build_graphs``, run here
and not in the inputs' set-up). Every MLP is ``LN(W2
swish(W1 x + b1) + b2)`` (the output MLP without the LayerNorm); every
interaction network forms ``[e, v_s[s], v_r[r]]`` for each edge, its edge
MLP's output ``m`` summed at the receivers by ``index_add_``, ``v_r ← v_r
+ φ_v([v_r, Σ m])`` and, in the processor, ``e ← e + m``. The prediction
is the last input state plus the output; the loss the area- and
level-weighted MSE (over the grid points in ``loss_nodes`` where the inputs
name some); gradients by autograd and the plain AdamW update.

So that a step fits the card in float32, each processor layer, and each
block of ``BLOCK_EDGES`` edges of consecutive receivers of Grid2Mesh and
Mesh2Grid, is recomputed in the backward (``torch.utils.checkpoint``).
The LayerNorm scales (``*.layer_3.weight``) are the drawn leaves plus one.
Loading the module turns TF32 off, so its products run in true float32; the
control (``bench_torch/control.py``) turns TF32 on around a call of
``train`` after that."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_torch.reference.adamw import AdamW
from bench_torch.traffic.graphcast import build_graphs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK_EDGES = 400_000


def mlp(p, name, x, norm=True):
    h = F.silu(x @ p[f"{name}.layer_1.weight"] + p[f"{name}.layer_1.bias"])
    h = h @ p[f"{name}.layer_2.weight"] + p[f"{name}.layer_2.bias"]
    if norm:
        h = F.layer_norm(h, (h.shape[-1],), p[f"{name}.layer_3.weight"][0],
                         p[f"{name}.layer_3.bias"][0], 1e-5)
    return h


def interaction(p, name, v_s, v_r, e, s, r, embed):
    """``(m, v_r')`` of one interaction network over the edges ``s → r``
    (``r`` numbered within ``v_r``'s rows)."""
    if embed:
        e = mlp(p, f"{name}.edge_embed", e)
    m = mlp(p, f"{name}.edge_mlp", torch.cat([e, v_s[s], v_r[r]], dim=-1))
    agg = torch.zeros_like(v_r).index_add_(0, r, m)
    return m, v_r + mlp(p, f"{name}.node_mlp", torch.cat([v_r, agg], dim=-1))


def blocks(r: np.ndarray, n_r: int) -> list:
    """``(r0, r1, e0, e1)``: blocks of consecutive receivers of about
    ``BLOCK_EDGES`` edges each (the edges sorted by receiver)."""
    ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n_r))])
    cuts = np.searchsorted(ptr, np.arange(BLOCK_EDGES, len(r), BLOCK_EDGES))
    rows = np.unique(np.concatenate([[0], cuts, [n_r]]))
    return [(int(a), int(b), int(ptr[a]), int(ptr[b]))
            for a, b in zip(rows, rows[1:])]


def bipartite(p, name, v_s, v_r, s, r, feats, cut):
    """Grid2Mesh or Mesh2Grid: the receivers' new latents, block by
    block."""
    out = []
    for r0, r1, e0, e1 in cut:
        def run(v_s, v_r_b, f_b, e0=e0, e1=e1, r0=r0):
            return interaction(p, name, v_s, v_r_b, f_b, s[e0:e1],
                               r[e0:e1] - r0, True)[1]

        out.append(checkpoint(run, v_s, v_r[r0:r1], feats[e0:e1],
                              use_reentrant=False))
    return torch.cat(out)


def forward(cfg, p, x, gr):
    vg = mlp(p, "grid_embed", x)
    vm = mlp(p, "mesh_embed", gr["mesh_x"])
    vm = bipartite(p, "grid2mesh", vg, vm, *gr["g2m"])
    vg = vg + mlp(p, "grid_update", vg)
    s, r, feats = gr["mesh"]
    e = mlp(p, "mesh_edge_embed", feats)
    for i in range(cfg["processor_layers"]):
        def layer(vm, e, i=i):
            m, v = interaction(p, f"processor.{i}", vm, vm, e, s, r, False)
            return e + m, v
        e, vm = checkpoint(layer, vm, e, use_reentrant=False)
    vg = bipartite(p, "mesh2grid", vm, vg, *gr["m2g"])
    return mlp(p, "output", vg, norm=False)


def _graphs(data, device):
    """The generator's graphs of the inputs' mix, on ``device``."""
    built = build_graphs(data["spec"])

    def edges(key):
        s, r, feats = built[key]
        return (torch.as_tensor(s, dtype=torch.int64, device=device),
                torch.as_tensor(r, dtype=torch.int64, device=device),
                torch.as_tensor(feats, device=device))

    gr = {k: edges(k) for k in ("mesh", "g2m", "m2g")}
    for key, n_r in (("g2m", data["num_mesh"]), ("m2g", data["num_grid"])):
        gr[key] += (blocks(built[key][1], n_r),)
    gr["mesh_x"] = torch.as_tensor(built["mesh_x"], device=device)
    return gr


def channel_weights(cfg, device):
    """The atmospheric levels by pressure over their mean, each variable
    alike, then the surface variables' weights."""
    levels = np.asarray(cfg["levels_hpa"], np.float64)
    w = [levels / levels.mean()] * len(cfg["atmospheric_variables"])
    w.append(np.asarray(list(cfg["surface_weights"].values())))
    return torch.as_tensor(np.concatenate(w), dtype=torch.float32,
                           device=device)


def loss(cfg, data, p, k, gr, chan_w):
    """Step ``k``'s loss: sample ``k`` modulo the samples."""
    i = k % data["inputs"].shape[0]
    x, y = data["inputs"][i], data["targets"][i]
    a, b = cfg["input_channels"]["state_t"]
    pred = x[:, a:b] + forward(cfg, p, x, gr)
    err = ((pred - y) ** 2 * chan_w).mean(dim=-1) * data["area_weight"]
    keep = data.get("loss_nodes")
    return err.mean() if keep is None else err[keep].mean()


def train(cfg, data, weights, steps, device):
    """``steps`` AdamW steps from ``weights``, one sample each: each step's
    loss, the first gradient, and the parameters' change."""
    gr = _graphs(data, device)
    chan_w = channel_weights(cfg, device)
    p = {k: (v.detach().clone() + float(k.endswith("layer_3.weight")))
         .requires_grad_() for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in p.items()}
    b1, b2 = cfg["betas"]
    opt = AdamW(cfg["lr"], b1, b2, cfg["eps"], cfg["weight_decay"])
    out = dict(losses=[], grads=None)
    for k in range(steps):
        value = loss(cfg, data, p, k, gr, chan_w)
        grads = dict(zip(p, torch.autograd.grad(value, list(p.values()))))
        out["losses"].append(float(value.detach()))
        if k == 0:
            out["grads"] = grads
        opt.update(p, grads)
        del value
    out["change"] = {k: p[k].detach() - start[k] for k in p}
    return out
