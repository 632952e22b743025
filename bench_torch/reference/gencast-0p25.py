"""Plain PyTorch ``gencast-0p25``: GenCast's denoiser and its loss as the
paper writes them, on the traffic generator's graphs (``build_graphs``, run
here and not in the inputs' set-up), the mesh in the refinement's own
order.

- Every conditional LayerNorm is ``LN(h) · (1 + c W_s + b_s) + c W_o +
  b_o`` (no scale or offset of its own), ``c`` the noise encoder's output:
  ``MLP(64 → 32 → 16, gelu)`` of ``[sin(ω_k ln σ), cos(ω_k ln σ)]``, ``ω_k
  = 2π/16 · 16^{k/31}``.
- Every MLP is ``CLN(W2 swish(W1 x + b1) + b2)`` (the output MLP without
  the LayerNorm); every interaction network forms ``[e, v_s[s], v_r[r]]``
  for each edge, its edge MLP's output summed at the receivers by
  ``index_add_``, ``v_r ← v_r + φ_v([v_r, Σ m])``.
- Each transformer block: ``x = CLN(h)``, ``q, k, v = x W + b``, per head
  ``softmax((q kᵀ) / √128 over the keys within k hops) v``, ``h ← h + (·)
  W_o + b_o``, then ``h ← h + W2 gelu(W1 CLN(h) + b1) + b2``. The k-hop
  neighbourhoods are a dense ``(mesh, mesh)`` boolean mask, grown from the
  identity by ``k`` products with the mesh's sparse adjacency; the
  attention runs in blocks of ``QUERY_BLOCK`` queries against the keys
  that any of them attends to, each block under ``torch.utils.checkpoint``.
- The denoiser ``D = c_skip z + c_out F([inputs, c_in z])``, ``z = r +
  σε``; the loss ``(σ² + 1)/σ²`` times the area- and level-weighted MSE of
  ``D`` against ``r`` (over the grid points in ``loss_nodes`` where the
  inputs name some); gradients by autograd and the plain AdamW update.

So that a step fits the card in float32, each processor layer, and each
block of ``BLOCK_EDGES`` edges of consecutive receivers of Grid2Mesh and
Mesh2Grid, is recomputed in the backward. Loading the module turns TF32
off, so its products run in true float32; the control
(``bench_torch/control.py``) turns TF32 on around a call of ``train``
after that."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_torch.reference.adamw import AdamW
from bench_torch.traffic.gencast import build_graphs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK_EDGES = 400_000
QUERY_BLOCK = 2048
MASK_COLUMNS = 4096  # mask columns grown at a time


def dense(p, name, x):
    return x @ p[f"{name}.weight"] + p[f"{name}.bias"]


def cln(p, name, h, c):
    y = F.layer_norm(h, (h.shape[-1],), None, None, 1e-5)
    return y * (1.0 + dense(p, f"{name}.scale", c)) + dense(
        p, f"{name}.offset", c)


def mlp(p, name, x, c=None):
    h = dense(p, f"{name}.layer_2", F.silu(dense(p, f"{name}.layer_1", x)))
    return h if c is None else cln(p, f"{name}.layer_3", h, c)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def interaction(p, name, v_s, v_r, e, s, r, c):
    """``v_r'`` of one interaction network over the edges ``s → r`` (``r``
    numbered within ``v_r``'s rows), its edge features embedded first."""
    e = mlp(p, f"{name}.edge_embed", e, c)
    m = mlp(p, f"{name}.edge_mlp", torch.cat([e, v_s[s], v_r[r]], dim=-1), c)
    agg = torch.zeros_like(v_r).index_add_(0, r, m)
    return v_r + mlp(p, f"{name}.node_mlp", torch.cat([v_r, agg], dim=-1), c)


def blocks(r: np.ndarray, n_r: int) -> list:
    """``(r0, r1, e0, e1)``: blocks of consecutive receivers of about
    ``BLOCK_EDGES`` edges each (the edges sorted by receiver)."""
    ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n_r))])
    cuts = np.searchsorted(ptr, np.arange(BLOCK_EDGES, len(r), BLOCK_EDGES))
    rows = np.unique(np.concatenate([[0], cuts, [n_r]]))
    return [(int(a), int(b), int(ptr[a]), int(ptr[b]))
            for a, b in zip(rows, rows[1:])]


def bipartite(p, name, v_s, v_r, s, r, feats, cut, c):
    """Grid2Mesh or Mesh2Grid: the receivers' new latents, block by
    block."""
    out = []
    for r0, r1, e0, e1 in cut:
        def run(v_s, v_r_b, f_b, c, e0=e0, e1=e1, r0=r0):
            return interaction(p, name, v_s, v_r_b, f_b, s[e0:e1],
                               r[e0:e1] - r0, c)

        out.append(checkpoint(run, v_s, v_r[r0:r1], feats[e0:e1], c,
                              use_reentrant=False))
    return torch.cat(out)


def khop_mask(s, r, n, hops, device) -> torch.Tensor:
    """``(n, n)`` bool: node ``j`` within ``hops`` edges of node ``i``
    (itself included), column block by column block: ``R ← R + A R``."""
    adj = torch.sparse_coo_tensor(torch.stack([r, s]),
                                  torch.ones(len(s), device=device), (n, n),
                                  check_invariants=True)
    mask = torch.zeros((n, n), dtype=torch.bool, device=device)
    for a in range(0, n, MASK_COLUMNS):
        b = min(n, a + MASK_COLUMNS)
        reach = torch.zeros((n, b - a), device=device)
        reach[torch.arange(a, b, device=device),
              torch.arange(b - a, device=device)] = 1.0
        for _ in range(hops):
            reach = ((reach + torch.sparse.mm(adj, reach)) > 0).float()
        mask[:, a:b] = reach > 0
    return mask


def _attend(q, k, v, mask, heads):
    """``(queries, heads · d)``: ``q`` against the keys ``k``, ``v``,
    ``mask`` ``(queries, keys)``."""
    n_q, width = q.shape
    d = width // heads
    qh = q.view(n_q, heads, d).transpose(0, 1)
    kh = k.view(-1, heads, d).permute(1, 2, 0)
    vh = v.view(-1, heads, d).transpose(0, 1)
    scores = (qh @ kh) / math.sqrt(d)
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return (p @ vh).transpose(0, 1).reshape(n_q, width)


def attention(q, k, v, mask, heads):
    out = []
    for a in range(0, q.shape[0], QUERY_BLOCK):
        m = mask[a:a + QUERY_BLOCK]
        keys = m.any(dim=0).nonzero()[:, 0]
        out.append(checkpoint(
            lambda qb, kk, vv, mb: _attend(qb, kk, vv, mb, heads),
            q[a:a + QUERY_BLOCK], k[keys], v[keys], m[:, keys],
            use_reentrant=False))
    return torch.cat(out)


def transformer(p, name, h, c, mask, heads):
    x = cln(p, f"{name}.norm_1", h, c)
    o = attention(dense(p, f"{name}.query", x), dense(p, f"{name}.key", x),
                  dense(p, f"{name}.value", x), mask, heads)
    h = h + dense(p, f"{name}.proj", o)
    x = cln(p, f"{name}.norm_2", h, c)
    return h + dense(p, f"{name}.ffw.layer_2",
                     gelu(dense(p, f"{name}.ffw.layer_1", x)))


def noise_cond(cfg, p, sigma):
    k = torch.arange(cfg["noise_frequencies"], dtype=torch.float32,
                     device=sigma.device)
    period = cfg["noise_base_period"]
    w = (2.0 * math.pi / period) * period ** (k / (len(k) - 1))
    a = (w * torch.log(sigma))[None]
    f = torch.cat([torch.sin(a), torch.cos(a)], dim=-1)
    return dense(p, "noise_encoder.layer_2",
                 gelu(dense(p, "noise_encoder.layer_1", f)))


def denoise(cfg, p, x, z, sigma, gr):
    c = noise_cond(cfg, p, sigma)
    s2 = sigma * sigma + 1.0
    inp = torch.cat([x, z / torch.sqrt(s2)], dim=-1)
    vg = mlp(p, "grid_embed", inp, c)
    vm = mlp(p, "mesh_embed", gr["mesh_x"], c)
    vm = bipartite(p, "grid2mesh", vg, vm, *gr["g2m"], c)
    vg = vg + mlp(p, "grid_update", vg, c)
    for i in range(cfg["processor_layers"]):
        vm = checkpoint(
            lambda h, c, i=i: transformer(p, f"processor.{i}", h, c,
                                          gr["mask"], cfg["heads"]),
            vm, c, use_reentrant=False)
    vg = bipartite(p, "mesh2grid", vm, vg, *gr["m2g"], c)
    f = mlp(p, "output", vg)
    return z / s2 + sigma / torch.sqrt(s2) * f


def _graphs(data, device):
    """The generator's graphs of the inputs' mix, and the mesh's k-hop
    mask, on ``device``."""
    built = build_graphs(data["spec"])

    def edges(key):
        s, r, feats = built[key]
        return (torch.as_tensor(s, dtype=torch.int64, device=device),
                torch.as_tensor(r, dtype=torch.int64, device=device),
                torch.as_tensor(feats, device=device))

    gr = {k: edges(k) for k in ("g2m", "m2g")}
    for key, n_r in (("g2m", data["num_mesh"]), ("m2g", data["num_grid"])):
        gr[key] += (blocks(built[key][1], n_r),)
    gr["mesh_x"] = torch.as_tensor(built["mesh_x"], device=device)
    s, r = (torch.as_tensor(a, dtype=torch.int64, device=device)
            for a in built["mesh"])
    gr["mask"] = khop_mask(s, r, data["num_mesh"], data["spec"]["hops"],
                           device)
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
    """Step ``k``'s loss: sample ``k`` modulo the samples, at its noise
    level and noise field."""
    i = k % data["inputs"].shape[0]
    x, r = data["inputs"][i], data["targets"][i]
    sigma = data["sigma"][i]
    z = r + sigma * data["noise"][i]
    d = denoise(cfg, p, x, z, sigma, gr)
    err = ((d - r) ** 2 * chan_w).mean(dim=-1) * data["area_weight"]
    keep = data.get("loss_nodes")
    mse = err.mean() if keep is None else err[keep].mean()
    return (sigma * sigma + 1.0) / (sigma * sigma) * mse


def train(cfg, data, weights, steps, device):
    """``steps`` AdamW steps from ``weights``, one sample each: each step's
    loss, the first gradient, and the parameters' change."""
    gr = _graphs(data, device)
    chan_w = channel_weights(cfg, device)
    p = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
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
