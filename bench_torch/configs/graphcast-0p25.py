"""``graphcast-0p25`` on the port: ``GraphCast`` at its published 0.25°
widths on the graphs ``graph.sphere.graphcast_graphs`` builds,
``precompute``d (``models.graphcast.precompute_graphs``: Grid2Mesh and
Mesh2Grid in the configuration's receiver blocks) and under recomputation,
trained by ``make_train_step`` with ``adamw`` on the weighted MSE of one
sample a step; and its counts of work.

Weights: every leaf is named as the port's parameter; the LayerNorm
scales (the leaves ``*.layer_3.weight``: an MLP of one hidden layer ends
in its LayerNorm as its third child) are drawn as zeros and offset by one
here and in the reference, since ``draw_weights`` knows zeros and Glorot
alone."""
from __future__ import annotations

import time

import numpy as np
import torch

import neuralgraphpde_torch as ngp
from neuralgraphpde_torch.models import graphcast as gc
from neuralgraphpde_torch.train import losses

from bench_torch.core import graphcast_counts as gcc
from bench_torch.traffic.graphcast import graphcast

LN_SCALE = "layer_3.weight"


def _mlp_spec(prefix, dims, norm=True):
    spec = []
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        spec += [(f"{prefix}.layer_{i + 1}.weight", (a, b), "glorot_uniform"),
                 (f"{prefix}.layer_{i + 1}.bias", (1, b), "zeros")]
    if norm:
        n = len(dims)
        spec += [(f"{prefix}.layer_{n}.weight", (1, dims[-1]), "zeros"),
                 (f"{prefix}.layer_{n}.bias", (1, dims[-1]), "zeros")]
    return spec


def weight_spec(cfg, data):
    L = cfg["latent"]

    def conv(prefix, embed):
        return ((_mlp_spec(f"{prefix}.edge_embed", (cfg["edge_in"], L, L))
                 if embed else [])
                + _mlp_spec(f"{prefix}.edge_mlp", (3 * L, L, L))
                + _mlp_spec(f"{prefix}.node_mlp", (2 * L, L, L)))

    spec = (_mlp_spec("grid_embed", (cfg["grid_in"], L, L))
            + _mlp_spec("mesh_embed", (cfg["node_in"], L, L))
            + _mlp_spec("mesh_edge_embed", (cfg["edge_in"], L, L))
            + conv("grid2mesh", True)
            + _mlp_spec("grid_update", (L, L, L)))
    for i in range(cfg["processor_layers"]):
        spec += conv(f"processor.{i}", False)
    return (spec + conv("mesh2grid", True)
            + _mlp_spec("output", (L, L, cfg["grid_out"]), norm=False))


def channel_weights(cfg) -> np.ndarray:
    """Each target channel's loss weight: every atmospheric variable's
    levels by pressure over the levels' mean, then the surface
    variables'."""
    p = np.asarray(cfg["levels_hpa"], np.float64)
    atmos = np.tile(p / p.mean(), len(cfg["atmospheric_variables"]))
    w = np.concatenate([atmos, list(cfg["surface_weights"].values())])
    if len(w) != cfg["grid_out"]:
        raise ValueError("the loss weights do not cover grid_out channels")
    return w.astype(np.float32)


def make_data(cfg, traffic, seed, device):
    """The samples and the mix's sizes (``traffic.graphcast.graphcast``),
    no graphs: the program builds its own, the reference the
    generator's."""
    spec = traffic["graphcast"]
    if (spec["inputs"], spec["targets"]) != (cfg["grid_in"],
                                             cfg["grid_out"]):
        raise ValueError("the traffic's channels are not the "
                         "configuration's grid_in and grid_out")
    return {**graphcast(traffic, seed, device), "spec": spec}


class Program:
    """One AdamW step a sample: the job's step ``k`` (the optimizer's
    count, which the window's restore puts back) trains on sample ``k``
    modulo the mix's samples. ``step()`` returns the interaction networks'
    passes over their edges in the step, recomputed ones included
    (``models.graphcast.interaction_forwards``)."""

    def __init__(self, cfg, data, device, weights):
        spec = data["spec"]  # the mix's grid and mesh
        t0 = time.perf_counter()
        graphs = ngp.graphcast_graphs(spec["splits"], spec["n_lat"],
                                      spec["n_lon"], spec["radius_fraction"])
        built = time.perf_counter()
        sizes = dict(num_grid=graphs.mesh2grid.num_nodes,
                     num_mesh=graphs.mesh.num_nodes,
                     mesh_edges=graphs.mesh.num_edges,
                     grid2mesh_edges=graphs.grid2mesh.num_edges,
                     mesh2grid_edges=graphs.mesh2grid.num_edges)
        for key, n in sizes.items():  # what step_flops counts from
            if data[key] != n:
                raise ValueError(f"graphcast: {key} {n}, the mix gives "
                                 f"{data[key]}")
        blocks = (cfg["blocks"]["grid2mesh"], cfg["blocks"]["mesh2grid"])
        _sync(device)
        t1 = time.perf_counter()
        prepared = {k: g.to(device) for k, g in
                    gc.precompute_graphs(graphs, blocks).items()}
        _sync(device)
        self.precompute_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        with torch.device("meta"):  # shapes only: the weights come next
            model = ngp.GraphCast(
                cfg["grid_in"], cfg["grid_out"], cfg["latent"],
                cfg["processor_layers"], cfg["node_in"], cfg["edge_in"],
                recompute=True)
        model = model.to_empty(device=device).set_graphs(prepared)
        self.params = {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[name] + float(name.endswith(LN_SCALE)))
                self.params[name] = p
        b1, b2 = cfg["betas"]
        self.opt = ngp.adamw(model.parameters(), cfg["lr"], b1, b2,
                             cfg["eps"], cfg["weight_decay"])
        x, y = data["inputs"], data["targets"]
        node_w = torch.from_numpy(gc.area_weights(graphs.grid_lat)).to(device)
        chan_w = torch.from_numpy(channel_weights(cfg)).to(device)
        a, b = cfg["input_channels"]["state_t"]
        first = next(model.parameters())

        def loss():
            state = self.opt.state.get(first)
            i = (int(state["step"]) if state else 0) % x.shape[0]
            pred = x[i][:, a:b] + model(x[i])
            return losses.weighted_mse(pred, y[i], node_w, chan_w)

        self._step = ngp.make_train_step(loss, self.opt)
        self.model = model
        self.conv_modules = [model.grid2mesh, *model.processor,
                             model.mesh2grid]
        _sync(device)
        self.build_s = dict(graphs=built - t0, precompute=self.precompute_s,
                            model=time.perf_counter() - t2)

    def step(self):
        before = gc.interaction_forwards
        loss, _ = self._step()
        return loss, gc.interaction_forwards - before

    def first_grads(self):
        """The first gradient as AdamW holds it after one step: its first
        moment is ``(1 − β1) g``."""
        b1 = self.opt.param_groups[0]["betas"][0]
        return {k: self.opt.state[p].get("exp_avg", torch.zeros_like(p))
                / (1 - b1) for k, p in self.params.items()}

    def close(self):
        self.model = self._step = self.opt = None
        self.conv_modules = []
        self.params = {}


def train_program(cfg, data, device, weights):
    return Program(cfg, data, device, weights)


def _sizes(cfg, data, module):
    g = module.graph
    n_s = g.num_senders if g.bipartite else g.num_nodes
    edge_in = cfg["edge_in"] if module.edge_embed is not None else None
    return (n_s, g.num_nodes, g.num_edges, cfg["latent"], edge_in,
            module.keep_edges)


def conv_work(cfg, data, module, x, out):
    """One ``InteractionConv`` call at its least work
    (``graphcast_counts``), whatever its blocks and recomputation."""
    sizes = _sizes(cfg, data, module)
    return (gcc.interaction_forward(*sizes),
            gcc.interaction_backward(*sizes))


def evals(cfg, solves):
    """The interaction networks' passes over their edges in a step,
    forward and recomputed (``Program.step``'s count)."""
    return solves


def step_flops(cfg, data, solves):
    """Operations of one step from shapes: every embedder, conv and MLP
    forward and backward at its least work, and the loss. Recomputation
    and the optimizer's update are left out."""
    L, n_g, n_m = cfg["latent"], data["num_grid"], data["num_mesh"]
    e_m, e_g2m, e_m2g = (data[k] for k in ("mesh_edges", "grid2mesh_edges",
                                           "mesh2grid_edges"))

    def mlp(n, dims, norm=True, input_grad=False):
        return (gcc.mlp_forward(n, dims, norm).ops
                + gcc.mlp_backward(n, dims, norm, input_grad).ops)

    def conv(*sizes):
        return (gcc.interaction_forward(*sizes).ops
                + gcc.interaction_backward(*sizes).ops)

    e_in = cfg["edge_in"]
    return (mlp(n_g, (cfg["grid_in"], L, L))
            + mlp(n_m, (cfg["node_in"], L, L))
            + mlp(e_m, (e_in, L, L))
            + conv(n_g, n_m, e_g2m, L, e_in, False)
            + mlp(n_g, (L, L, L), input_grad=True) + 2 * n_g * L
            + cfg["processor_layers"] * conv(n_m, n_m, e_m, L, None, True)
            + conv(n_m, n_g, e_m2g, L, e_in, False)
            + mlp(n_g, (L, L, cfg["grid_out"]), norm=False, input_grad=True)
            + gcc.weighted_mse(n_g, cfg["grid_out"]).ops)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def half_batch(data):
    """The inputs with the loss taken over the first half of the grid
    points only (a planted fault)."""
    keep = torch.zeros(data["num_grid"], dtype=torch.bool,
                       device=data["targets"].device)
    keep[: data["num_grid"] // 2] = True
    return {**data, "loss_nodes": keep}
