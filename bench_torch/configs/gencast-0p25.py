"""``gencast-0p25`` on the port: ``GenCast``'s denoiser at its published
0.25° widths on the graphs ``graph.sphere.gencast_graphs`` builds (the M6
mesh in its local order), ``precompute``d (``models.gencast.
precompute_graphs``: the 32-hop attention layout built on the card,
Grid2Mesh and Mesh2Grid in the configuration's receiver blocks) and under
recomputation, trained by ``make_train_step`` with ``adamw`` on the
EDM-weighted MSE of one sample a step, at the noise level and with the
noise field the traffic drew for it; and its counts of work.

Weights: every leaf is named as the port's parameter."""
from __future__ import annotations

import time

import numpy as np
import torch

import neuralgraphpde_torch as ngp
from neuralgraphpde_torch.kernels.attention_kernels import mesh_attention
from neuralgraphpde_torch.models import gencast as gcm
from neuralgraphpde_torch.models.graphcast import area_weights
from neuralgraphpde_torch.train import losses

from bench_torch.core import gencast_counts as gnc
from bench_torch.core import graphcast_counts as gcc
from bench_torch.traffic.gencast import gencast


def _dense_spec(prefix, a, b):
    return [(f"{prefix}.weight", (a, b), "glorot_uniform"),
            (f"{prefix}.bias", (1, b), "zeros")]


def _mlp_spec(prefix, dims, cond=None):
    spec = []
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        spec += _dense_spec(f"{prefix}.layer_{i + 1}", a, b)
    if cond:
        spec += _cln_spec(f"{prefix}.layer_{len(dims)}", dims[-1], cond)
    return spec


def _cln_spec(prefix, dims, cond):
    return (_dense_spec(f"{prefix}.scale", cond, dims)
            + _dense_spec(f"{prefix}.offset", cond, dims))


def weight_spec(cfg, data):
    L, c = cfg["latent"], cfg["noise_mlp"][-1]

    def conv(prefix):
        return (_mlp_spec(f"{prefix}.edge_embed", (cfg["edge_in"], L, L), c)
                + _mlp_spec(f"{prefix}.edge_mlp", (3 * L, L, L), c)
                + _mlp_spec(f"{prefix}.node_mlp", (2 * L, L, L), c))

    spec = (_mlp_spec("noise_encoder", (2 * cfg["noise_frequencies"],
                                        *cfg["noise_mlp"]))
            + _mlp_spec("grid_embed", (cfg["grid_in"], L, L), c)
            + _mlp_spec("mesh_embed", (cfg["node_in"], L, L), c)
            + conv("grid2mesh") + _mlp_spec("grid_update", (L, L, L), c))
    for i in range(cfg["processor_layers"]):
        p = f"processor.{i}"
        spec += _cln_spec(f"{p}.norm_1", L, c)
        for name in ("query", "key", "value", "proj"):
            spec += _dense_spec(f"{p}.{name}", L, L)
        spec += (_cln_spec(f"{p}.norm_2", L, c)
                 + _mlp_spec(f"{p}.ffw", (L, cfg["ffw_hidden"], L)))
    return (spec + conv("mesh2grid")
            + _mlp_spec("output", (L, L, cfg["grid_out"])))


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
    """The samples, noise levels and noise, and the mix's sizes
    (``traffic.gencast.gencast``), no graphs: the program builds its own,
    the reference the generator's."""
    spec = traffic["gencast"]
    if (spec["inputs"] + spec["targets"], spec["targets"]) != (
            cfg["grid_in"], cfg["grid_out"]):
        raise ValueError("the traffic's channels are not the "
                         "configuration's grid_in and grid_out")
    return {**gencast(traffic, seed, device), "spec": spec}


class Program:
    """One AdamW step a sample: the job's step ``k`` (the optimizer's
    count, which the window's restore puts back) trains on sample ``k``
    modulo the mix's samples, at its noise level and noise field.
    ``step()`` returns the (query, key) scores the attention kernel
    computed in the step, forward, recomputed and backward
    (``mesh_attention.pairs``; none where its plain version runs)."""

    def __init__(self, cfg, data, device, weights):
        spec = data["spec"]  # the mix's grid, mesh and neighbourhoods
        t0 = time.perf_counter()
        graphs = ngp.gencast_graphs(spec["splits"], spec["n_lat"],
                                    spec["n_lon"], spec["radius_fraction"])
        built = time.perf_counter()
        sizes = dict(num_grid=graphs.mesh2grid.num_nodes,
                     num_mesh=graphs.mesh.num_nodes,
                     mesh_edges=graphs.mesh.num_edges,
                     grid2mesh_edges=graphs.grid2mesh.num_edges,
                     mesh2grid_edges=graphs.mesh2grid.num_edges)
        for key, n in sizes.items():  # what step_flops counts from
            if data[key] != n:
                raise ValueError(f"gencast: {key} {n}, the mix gives "
                                 f"{data[key]}")
        blocks = (cfg["blocks"]["grid2mesh"], cfg["blocks"]["mesh2grid"])
        _sync(device)
        t1 = time.perf_counter()
        prepared = {k: g.to(device) for k, g in gcm.precompute_graphs(
            graphs, spec["hops"], blocks, device).items()}
        _sync(device)
        self.precompute_s = time.perf_counter() - t1
        # the pairs that attend, which step_flops counts from
        data["pairs"] = prepared["mesh"].cache["attention_layout"].pairs
        t2 = time.perf_counter()
        with torch.device("meta"):  # shapes only: the weights come next
            model = ngp.GenCast(
                cfg["grid_in"], cfg["grid_out"], cfg["latent"],
                cfg["processor_layers"], cfg["heads"], cfg["ffw_hidden"],
                cfg["node_in"], cfg["edge_in"], cfg["noise_frequencies"],
                cfg["noise_base_period"], cfg["noise_mlp"], recompute=True)
        model = model.to_empty(device=device).set_graphs(prepared)
        self.params = {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[name])
                self.params[name] = p
        b1, b2 = cfg["betas"]
        self.opt = ngp.adamw(model.parameters(), cfg["lr"], b1, b2,
                             cfg["eps"], cfg["weight_decay"])
        x, r = data["inputs"], data["targets"]
        sigma, noise = data["sigma"], data["noise"]
        node_w = torch.from_numpy(area_weights(graphs.grid_lat)).to(device)
        chan_w = torch.from_numpy(channel_weights(cfg)).to(device)
        first = next(model.parameters())

        def loss():
            state = self.opt.state.get(first)
            i = (int(state["step"]) if state else 0) % x.shape[0]
            z = r[i] + sigma[i] * noise[i]
            denoised = model(x[i], z, sigma[i])
            return losses.edm_weighted_mse(denoised, r[i], sigma[i], node_w,
                                           chan_w)

        self._step = ngp.make_train_step(loss, self.opt)
        self.model = model
        self.conv_modules = [b.attention for b in model.processor]
        _sync(device)
        self.build_s = dict(graphs=built - t0, precompute=self.precompute_s,
                            model=time.perf_counter() - t2)

    def step(self):
        before = mesh_attention.pairs
        loss, _ = self._step()
        return loss, mesh_attention.pairs - before

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


def conv_work(cfg, data, module, x, out):
    """One ``MeshAttention`` call at its least work
    (``gencast_counts``): over the pairs that attend."""
    layout = module.graph.cache["attention_layout"]
    sizes = (layout.pairs, layout.num_nodes, cfg["heads"], cfg["head_dim"])
    return gnc.attention_forward(*sizes), gnc.attention_backward(*sizes)


def evals(cfg, solves):
    """Millions of (query, key) scores the attention kernel computed in a
    step (``Program.step``'s count)."""
    return solves / 1e6


def step_flops(cfg, data, solves):
    """Operations of one step from shapes: every embedder, conv, block and
    MLP forward and backward at its least work (the attention over the
    pairs that attend), the preconditioning and the loss. Recomputation,
    the noise encoder (one 64-wide vector) and the optimizer's update are
    left out."""
    L, n_g, n_m = cfg["latent"], data["num_grid"], data["num_mesh"]
    e_g2m, e_m2g = data["grid2mesh_edges"], data["mesh2grid_edges"]
    c = cfg["grid_out"]

    def mlp(n, dims, norm=True, input_grad=False):
        return (gcc.mlp_forward(n, dims, norm).ops
                + gcc.mlp_backward(n, dims, norm, input_grad).ops)

    def conv(*sizes):
        return (gcc.interaction_forward(*sizes).ops
                + gcc.interaction_backward(*sizes).ops)

    block = (data["pairs"], n_m, L, cfg["heads"], cfg["ffw_hidden"])
    e_in = cfg["edge_in"]
    return (mlp(n_g, (cfg["grid_in"], L, L))
            + mlp(n_m, (cfg["node_in"], L, L))
            + conv(n_g, n_m, e_g2m, L, e_in, False)
            + mlp(n_g, (L, L, L), input_grad=True) + 2 * n_g * L
            + cfg["processor_layers"] * (gnc.block_forward(*block).ops
                                         + gnc.block_backward(*block).ops)
            + conv(n_m, n_g, e_m2g, L, e_in, False)
            + mlp(n_g, (L, L, c), norm=False, input_grad=True)
            + 8 * n_g * c  # z = r + σε, c_in z, c_skip z + c_out F
            + gcc.weighted_mse(n_g, c).ops)


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
