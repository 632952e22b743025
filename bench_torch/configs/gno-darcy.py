"""``gno-darcy`` on the port: ``GKNModel`` (the published graph kernel
network) on the radius graph that ``precompute(dense=False)`` prepared,
trained by ``make_train_step`` with the port's ``adam`` on the MSE of one
sample a step; and its counts of work."""
from __future__ import annotations

import time

import torch

import neuralgraphpde_torch as ngp
from neuralgraphpde_torch.train import losses

from bench_torch.core import counts, gno_counts
from bench_torch.traffic.darcy import darcy

# the port's parameter names -> the leaves' names here and in the reference
LEAVES = {"lift.weight": "lift.weight", "lift.bias": "lift.bias",
          "conv.linear.weight": "root.weight",
          "conv.linear.bias": "root.bias",
          "conv.phi.layer_1.weight": "kernel.0.weight",
          "conv.phi.layer_1.bias": "kernel.0.bias",
          "conv.phi.layer_2.weight": "kernel.1.weight",
          "conv.phi.layer_2.bias": "kernel.1.bias",
          "conv.phi.layer_3.weight": "kernel.2.weight",
          "conv.phi.layer_3.bias": "kernel.2.bias",
          "proj.weight": "proj.weight", "proj.bias": "proj.bias"}


def kernel_dims(cfg) -> tuple:
    """The kernel network's widths, its last layer's output included."""
    return (cfg["edge_dim"], cfg["ker_width"] // 2, cfg["ker_width"],
            cfg["width"] ** 2)


def make_data(cfg, traffic, seed, device):
    """The traffic's graph and samples; their node features are the
    configuration's."""
    data = darcy(traffic, seed, device)
    if data["feats"].shape[-1] != cfg["node_dim"]:
        raise ValueError("the traffic's node features are not the "
                         "configuration's node_dim")
    return data


def weight_spec(cfg, data):
    w, dims = cfg["width"], kernel_dims(cfg)
    spec = [("lift.weight", (cfg["node_dim"], w), "glorot_uniform"),
            ("lift.bias", (1, w), "zeros")]
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        spec += [(f"kernel.{i}.weight", (a, b), "glorot_uniform"),
                 (f"kernel.{i}.bias", (1, b), "zeros")]
    return spec + [("root.weight", (w, w), "glorot_uniform"),
                   ("root.bias", (1, w), "zeros"),
                   ("proj.weight", (w, cfg["out_dim"]), "glorot_uniform"),
                   ("proj.bias", (1, cfg["out_dim"]), "zeros")]


class Program:
    """One Adam step a sample: the job's step ``k`` (Adam's count of steps,
    which the window's restore puts back) trains on sample ``k`` modulo the
    mix's samples, so every episode replays the same steps."""

    def __init__(self, cfg, data, device, weights):
        g = ngp.GnnGraph.from_coo(data["senders"], data["receivers"],
                                  num_nodes=data["num_nodes"],
                                  ndata={"x": data["pos"].cpu().numpy()})
        _sync(device)
        t0 = time.perf_counter()
        g = ngp.precompute(g, dense=False).to(device)
        _sync(device)
        self.precompute_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        model = ngp.GKNModel(
            cfg["node_dim"], cfg["edge_dim"], width=cfg["width"],
            ker_width=cfg["ker_width"], depth=cfg["depth"],
            out_dim=cfg["out_dim"],
            generator=torch.Generator().manual_seed(0), device=device)
        self.params = {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[LEAVES[name]])
                self.params[LEAVES[name]] = p
        ngp.update_graph(model, g)
        self.opt = ngp.adam(model.parameters(), cfg["lr"])
        feats, a, y = data["feats"], data["a"], data["y"]
        first = next(model.parameters())

        def loss():
            state = self.opt.state.get(first)
            i = (int(state["step"]) if state else 0) % feats.shape[0]
            return losses.mse(model(feats[i], a[i]), y[i])

        self._step = ngp.make_train_step(loss, self.opt)
        self.model, self.graph = model, g
        self.conv_modules = [model.conv]
        _sync(device)
        self.build_s = dict(precompute=self.precompute_s,
                            model=time.perf_counter() - t1)

    def step(self):
        loss, _ = self._step()
        return loss, []

    def first_grads(self):
        """The first gradient as Adam holds it after one step: its first
        moment is ``(1 − β1) g``."""
        b1 = self.opt.param_groups[0]["betas"][0]
        return {k: self.opt.state[p].get("exp_avg", torch.zeros_like(p))
                / (1 - b1) for k, p in self.params.items()}

    def close(self):
        self.model = self.graph = self._step = self.opt = None
        self.params = {}


def train_program(cfg, data, device, weights):
    return Program(cfg, data, device, weights)


def conv_work(cfg, data, module, x, out):
    """One ``GNOConv`` call at K5's least work (``gno_counts``)."""
    n, e, w = data["num_nodes"], len(data["senders"]), cfg["width"]
    k = cfg["ker_width"]
    return (gno_counts.gno_conv_forward(n, e, w, w, k),
            gno_counts.gno_conv_backward(n, e, w, w, k,
                                         input_grad=x.requires_grad))


def evals(cfg, solves):
    """The K5 forward calls of a step: one a conv iteration, a constant."""
    return cfg["depth"]


def step_flops(cfg, data, solves):
    """Operations of one step from shapes: the kernel network's layers but
    its last, once forward and once backward; the lift (no input
    gradient); every conv iteration forward and backward at K5's least
    work; autograd's sum of the iterations' cotangents of the kernel
    network's output; the projection and the loss. The optimizer's update
    is left out."""
    n, e, w, depth = (data["num_nodes"], len(data["senders"]), cfg["width"],
                      cfg["depth"])
    dims, k = kernel_dims(cfg)[:-1], cfg["ker_width"]
    conv = (gno_counts.gno_conv_forward(n, e, w, w, k).ops
            + gno_counts.gno_conv_backward(n, e, w, w, k, True).ops)
    return (gno_counts.kernel_net_forward(e, dims).ops
            + gno_counts.kernel_net_backward(e, dims).ops
            + counts.dense_forward(n, cfg["node_dim"], w).ops
            + counts.dense_backward(n, cfg["node_dim"], w, False).ops
            + depth * conv + (depth - 1) * e * k
            + counts.dense_forward(n, w, cfg["out_dim"]).ops
            + counts.dense_backward(n, w, cfg["out_dim"], True).ops
            + gno_counts.mse(n).ops)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def half_batch(data):
    """The inputs with the loss taken over the first half of the nodes
    only (a planted fault)."""
    keep = torch.zeros(data["num_nodes"], dtype=torch.bool,
                       device=data["y"].device)
    keep[: data["num_nodes"] // 2] = True
    return {**data, "loss_nodes": keep}
