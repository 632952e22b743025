"""``grand-gcn`` on the port: ``grand_model`` on a graph that
``precompute(add_self_loops=True, dense=False, auto_reorder=True)``
prepared, trained by ``make_train_step`` with the port's ``adam`` on the
masked cross-entropy; and its counts of work."""
from __future__ import annotations

import time

import torch

import neuralgraphpde_torch as ngp
from neuralgraphpde_torch.train import losses

from bench_torch.core import counts
from bench_torch.traffic.generate import generate

# the port's parameter names -> the leaves' names here and in the reference
LEAVES = {"layer_1.weight": "encoder.weight", "layer_1.bias": "encoder.bias",
          "layer_3.weight": "decoder.weight", "layer_3.bias": "decoder.bias"}


def _leaf(name: str) -> str:
    if name in LEAVES:
        return LEAVES[name]
    # layer_2.model.layer_<k>.<weight|bias>: the k-th GCN of the RHS
    _, _, layer, kind = name.split(".")
    return f"rhs.{int(layer.split('_')[1]) - 1}.{kind}"


def make_data(cfg, traffic, seed, device):
    """The traffic's graph and node data; its feature width and classes
    are the configuration's."""
    if (traffic["features"], traffic["classes"]) != (cfg["in_dims"],
                                                     cfg["out_dims"]):
        raise ValueError("the traffic's features and classes are not the "
                         "configuration's in_dims and out_dims")
    return generate(traffic, seed, device)


def weight_spec(cfg, data):
    f, h, c = cfg["in_dims"], cfg["hidden_dims"], data["classes"]
    spec = [("encoder.weight", (f, h), "glorot_normal"),
            ("encoder.bias", (1, h), "zeros")]
    for k in range(cfg["rhs_depth"]):
        spec += [(f"rhs.{k}.weight", (h, h), "glorot_normal"),
                 (f"rhs.{k}.bias", (1, h), "zeros")]
    return spec + [("decoder.weight", (h, c), "glorot_uniform"),
                   ("decoder.bias", (1, c), "zeros")]


class Program:
    def __init__(self, cfg, data, device, weights):
        g = ngp.GnnGraph.from_coo(data["senders"], data["receivers"],
                                  num_nodes=data["num_nodes"])
        _sync(device)
        t0 = time.perf_counter()
        g = ngp.precompute(g, add_self_loops=True, dense=False,
                           auto_reorder=True).to(device)
        _sync(device)
        self.precompute_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        x, y, mask = data["x"], data["y"], data["mask"]
        order = g.cache.get("node_order")
        if order is not None:
            order = order.cpu().numpy()
            x, y, mask = (ngp.permute_nodes(a, order) for a in (x, y, mask))
        model = ngp.grand_model(
            cfg["in_dims"], cfg["hidden_dims"], data["classes"],
            tspan=tuple(cfg["tspan"]), solver=cfg["solver"],
            rtol=cfg["rtol"], atol=cfg["atol"], adjoint=cfg["adjoint"],
            rhs_depth=cfg["rhs_depth"], precomputed_self_loops=True,
            generator=torch.Generator().manual_seed(0), device=device)
        self.params = {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[_leaf(name)])
                self.params[_leaf(name)] = p
        ngp.update_graph(model, g)
        self.opt = ngp.adam(model.parameters(), cfg["lr"])
        self._step = ngp.make_train_step(
            lambda: losses.masked_cross_entropy(model(x), y, mask),
            self.opt)
        self.model, self.graph = model, g
        self.conv_modules = [m for m in model.modules()
                             if isinstance(m, ngp.GCNConv)]
        _sync(device)
        self.build_s = dict(precompute=self.precompute_s,
                            model=time.perf_counter() - t1)

    def step(self):
        loss, _ = self._step()
        return loss, [dict(self.model.layer_2.last_stats)]

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


def _nnz(data):
    """Nonzeros of the self-looped adjacency."""
    return len(data["senders"]) + data["num_nodes"]


def conv_work(cfg, data, module, x, out):
    n, nnz = data["num_nodes"], _nnz(data)
    return (counts.gcn_forward(n, nnz, module.in_chs, module.out_chs),
            counts.gcn_backward(n, nnz, module.in_chs, module.out_chs,
                                input_grad=x.requires_grad))


def evals(cfg, solves):
    """Right-hand-side evaluations of a step: the solve's forward ones,
    and the ones autograd runs backwards: the first evaluation and the six
    new stages of each accepted Tsit5 step."""
    return sum(s["nfe"] + 1 + 6 * s["accepted"] for s in solves)


def step_flops(cfg, data, solves):
    """Operations of one step from shapes and the solver's counts: the
    encoder (no input gradient), each right-hand-side evaluation forward
    and each one replayed backward, the decoder and the loss. The solver's
    stage sums are left out."""
    n, nnz, h = data["num_nodes"], _nnz(data), cfg["hidden_dims"]
    c, f, depth = data["classes"], cfg["in_dims"], cfg["rhs_depth"]
    fwd = counts.gcn_forward(n, nnz, h, h).ops * depth
    bwd = counts.gcn_backward(n, nnz, h, h, True).ops * depth
    total = (counts.gcn_forward(n, nnz, f, h).ops
             + counts.gcn_backward(n, nnz, f, h, False).ops
             + counts.dense_forward(n, h, c).ops
             + counts.dense_backward(n, h, c, True).ops
             + counts.softmax_cross_entropy(n, c).ops)
    for s in solves:
        total += s["nfe"] * fwd + (1 + 6 * s["accepted"]) * bwd
    return total


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def half_batch(data):
    """The inputs with the second half of the train mask's nodes left out:
    the loss is the mean over the rest (a planted fault)."""
    mask = data["mask"].clone()
    kept = mask.nonzero()[:, 0]
    mask[kept[len(kept) // 2:]] = False
    return {**data, "mask": mask}
