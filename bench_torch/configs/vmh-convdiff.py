"""``vmh-convdiff`` on the port: ``vmh_model`` on the Delaunay mesh that
``precompute(dense=False)`` prepared. Training is one full-batch epoch a
step (``examples.train_vmh.full_batch_grad``, then the port's ``rprop``);
a rollout is the forward solve under ``torch.inference_mode``. And its
counts of work."""
from __future__ import annotations

import time

import numpy as np
import torch

import neuralgraphpde_torch as ngp
from neuralgraphpde_torch.examples import train_vmh

from bench_torch.core import counts
from bench_torch.traffic.generate import generate


def save_times(cfg):
    return np.linspace(0.0, cfg["t_end"], cfg["num_saves"]).astype(
        np.float32)


def make_data(cfg, traffic, seed, device):
    ts = save_times(cfg)
    data = generate(traffic, seed, device, ts=[float(t) for t in ts])
    data["ts"] = ts
    return data


def _dims(cfg):
    s, p, h, d = (cfg["state_dim"], cfg["pos_dim"], cfg["hidden"],
                  cfg["depth"])
    phi = (2 * s + p,) + (h,) * d + (cfg["msg_dim"],)
    gamma = (s + cfg["msg_dim"],) + (h,) * d + (s,)
    return phi, gamma


def weight_spec(cfg, data):
    spec = []
    for mlp, dims in zip(("phi", "gamma"), _dims(cfg)):
        for k in range(len(dims) - 1):
            spec += [(f"{mlp}.{k}.weight", (dims[k], dims[k + 1]),
                      "glorot_uniform"),
                     (f"{mlp}.{k}.bias", (1, dims[k + 1]), "zeros")]
    return spec


def _leaf(name: str) -> str:
    # model.<phi|gamma>.layer_<k>.<weight|bias>
    _, mlp, layer, kind = name.split(".")
    return f"{mlp}.{int(layer.split('_')[1]) - 1}.{kind}"


class Program:
    def __init__(self, cfg, data, device, weights):
        g = ngp.GnnGraph.from_coo(
            data["senders"], data["receivers"], num_nodes=data["num_nodes"],
            ndata={"x": torch.from_numpy(data["pos"])})
        _sync(device)
        t0 = time.perf_counter()
        g = ngp.precompute(g, dense=False).to(device)
        _sync(device)
        self.precompute_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        ts = tuple(float(t) for t in data["ts"])
        model = ngp.vmh_model(
            cfg["state_dim"], cfg["pos_dim"], hidden=cfg["hidden"],
            msg_dim=cfg["msg_dim"], depth=cfg["depth"],
            tspan=(ts[0], ts[-1]), saveat=ts, solver=cfg["solver"],
            rtol=cfg["rtol"], atol=cfg["atol"], adjoint=cfg["adjoint"],
            checkpoint_steps=cfg["checkpoint_steps"],
            max_steps=cfg["max_steps"],
            generator=torch.Generator().manual_seed(0), device=device)
        self.params = {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(weights[_leaf(name)])
                self.params[_leaf(name)] = p
        ngp.update_graph(model, g)
        self.model, self.graph, self.device = model, g, device
        self.conv_modules = [m for m in model.modules()
                             if isinstance(m, ngp.VMHConv)]
        _sync(device)
        self.build_s = dict(precompute=self.precompute_s,
                            model=time.perf_counter() - t1)

    def close(self):
        self.model = self.graph = self.opt = None
        self.params = {}


class TrainProgram(Program):
    def __init__(self, cfg, data, device, weights):
        super().__init__(cfg, data, device, weights)
        eta_minus, eta_plus = cfg["etas"]
        step_min, step_max = cfg["step_sizes"]
        self.opt = ngp.rprop(self.model.parameters(), cfg["lr"], eta_minus,
                             eta_plus, step_min, step_max)
        self.u = data["u"]

    def step(self):
        loss, stats = train_vmh.full_batch_grad(self.model, self.u)
        self.opt.step()
        return loss, stats

    def first_grads(self):
        """Rprop− keeps the first gradient whole as ``prev_grad`` (no sign
        change is possible on the first step)."""
        return {k: self.opt.state[p].get("prev_grad", torch.zeros_like(p))
                for k, p in self.params.items()}


class RolloutProgram(Program):
    def request(self, field: torch.Tensor):
        """One rollout of a ``(M, 1)`` host field: the trajectory on the
        host and the solve's counts."""
        u0 = field.to(self.device)
        with torch.inference_mode():
            ys = self.model(u0)
        return ys.cpu(), dict(self.model.last_stats)


def train_program(cfg, data, device, weights):
    return TrainProgram(cfg, data, device, weights)


def rollout_program(cfg, data, device, weights):
    return RolloutProgram(cfg, data, device, weights)


def _conv(cfg, data):
    phi, gamma = _dims(cfg)
    return (data["num_nodes"], len(data["senders"]), cfg["state_dim"],
            cfg["pos_dim"], phi, gamma)


def conv_work(cfg, data, module, x, out):
    shape = _conv(cfg, data)
    return counts.vmh_forward(*shape), counts.vmh_backward(*shape)


def evals(cfg, solves):
    """Right-hand-side evaluations of a step or a request: each solve's
    forward ones, and when it ran backwards, the first evaluation and the
    six new stages of each accepted Tsit5 step."""
    return sum(s["nfe"] + 1 + 6 * s["accepted"] for s in solves)


def step_flops(cfg, data, solves):
    """Operations of one epoch from shapes and the solvers' counts: every
    right-hand-side evaluation forward, every one replayed backward, and
    the rollout MSE. The solver's stage sums are left out."""
    shape = _conv(cfg, data)
    fwd, bwd = counts.vmh_forward(*shape).ops, counts.vmh_backward(
        *shape).ops
    n, t = data["num_nodes"], cfg["num_saves"]
    return sum(s["nfe"] * fwd + (1 + 6 * s["accepted"]) * bwd + 4 * t * n
               for s in solves)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def half_batch(data):
    """The inputs with the second half of the simulations left out: the
    loss is the mean over the rest (a planted fault)."""
    return {**data, "u": data["u"][: data["u"].shape[0] // 2]}
