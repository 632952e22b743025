"""Device-time profile of the port's main paths and of its training kernels,
on one GPU.

    python -m neuralgraphpde_torch.tools.profile_paths [--out PATH.json]

Every part reads a ``torch.profiler`` trace (CUDA activity) and counts only
device events: kernels, copies and sets.

- Kernels: the training kernels at the shapes ``chip_smoke.py`` checks,
  device ms and device kernels per call of the forward kernel, the backward
  kernel and the two together, beside the plain forward and the plain
  training pair (the plain forward under autograd, then its backward). K3
  at the VMH mesh (3,000 nodes) and at 2^15 Delaunay points, widths
  4→60→60→60 tanh, at the MP-PDE ϕ on the Burgers chain (1,024 edges,
  282→128 swish) and at 2^15 points with 4→128→128→128 tanh; K5 at the GNO
  Darcy graph (32² grid, radius 0.08) and at the 64² grid, K 128, IN = OUT
  = 64, with a bias. K6 (forward) at the ``rand`` shape (2^18 rows, 2^22
  edges, F 128) and the Burgers chain, beside its plain version and
  ``scatter_reduce_``.
- GRAND: one GRAND forward under inference mode at the model's
  tolerances, as ``chip_smoke.py`` builds it: A, synthetic Cora on K1; B,
  the 512² 8-neighbour grid on the fused K2, then with ``gcn_fused=False``
  on the plain-stencil K2.
- VMH: the VMH full-batch epoch gradient (``train_vmh.full_batch_grad``,
  24 sims × 3,000 points).
- GNO: one GNO Darcy Adam step (``train_gno_darcy`` defaults: a batch
  of 4 samples on the 32² grid, 4 convs, 16 K5 forwards and backwards).
- MP-PDE (path E): one config-3 Adam step (``train_mppde_burgers``
  defaults: 4 windows of one simulation, 2 model calls each, 6 convs: 48
  K3 forwards and 48 backwards).
- bf16 (the precision policy, ``bf16(...)``): the kernels' bf16 forms at
  the shapes their bf16 paths give them (K3 at the VMH mesh with bf16
  weights and f32 or bf16 features, and at the MP-PDE ϕ with f32
  features; K5 at Darcy 32² with bf16 weights and f32 or bf16 ``ph``/``h``;
  K6 on bf16 messages at ``rand`` beside ``scatter_reduce_``), and the
  paths: ``bf16(VMHConv)``'s forward and gradient of ``sum(y²)`` at
  ``bench.py``'s VMH case (2^15 Delaunay points, hidden 60, message 40;
  the counterparts of its ``vmh/fused_grad_bf16`` and ``vmh/xla_grad_bf16``
  cells) beside the f32 layer's, the VMH epoch gradient with
  ``NeuralGraphODE(bf16(VMHConv))``, one GNO Adam step of
  ``bf16(GNOModel)`` and one MP-PDE Adam step of ``bf16(MPPDESolver)``.
- Backsolve: the VMH epoch gradient with ``adjoint="backsolve"`` (its f32
  checkpoint counterpart is the VMH path above).
- Path F: one GRAND Adam step (masked cross-entropy, lr 1e-2) on the
  2^17-point scrambled-label Delaunay mesh after ``precompute(
  add_self_loops=True, dense=False, auto_reorder=True)``: RCM, then packed
  block bands, every GCN layer one fused K4 call forward and two K4 SpMMs
  in the backward; ``xla`` is the gather/scatter path on the same
  relabeled graph. Beside it, K4 and K7 (the 12,000-point mesh) per call:
  the SpMM and the fused right-hand side, each forward and as a training
  pair, against the plain versions, and K1 and ``torch.sparse.mm`` on the
  same CSR.

Each path runs on its kernel path (``auto``), the ``xla`` path, then the
kernel path again (B's plain-stencil path once, on ``auto``). Each run: one
warm-up, one timed run without the profiler (``wall_s``; peak device
memory, and ``run_mem_GB``, that peak less what was allocated before the
run: every part's models and graphs stay resident), one under it
(``profiled_wall_s``). ``busy_ms`` is the union of
the device events' intervals of the profiled run, ``idle_share`` is ``1 −
busy_ms / wall_s``, the un-profiled wall (the profiler inflates the host's
time, most on host-bound paths), and ``top_ms`` the device time of the
largest kernels by name.

Prints one line per measurement and, with ``--out``, writes them all as one
JSON object.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from ..kernels import _build

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_REPS = 20
BENCH_POINTS = 1 << 15
GNO_N_BENCH = 64
REORD_POINTS = 1 << 17  # the JAX bench.py reord mesh
K7_POINTS = 12000


def device_events(prof) -> list:
    """``(name, start_us, dur_us, cat)`` of every device event in a
    finished profile, from its Chrome trace."""
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
             e["cat"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_us(events) -> float:
    """Length of the union of the events' ``[start, start + dur)``
    intervals: the time at least one device event ran."""
    total, end = 0.0, -float("inf")
    for _, start, dur, _ in sorted(events, key=lambda e: e[1]):
        stop = start + dur
        if start >= end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def profile(fn, reps: int = 1):
    """Run ``fn`` ``reps`` times under the profiler (after a synchronize);
    returns (the device events, host seconds of the profiled run)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return device_events(prof), seconds


def device_per_call(fn, reps: int = KERNEL_REPS) -> tuple:
    """(device ms, device kernels) per call of ``fn``: ``reps`` calls under
    the profiler after 3 warm-up calls (build, caches, allocator). ``fn``
    launches at least one kernel, so a profile that holds none missed the
    device's trace (it happens now and then after many profiles in one
    process); it is taken again, up to 3 profiles in all."""
    for _ in range(3):
        fn()
    for _ in range(3):
        events, _ = profile(fn, reps)
        if any(e[3] == "kernel" for e in events):
            break
    return (sum(e[2] for e in events) / reps / 1e3,
            sum(e[3] == "kernel" for e in events) / reps)


def device_split(fn, reps: int = KERNEL_REPS) -> dict:
    """Device ms per call of ``fn`` by kernel name (the first 90
    characters), largest first: ``reps`` calls under the profiler after 3
    warm-up calls, profiled again (up to 3 times in all) if the trace
    holds no kernel, as ``device_per_call``."""
    for _ in range(3):
        fn()
    for _ in range(3):
        events, _ = profile(fn, reps)
        if any(e[3] == "kernel" for e in events):
            break
    by_name = defaultdict(float)
    for name, _, dur, _ in events:
        by_name[name[:90]] += dur / 1e3 / reps
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1]))


def per_calls(head: str, fns: dict) -> dict:
    """Device ms and device kernels per call of each of ``fns``
    (``device_per_call``), keyed ``"head what"``."""
    out = {}
    for what, fn in fns.items():
        ms, kernels = device_per_call(fn)
        key = f"{head} {what}"
        out[key] = rec = dict(device_ms_per_call=ms, kernels_per_call=kernels)
        print(f"{key}: {rec['device_ms_per_call']:.4f} device ms/call, "
              f"{rec['kernels_per_call']:g} kernels/call", flush=True)
    return out


def _put(rng, dev, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).to(dev)


def k3_times(dev, vmh_graph, mppde_graph) -> dict:
    """K3 and its plain versions at the VMH mesh and at 2^15 points (VMH ϕ,
    and ϕ at hidden 128), and at the MP-PDE ϕ on the Burgers chain."""
    from ..graph.builders import delaunay_graph
    from ..kernels import fused_mlp_kernels as K3
    from ..kernels.segment_kernels import build_segment_csr
    from ..ops.bsr import host_edges

    pts = np.random.default_rng(0).random((BENCH_POINTS, 2))
    _, r = host_edges(delaunay_graph(pts.astype(np.float32)))
    bench = build_segment_csr(np.arange(len(r)), r, BENCH_POINTS,
                              num_cols=len(r)).to(dev)
    rng = np.random.default_rng(3)
    tanh3 = ("tanh", "tanh", "tanh")
    out = {}
    for label, csr, acts, dims in (
            ("VMH mesh", vmh_graph.cache["tcsr_edges"], tanh3,
             (4, 60, 60, 60)),
            ("2^15 points", bench, tanh3, (4, 60, 60, 60)),
            ("MP-PDE phi, Burgers", mppde_graph.cache["tcsr_edges"],
             ("swish",), (282, 128)),
            ("2^15 points, hidden 128", bench, tanh3, (4, 128, 128, 128))):
        n_layers = len(acts)
        ws = [_put(rng, dev, a, b, scale=1 / np.sqrt(a))
              for a, b in zip(dims[:-1], dims[1:])]
        bs = [_put(rng, dev, 1, b, scale=1 / 3) for b in dims[1:]]
        feats = _put(rng, dev, csr.num_cols, dims[0])
        g = _put(rng, dev, csr.num_rows, dims[-1])

        def plain_train():
            leaves = [t.detach().requires_grad_() for t in (feats, *ws, *bs)]
            y = K3.fused_mlp_plain(acts, csr, leaves[0],
                                   leaves[1:n_layers + 1],
                                   leaves[n_layers + 1:])
            return torch.autograd.grad(y, leaves, g)

        def kernel_train():
            K3.fused_mlp_fwd(acts, csr, feats, ws, bs)
            return K3.fused_mlp_bwd(acts, csr, feats, ws, bs, g)

        head = (f"K3 {label} (N={csr.num_rows}, E={csr.num_cols}, "
                f"{'-'.join(map(str, dims))}; "
                f"{K3.fused_mlp_variant(dims)} forward, "
                f"{K3.fused_mlp_variant(dims, backward=True)} backward)")
        out.update(per_calls(head, {
            "fwd kernel": lambda: K3.fused_mlp_fwd(acts, csr, feats, ws, bs),
            "fwd plain": lambda: K3.fused_mlp_plain(acts, csr, feats, ws, bs),
            "bwd kernel": lambda: K3.fused_mlp_bwd(acts, csr, feats, ws, bs,
                                                   g),
            "fwd+bwd kernels": kernel_train,
            "fwd+bwd plain (autograd)": plain_train,
        }))
    return out


def k5_times(dev, gno_graph) -> dict:
    """K5 and its plain versions at the GNO Darcy graph and the 64² grid."""
    from ..data.pde import darcy_dataset
    from ..kernels import gno_kernels as K5
    from ..kernels.segment_kernels import build_segment_csr

    m = GNO_N_BENCH
    s, r = darcy_dataset(num_samples=0, n=m,
                         radius=max(0.08, 1.6 / (m + 1))).graph.host_coo
    bench = (build_segment_csr(np.arange(len(r)), r, m * m,
                               num_cols=len(r)).to(dev),
             torch.from_numpy(s).to(dev))
    rng = np.random.default_rng(5)
    k, width = 128, 64
    wl, bl = K5.pack_last_layer(
        _put(rng, dev, k, width * width, scale=1 / np.sqrt(k)),
        _put(rng, dev, 1, width * width, scale=0.1), width, width)
    out = {}
    for label, (csr, senders) in (
            ("Darcy 32²", (gno_graph.cache["tcsr_edges"], gno_graph.senders)),
            (f"Darcy {m}²", bench)):
        ph = _put(rng, dev, csr.num_cols, k)
        h, g = _put(rng, dev, csr.num_rows, width), _put(rng, dev,
                                                         csr.num_rows, width)

        def plain_train():
            leaves = [t.detach().requires_grad_() for t in (ph, h, wl, bl)]
            y = K5.fused_gno_plain(csr, senders, *leaves)
            return torch.autograd.grad(y, leaves, g)

        def kernel_train():
            K5.fused_gno_fwd(csr, senders, ph, h, wl, bl)
            return K5.fused_gno_bwd(csr, senders, ph, h, wl, bl, g)

        head = f"K5 {label} (N={csr.num_rows}, E={csr.num_cols})"
        out.update(per_calls(head, {
            "fwd kernel": lambda: K5.fused_gno_fwd(csr, senders, ph, h, wl,
                                                   bl),
            "fwd plain": lambda: K5.fused_gno_plain(csr, senders, ph, h, wl,
                                                    bl),
            "bwd kernel": lambda: K5.fused_gno_bwd(csr, senders, ph, h, wl,
                                                   bl, g),
            "fwd+bwd kernels": kernel_train,
            "fwd+bwd plain (autograd)": plain_train,
        }))
    return out


def k6_times(dev, mppde_graph) -> dict:
    """K6, its plain version and ``scatter_reduce_`` at the ``rand`` shape
    (the ``rand_graph(2^18, 2^22)`` edge-id layout) and the Burgers chain,
    F = 128."""
    from ..graph.builders import rand_graph
    from ..kernels.segment_kernels import (build_segment_csr, segment_max,
                                           segment_max_plain)
    from ..ops.bsr import host_edges

    _, r = host_edges(rand_graph(2 ** 18, 2 ** 22, seed=0))
    rand = (build_segment_csr(np.arange(len(r)), r, 2 ** 18,
                              num_cols=len(r)).to(dev),
            torch.from_numpy(r).to(dev))
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for label, (csr, recv) in (
            ("rand", rand),
            ("Burgers", (mppde_graph.cache["tcsr_edges"],
                         mppde_graph.receivers))):
        m = torch.randn(csr.num_cols, 128, device=dev, generator=gen)
        idx = recv.long().reshape(-1, 1).expand_as(m)

        def library():
            return torch.full((csr.num_rows, 128), float("-inf"),
                              device=dev).scatter_reduce_(0, idx, m, "amax")

        head = f"K6 {label} (N={csr.num_rows}, E={csr.num_cols}, F=128)"
        out.update(per_calls(head, {
            "fwd kernel": lambda: segment_max(m, csr),
            "fwd plain": lambda: segment_max_plain(m, csr),
            "scatter_reduce_": library}))
        del m, idx
    return out


def bf16_kernel_times(dev, vmh_graph, mppde_graph, gno_graph) -> dict:
    """The bf16 forms of K3, K5 and K6 and their plain versions, device ms
    per call, at their bf16 paths' shapes."""
    from ..graph.builders import rand_graph
    from ..kernels import fused_mlp_kernels as K3
    from ..kernels import gno_kernels as K5
    from ..kernels.segment_kernels import (build_segment_csr, segment_max,
                                           segment_max_plain)
    from ..ops.bsr import host_edges

    bf = torch.bfloat16
    rng = np.random.default_rng(13)
    out = {}
    for label, csr, acts, dims, forms in (
            ("VMH mesh", vmh_graph.cache["tcsr_edges"], ("tanh",) * 3,
             (4, 60, 60, 60), (torch.float32, bf)),
            ("MP-PDE phi, Burgers", mppde_graph.cache["tcsr_edges"],
             ("swish",), (282, 128), (torch.float32,))):
        ws = [_put(rng, dev, a, b, scale=1 / np.sqrt(a)).to(bf)
              for a, b in zip(dims[:-1], dims[1:])]
        bs = [_put(rng, dev, 1, b, scale=1 / 3).to(bf) for b in dims[1:]]
        for fdt in forms:
            feats = _put(rng, dev, csr.num_cols, dims[0]).to(fdt)
            g = _put(rng, dev, csr.num_rows, dims[-1]).to(fdt)
            head = (f"K3 bf16 weights, {str(fdt)[6:]} feats, {label} "
                    f"(N={csr.num_rows}, E={csr.num_cols}, "
                    f"{'-'.join(map(str, dims))})")
            out.update(per_calls(head, {
                "fwd kernel": lambda: K3.fused_mlp_fwd(acts, csr, feats, ws,
                                                       bs),
                "fwd plain": lambda: K3.fused_mlp_plain(acts, csr, feats, ws,
                                                        bs),
                "bwd kernel": lambda: K3.fused_mlp_bwd(acts, csr, feats, ws,
                                                       bs, g),
                "bwd plain": lambda: K3.fused_mlp_bwd_plain(acts, csr, feats,
                                                            ws, bs, g)}))
    csr, senders = gno_graph.cache["tcsr_edges"], gno_graph.senders
    k, width = 128, 64
    wl, bl = (t.to(bf) for t in K5.pack_last_layer(
        _put(rng, dev, k, width * width, scale=1 / np.sqrt(k)),
        _put(rng, dev, 1, width * width, scale=0.1), width, width))
    for pdt in (torch.float32, bf):
        ph = _put(rng, dev, csr.num_cols, k).to(pdt)
        h = _put(rng, dev, csr.num_rows, width).to(pdt)
        g = _put(rng, dev, csr.num_rows, width).to(pdt)
        head = (f"K5 bf16 weights, {str(pdt)[6:]} ph and h, Darcy 32² "
                f"(N={csr.num_rows}, E={csr.num_cols})")
        out.update(per_calls(head, {
            "fwd kernel": lambda: K5.fused_gno_fwd(csr, senders, ph, h, wl,
                                                   bl),
            "fwd plain": lambda: K5.fused_gno_plain(csr, senders, ph, h, wl,
                                                    bl),
            "bwd kernel": lambda: K5.fused_gno_bwd(csr, senders, ph, h, wl,
                                                   bl, g),
            "bwd plain": lambda: K5.fused_gno_bwd_plain(csr, senders, ph, h,
                                                        wl, bl, g)}))
    _, r = host_edges(rand_graph(2 ** 18, 2 ** 22, seed=0))
    for label, csr, recv in (
            ("rand", build_segment_csr(np.arange(len(r)), r, 2 ** 18,
                                       num_cols=len(r)).to(dev),
             torch.from_numpy(r).to(dev)),
            ("Burgers", mppde_graph.cache["tcsr_edges"],
             mppde_graph.receivers)):
        m = _put(rng, dev, csr.num_cols, 128).to(bf)
        idx = recv.long().reshape(-1, 1).expand_as(m)

        def library():
            return torch.full((csr.num_rows, 128), float("-inf"), dtype=bf,
                              device=dev).scatter_reduce_(0, idx, m, "amax")

        head = (f"K6 bf16 {label} (N={csr.num_rows}, E={csr.num_cols}, "
                f"F=128)")
        out.update(per_calls(head, {
            "fwd kernel": lambda: segment_max(m, csr),
            "fwd plain": lambda: segment_max_plain(m, csr),
            "scatter_reduce_": library}))
        del m, idx
    return out


def bf16_vmh_layer(dev):
    """``(label, modes, fn)`` of the VMH layer's forward and gradient of
    ``sum(y²)`` at ``bench.py``'s VMH case, in bf16 (``bf16(VMHConv)``) and
    in f32."""
    from ..graph.builders import delaunay_graph
    from ..nn.basic import MLP
    from ..nn.conv import VMHConv
    from ..nn.precision import bf16
    from ..ops.spmm import precompute
    from ..utils.state import update_graph

    pts = np.random.default_rng(0).random((BENCH_POINTS, 2)).astype(
        np.float32)
    g = precompute(delaunay_graph(pts, ndata={"x": torch.from_numpy(pts)}),
                   dense=False, pallas=True).to(dev)
    gen = torch.Generator().manual_seed(12)
    kw = dict(generator=gen, device=dev)
    layer = VMHConv(MLP((4, 60, 60, 60, 40), "tanh", **kw),
                    MLP((41, 60, 60, 60, 1), "tanh", **kw))
    update_graph(layer, g)
    x = _put(np.random.default_rng(12), dev, g.num_nodes, 1)

    def grad(model):
        def fn():
            layer.zero_grad(set_to_none=True)
            xl = x.clone().requires_grad_()
            loss = (model(xl) ** 2).sum()
            loss.backward()
            return dict(loss=float(loss.detach()))
        return fn

    modes = ("auto", "xla")
    return [("bf16 VMH layer gradient, 2^15 points (K3)", modes,
             grad(bf16(layer))),
            ("f32 VMH layer gradient, 2^15 points (K3)", modes,
             grad(layer))]


def scrambled_mesh(points: int, dev):
    """``precompute(add_self_loops=True, dense=False, auto_reorder=True)`` of
    the Delaunay mesh of ``points`` ``default_rng(0)`` points, on ``dev``."""
    from ..graph.builders import delaunay_graph
    from ..ops.spmm import precompute

    pts = np.random.default_rng(0).random((points, 2)).astype(np.float32)
    return precompute(delaunay_graph(pts), add_self_loops=True, dense=False,
                      auto_reorder=True).to(dev)


def band_times(dev, meshes) -> dict:
    """K4/K7 and their plain versions on each ``(label, graph, kind)``
    mesh, F = 128 (the fused right-hand side: tanh, W 128×128, b), with K1
    and ``torch.sparse.mm`` on the same relabeled CSR."""
    import warnings

    from ..kernels import banded_kernels as BK
    from ..kernels.segment_kernels import segment_spmm

    rng = np.random.default_rng(7)
    out = {}
    for label, g, kind in meshes:
        st, st_rev = g.cache[kind], g.cache[kind + "_rev"]
        nrm, nrm_rev = g.cache[kind + "_norm"], g.cache[kind + "_norm_rev"]
        spmm = (BK.pbanded_spmm_pallas if kind == "pbanded"
                else BK.banded_spmm_pallas)
        rhs = BK.pbanded_gcn_rhs if kind == "pbanded" else BK.banded_gcn_rhs
        n = st.num_nodes
        x, gy = _put(rng, dev, n, 128), _put(rng, dev, n, 128)
        w, b = _put(rng, dev, 128, 128, scale=128 ** -0.5), _put(
            rng, dev, 1, 128, scale=0.1)
        csr = g.cache["tcsr"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            a = torch.sparse_csr_tensor(csr.row_ptr, csr.col, csr.weight,
                                        size=(n, n))

        def pair(fn, *inputs):
            def run():
                leaves = [t.detach().requires_grad_() for t in inputs]
                return torch.autograd.grad(fn(*leaves), leaves, gy)
            return run

        head = (f"{'K4' if kind == 'pbanded' else 'K7'} {label} (N={n}, "
                f"S={st.blocks.shape[0]}, nb={st.nb}, "
                f"{st.row_height}x{st.tb}, F=128)")
        out.update(per_calls(head, {
            "spmm kernel": lambda: spmm(x, st),
            "spmm plain": lambda: BK.block_rhs_plain(st, x, None, None, None,
                                                     False),
            "rhs kernel": lambda: rhs("tanh", x, w, b, nrm),
            "rhs plain": lambda: BK.block_rhs_plain(nrm, x, w, b, "tanh",
                                                    True),
            "rhs fwd+bwd kernels": pair(lambda xx, ww, bb: rhs(
                "tanh", xx, ww, bb, nrm, nrm_rev), x, w, b),
            "rhs fwd+bwd plain (autograd)": pair(
                lambda xx, ww, bb: BK.block_rhs_plain(nrm, xx, ww, bb,
                                                      "tanh", True), x, w, b),
            "spmm fwd+bwd kernels": pair(lambda xx: spmm(xx, st, st_rev), x),
            "K1 on the same CSR": lambda: segment_spmm(x, csr),
            "torch.sparse.mm on the same CSR": lambda: torch.sparse.mm(a, x),
        }))
        del a
    return out


def mesh_adam_step(dev, g):
    """Path F: one GRAND (128 → 128 → 7) Adam step on the relabeled mesh
    ``g``, features, labels and a 10% train mask drawn in the original
    numbering and permuted with ``permute_nodes``."""
    from ..graph.reorder import permute_nodes
    from ..models.grand import grand_model
    from ..train.loop import make_train_step
    from ..train.losses import masked_cross_entropy
    from ..train.optim import adam
    from ..utils.state import update_graph

    n = g.num_nodes
    order = g.cache["node_order"].cpu().numpy()
    rng = np.random.default_rng(3)
    x, y, m = (torch.from_numpy(permute_nodes(a, order)).to(dev) for a in (
        rng.normal(size=(n, 128)).astype(np.float32),
        rng.integers(0, 7, n), rng.random(n) < 0.1))
    model = grand_model(128, 128, 7, precomputed_self_loops=True,
                        generator=torch.Generator().manual_seed(3),
                        device=dev)
    update_graph(model, g)
    step = make_train_step(lambda: masked_cross_entropy(model(x), y, m),
                           adam(model.parameters(), 1e-2))

    def fn():
        loss, _ = step()
        st = model.layer_2.last_stats
        return dict(loss=float(loss), nfe=st["nfe"], accepted=st["accepted"])
    return fn


def path_profile(label: str, mode: str, fn) -> dict:
    """One path in one mode: a warm-up run, a timed run, a profiled run.
    ``fn`` runs the path once and returns a dict of facts to record."""
    from ..ops.spmm import set_spmm_mode

    set_spmm_mode(mode)
    try:
        fn()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        facts = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        events, profiled = profile(fn)
    finally:
        set_spmm_mode("auto")
    busy = busy_us(events) / 1e3
    by_name = defaultdict(float)
    for name, _, dur, cat in events:
        if cat == "kernel":
            by_name[name[:90]] += dur / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    rec = dict(path=label, mode=mode, wall_s=wall, profiled_wall_s=profiled,
               busy_ms=busy, idle_share=1.0 - busy / (wall * 1e3),
               peak_mem_GB=peak / 1e9, run_mem_GB=(peak - resident) / 1e9,
               n_kernels=sum(e[3] == "kernel" for e in events), top_ms=top,
               **facts)
    print(f"{label}, {mode}: wall {wall:.4f} s (profiled {profiled:.4f} s), "
          f"device busy {busy:.3f} ms, idle share "
          f"{rec['idle_share']:.4f} (of the un-profiled wall), "
          f"{rec['n_kernels']} kernels, peak {rec['peak_mem_GB']:.4f} GB "
          f"({rec['run_mem_GB']:.4f} GB above the resident tensors), "
          f"{facts}", flush=True)
    for name, ms in top:
        print(f"    {ms:10.3f} ms  {name}")
    return rec


def grand_runs(dev) -> list:
    """``(label, modes, fn)`` of GRAND A and B, built as ``chip_smoke.py``
    builds them."""
    from ..data.synthetic import synthetic_cora
    from ..graph.builders import grid_graph_2d
    from ..models.grand import grand_model
    from ..ops.spmm import precompute
    from ..utils.state import update_graph

    data = synthetic_cora()
    cora = precompute(data.graph, add_self_loops=True, dense=False,
                      pallas=True).to(dev)
    model_a = grand_model(1433, 64, 7, rtol=1e-3, atol=1e-3,
                          precomputed_self_loops=True,
                          generator=torch.Generator().manual_seed(0),
                          device=dev)
    x_a = torch.from_numpy(data.features).to(dev)
    grid = grid_graph_2d(512, 512, diagonals=True)
    fused = precompute(grid, add_self_loops=True).to(dev)
    stencil = precompute(grid, add_self_loops=True, gcn_fused=False).to(dev)
    model_b = grand_model(128, 128, 7, precomputed_self_loops=True,
                          generator=torch.Generator().manual_seed(1),
                          device=dev)
    x_b = torch.from_numpy(np.random.default_rng(2).normal(
        size=(grid.num_nodes, 128)).astype(np.float32)).to(dev)

    def forward(model, g, x):
        def fn():
            update_graph(model, g)
            with torch.inference_mode():
                model(x)
            st = model.layer_2.last_stats
            return dict(nfe=st["nfe"], accepted=st["accepted"])
        return fn

    both = ("auto", "xla", "auto")
    return [("GRAND A (Cora, K1)", both, forward(model_a, cora, x_a)),
            ("GRAND B (512² grid, fused K2)", both,
             forward(model_b, fused, x_b)),
            ("GRAND B (512² grid, stencil K2)", ("auto",),
             forward(model_b, stencil, x_b))]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", help="write every measurement here as JSON")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from ..examples import train_gno_darcy as G
    from ..examples import train_mppde_burgers as M
    from ..examples import train_vmh as T
    from ..nn.precision import bf16
    from ..train.loop import make_train_step
    from ..train.optim import adam

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    vmh_model, vmh_u = T.setup(T.Config(), dev)
    gno_cfg = G.Config()
    gno_model, gno_a, gno_u = G.setup(gno_cfg, dev)
    mppde_cfg = M.Config()
    mppde_model, mppde_u = M.setup(mppde_cfg, dev)
    result = dict(card=card, torch=torch.__version__, kernels={}, paths=[])

    result["kernels"].update(k3_times(dev, vmh_model.model.graph,
                                      mppde_model.graph))
    result["kernels"].update(k5_times(dev, gno_model.graph))
    result["kernels"].update(k6_times(dev, mppde_model.graph))
    reord = scrambled_mesh(REORD_POINTS, dev)
    result["kernels"].update(band_times(dev, [
        ("2^17 points", reord, "pbanded"),
        (f"{K7_POINTS} points", scrambled_mesh(K7_POINTS, dev), "banded")]))

    result["kernels"].update(bf16_kernel_times(
        dev, vmh_model.model.graph, mppde_model.graph, gno_model.graph))

    def epoch(model):
        def fn():
            loss, stats = T.full_batch_grad(model, vmh_u)
            rec = dict(loss=float(loss),
                       accepted=sorted({st["accepted"] for st in stats}),
                       rejected=sorted({st["steps"] - st["accepted"]
                                        for st in stats}))
            if "backward_accepted" in stats[0]:
                rec["backward_accepted"] = sorted(
                    {st["backward_accepted"] for st in stats})
            return rec
        return fn

    vmh_epoch = epoch(vmh_model)
    # the bf16 and backsolve variants on copies of the models, before any
    # step of the f32 paths moves their weights
    vmh_bf16 = copy.deepcopy(vmh_model)
    vmh_bf16.model = bf16(vmh_bf16.model)
    vmh_backsolve = copy.deepcopy(vmh_model)
    vmh_backsolve.adjoint = "backsolve"
    gno_bf16 = bf16(copy.deepcopy(gno_model))
    mppde_inner = copy.deepcopy(mppde_model)
    mppde_bf16 = bf16(mppde_inner)
    mppde_bf16.bundle = mppde_inner.bundle  # what batch_loss reads

    idx = torch.from_numpy(np.random.default_rng(gno_cfg.seed).permutation(
        gno_cfg.n_train)[:G.BATCH]).to(dev)

    def gno_step(model):
        step = make_train_step(lambda a_b, u_b: G.batch_loss(model, a_b, u_b),
                               adam(model.parameters(), gno_cfg.lr))

        def fn():
            loss, _ = step(gno_a[idx], gno_u[idx])
            return dict(loss=float(loss))
        return fn

    starts = M.window_starts(mppde_cfg, mppde_u.shape[2])
    s0s = np.random.default_rng(mppde_cfg.seed).choice(starts,
                                                       size=M.SAMPLES)

    def mppde_adam_step(model):
        step = make_train_step(
            lambda u_sim, s0s: M.batch_loss(model, u_sim, s0s),
            adam(model.parameters(), mppde_cfg.lr))

        def fn():
            loss, _ = step(mppde_u[0], s0s)
            return dict(loss=float(loss))
        return fn

    both = ("auto", "xla", "auto")
    pair = ("auto", "xla")
    runs = grand_runs(dev) + [
        ("VMH epoch gradient (K3)", both, vmh_epoch),
        ("GNO Adam step (K5)", both, gno_step(gno_model)),
        ("MP-PDE Adam step (E, K3)", both, mppde_adam_step(mppde_model)),
        ("GRAND Adam step, 2^17 mesh (F, K4)", both,
         mesh_adam_step(dev, reord))] + bf16_vmh_layer(dev) + [
        ("bf16 VMH epoch gradient (K3)", pair, epoch(vmh_bf16)),
        ("bf16 GNO Adam step (K5)", pair, gno_step(gno_bf16)),
        ("bf16 MP-PDE Adam step (K3)", pair, mppde_adam_step(mppde_bf16)),
        ("backsolve VMH epoch gradient (K3)", pair, epoch(vmh_backsolve))]
    for label, modes, fn in runs:
        for mode in modes:
            result["paths"].append(path_profile(label, mode, fn))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
