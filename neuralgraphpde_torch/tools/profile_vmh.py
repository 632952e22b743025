"""Device-time profile of the fused edge-MLP kernels (K3) and of one VMH
training epoch, on one GPU.

    python -m neuralgraphpde_torch.tools.profile_vmh [--out PATH.json]

Both parts read a ``torch.profiler`` trace (CUDA activity) and count only
device events: kernels, copies and sets.

1. K3 at the VMH mesh (3,000 nodes) and at 2^15 Delaunay points, widths
   4→60→60→60 tanh, the shapes ``chip_smoke.py`` checks: device ms and
   device kernels per call of the forward kernel, the backward kernel and
   the two together, beside the plain forward (per-edge MLP +
   ``index_add_``) and the plain training pair (that forward under
   autograd, then its backward).
2. The VMH full-batch epoch gradient (``train_vmh.full_batch_grad`` at the
   full configuration: 24 sims × 3,000 points) on the K3 path (``auto``),
   the ``xla`` path, then K3 again. Each mode: one warm-up epoch, one timed
   epoch without the profiler (``wall_s``; peak device memory), one under
   it (``profiled_wall_s``). ``busy_ms`` is the union of the device events'
   intervals of the profiled epoch, ``idle_share`` is ``1 − busy_ms /
   profiled wall``, and ``top_ms`` the device time of the largest kernels
   by name.

Prints one line per measurement and, with ``--out``, writes them all as
one JSON object.
"""
from __future__ import annotations

import argparse
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
K3_REPS = 20
BENCH_POINTS = 1 << 15


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


def k3_device_times(dev, model) -> dict:
    """Part 1: K3 against its plain versions, device ms per call."""
    from ..graph.builders import delaunay_graph
    from ..kernels import fused_mlp_kernels as K3
    from ..kernels.segment_kernels import build_segment_csr
    from ..ops.bsr import host_edges

    pts = np.random.default_rng(0).random((BENCH_POINTS, 2))
    _, r = host_edges(delaunay_graph(pts.astype(np.float32)))
    bench = build_segment_csr(np.arange(len(r)), r, BENCH_POINTS,
                              num_cols=len(r)).to(dev)
    rng = np.random.default_rng(3)
    acts, dims = ("tanh", "tanh", "tanh"), (4, 60, 60, 60)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    ws = [put(rng.normal(size=(a, b)) / np.sqrt(a))
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [put(rng.normal(size=(1, b)) / 3) for b in dims[1:]]
    out = {}
    for label, csr in (("VMH mesh", model.graph.cache["tcsr_edges"]),
                       ("2^15 points", bench)):
        feats = put(rng.normal(size=(csr.num_cols, dims[0])))
        g = put(rng.normal(size=(csr.num_rows, dims[-1])))

        def plain_train():
            leaves = [t.detach().requires_grad_() for t in (feats, *ws, *bs)]
            y = K3.fused_mlp_plain(acts, csr, leaves[0], leaves[1:4],
                                   leaves[4:])
            return torch.autograd.grad(y, leaves, g)

        def kernel_train():
            K3.fused_mlp_fwd(acts, csr, feats, ws, bs)
            return K3.fused_mlp_bwd(acts, csr, feats, ws, bs, g)

        cases = {
            "fwd kernel": lambda: K3.fused_mlp_fwd(acts, csr, feats, ws, bs),
            "fwd plain": lambda: K3.fused_mlp_plain(acts, csr, feats, ws, bs),
            "bwd kernel": lambda: K3.fused_mlp_bwd(acts, csr, feats, ws, bs,
                                                   g),
            "fwd+bwd kernels": kernel_train,
            "fwd+bwd plain (autograd)": plain_train,
        }
        for what, fn in cases.items():
            for _ in range(3):  # warm-up: build, caches, allocator
                fn()
            events, _ = profile(fn, K3_REPS)
            kernels = [e for e in events if e[3] == "kernel"]
            key = (f"K3 {label} (N={csr.num_rows}, E={csr.num_cols}) "
                   f"{what}")
            out[key] = dict(
                device_ms_per_call=sum(e[2] for e in events) / K3_REPS / 1e3,
                kernels_per_call=len(kernels) / K3_REPS)
            print(f"{key}: {out[key]['device_ms_per_call']:.4f} device "
                  f"ms/call, {out[key]['kernels_per_call']:g} kernels/call",
                  flush=True)
    return out


def epoch_profile(model, u, mode: str) -> dict:
    """Part 2: one mode's warm epoch gradient, unprofiled and profiled."""
    from ..examples import train_vmh as T
    from ..ops.spmm import set_spmm_mode

    set_spmm_mode(mode)
    try:
        T.full_batch_grad(model, u)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, stats = T.full_batch_grad(model, u)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        events, profiled = profile(lambda: T.full_batch_grad(model, u))
    finally:
        set_spmm_mode("auto")
    busy = busy_us(events) / 1e3
    by_name = defaultdict(float)
    for name, _, dur, cat in events:
        if cat == "kernel":
            by_name[name[:90]] += dur / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    rec = dict(mode=mode, wall_s=wall, profiled_wall_s=profiled,
               busy_ms=busy, idle_share=1.0 - busy / (profiled * 1e3),
               peak_mem_GB=peak / 1e9,
               n_kernels=sum(e[3] == "kernel" for e in events),
               loss=float(loss), nfe=[st["nfe"] for st in stats],
               accepted=[st["accepted"] for st in stats], top_ms=top)
    print(f"VMH epoch gradient, {mode}: wall {wall:.4f} s (profiled "
          f"{profiled:.4f} s), device busy {busy:.3f} ms, idle share "
          f"{rec['idle_share']:.4f}, {rec['n_kernels']} kernels, peak "
          f"{rec['peak_mem_GB']:.4f} GB, loss {rec['loss']:.7f}, accepted "
          f"steps/sim {sorted(set(rec['accepted']))}", flush=True)
    for name, ms in top:
        print(f"    {ms:10.3f} ms  {name}")
    return rec


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", help="write every measurement here as JSON")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from ..examples import train_vmh as T

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model, u = T.setup(T.Config(), dev)
    result = dict(card=card, torch=torch.__version__,
                  k3=k3_device_times(dev, model.model),
                  epochs=[epoch_profile(model, u, mode)
                          for mode in ("auto", "xla", "auto")])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
