"""Smoke run of the PyTorch port (``neuralgraphpde_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Versions, the card (``nvidia-smi`` name and power limit), TF32 off.
2. Build the CUDA kernels from ``neuralgraphpde_torch/csrc`` (nvcc, sm_90a).
3. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it: max relative error ``max|k − p| / max|p|``
   (bound 1e-5 in f32, 1e-2 in bf16 against a plain version fed the same
   bf16 inputs) and CUDA-event times of both.
4. GRAND forward A: full-size synthetic Cora on the segment kernel (K1).
5. GRAND forward B: the 512×512 8-neighbour grid on the fused DIA kernel
   (K2), then with ``gcn_fused=False`` on the plain DIA stencil.
   Each forward must launch its kernels, give finite logits, and match the
   same model run with ``set_spmm_mode("xla")`` on the card (rel ≤ 1e-4).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

F32_BOUND = 1e-5
BF16_BOUND = 1e-2
GRAND_BOUND = 1e-4


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |got − want| / max |want|, max |got − want|), in f32."""
    diff = float((got.float() - want.float()).abs().max())
    return diff / max(float(want.float().abs().max()), 1e-30), diff


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def kernel_checks(P, K, dev, grid_g):
    """Phase 3: kernels vs plain versions. Returns the JSON records of the
    main-path shapes."""
    from neuralgraphpde_torch.kernels.segment_kernels import build_segment_csr
    from neuralgraphpde_torch.ops.bsr import host_edges
    from neuralgraphpde_torch.ops.dia import DiaMatrix

    rng = np.random.default_rng(0)
    records = {}

    def compare(label, kernel, plain, bound, record=None):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        rel, diff = rel_err(got, want)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        print(f"  {label:<44} rel {rel:.3e} (bound {bound:g})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms")
        check(bool(torch.isfinite(got.float()).all()), f"{label}: non-finite")
        check(rel <= bound, f"{label}: rel error {rel:.3e} > {bound:g}")
        if record is not None:
            records[record] = dict(max_abs_err=diff, max_rel_err=rel, ms=ms,
                                   plain_ms=plain_ms, shape=label)

    def normal(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev)

    # K1 on full synthetic Cora, self-looped, F = 64 (the hidden width)
    cora = P.add_self_loops(P.synthetic_cora().graph)
    s, r = host_edges(cora)
    csr = build_segment_csr(s, r, cora.num_nodes).to(dev)
    x = normal(cora.num_nodes, 64)
    compare(f"K1 cora N={cora.num_nodes} E={cora.num_edges} F=64 f32",
            lambda: K.segment_spmm(x, csr),
            lambda: K.segment_spmm_plain(x, csr), F32_BOUND)
    # K1 on rand_graph(2^18, 2^22), F = 128
    rg = P.rand_graph(2 ** 18, 2 ** 22, seed=0)
    s, r = host_edges(rg)
    csr = build_segment_csr(s, r, rg.num_nodes).to(dev)
    x = normal(rg.num_nodes, 128)
    xb = x.to(torch.bfloat16)
    label = f"K1 rand N={rg.num_nodes} E={rg.num_edges} F=128"
    compare(f"{label} f32", lambda: K.segment_spmm(x, csr),
            lambda: K.segment_spmm_plain(x, csr), F32_BOUND,
            record="segment_spmm")
    compare(f"{label} bf16", lambda: K.segment_spmm(xb, csr),
            lambda: K.segment_spmm_plain(xb, csr).to(torch.bfloat16),
            BF16_BOUND)

    # K2 on the self-looped 512² 8-neighbour grid, F = 128
    dm, dn = grid_g.cache["dia"], grid_g.cache["dia_norm"]
    n = dm.num_nodes
    x = normal(n, 128)
    w = normal(128, 128) / np.sqrt(128.0)
    b = normal(1, 128) / 10
    label = (f"K2 grid N={n} E={grid_g.num_edges} K={len(dm.offsets)} "
             f"bw={dm.bandwidth} F=128")
    compare(f"{label} stencil f32", lambda: K.dia_spmm_stencil(x, dm),
            lambda: K.dia_rhs_plain(dm, x, None, None, None, False,
                                    torch.float32),
            F32_BOUND, record="dia_spmm_stencil")
    dm16 = DiaMatrix(dm.values.to(torch.bfloat16), dm.offsets, n)
    xb = x.to(torch.bfloat16)
    compare(f"{label} stencil bf16", lambda: K.dia_spmm_stencil(xb, dm16),
            lambda: K.dia_rhs_plain(dm16, xb, None, None, None, False,
                                    torch.bfloat16),
            BF16_BOUND)
    for act in ("tanh", "relu", None):
        compare(f"{label} fused {act} W b f32",
                lambda: K.dia_gcn_rhs(act, x, w, b, dn),
                lambda: K.dia_rhs_plain(dn, x, w, b, act, True,
                                        torch.float32),
                F32_BOUND, record="dia_gcn_rhs" if act == "tanh" else None)
    compare(f"{label} fused tanh b (w=None) f32",
            lambda: K.dia_gcn_rhs("tanh", x, None, b, dn),
            lambda: K.dia_rhs_plain(dn, x, None, b.reshape(-1), "tanh", True,
                                    torch.float32),
            F32_BOUND)
    dn16 = DiaMatrix(dn.values.to(torch.bfloat16), dn.offsets, n)
    w16 = w.to(torch.bfloat16)
    compare(f"{label} fused tanh W b bf16",
            lambda: K.dia_gcn_rhs("tanh", xb, w, b, dn16),
            lambda: K.dia_rhs_plain(dn16, xb, w16, b, "tanh", True,
                                    torch.bfloat16),
            BF16_BOUND)
    return records


def grand_forward(P, model, g, x, label):
    """A first (cold) forward on the kernel path, a second (warm) one whose
    kernel launches are counted, then the same model on the xla path;
    returns (launch counts of the warm run, its seconds, solver stats)."""
    from neuralgraphpde_torch import kernels as K

    P.update_graph(model, g)
    P.set_spmm_mode("auto")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model(x)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    K.reset_launch_counts()
    t0 = time.perf_counter()
    logits = model(x)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    stats = dict(model.layer_2.last_stats)
    P.set_spmm_mode("xla")
    try:
        ref = model(x)
        torch.cuda.synchronize()
    finally:
        P.set_spmm_mode("auto")
    ref_stats = dict(model.layer_2.last_stats)
    rel, _ = rel_err(logits, ref)
    print(f"  {label}: {seconds:.4f} s/forward warm ({cold:.4f} s cold), "
          f"rhs evals {stats['nfe']}, "
          f"steps {stats['steps']} (accepted {stats['accepted']}); "
          f"xla path {ref_stats}; rel vs xla {rel:.3e}; launches {launches}")
    check(tuple(logits.shape) == (g.num_nodes, model.layer_3.out_dims),
          f"{label}: logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    check(rel <= GRAND_BOUND, f"{label}: rel {rel:.3e} vs xla > "
                              f"{GRAND_BOUND:g}")
    return launches, seconds, stats


def main() -> int:
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")

    import neuralgraphpde_torch as P
    from neuralgraphpde_torch import kernels as K
    from neuralgraphpde_torch.kernels import _build

    dev = torch.device("cuda", 0)
    _build.library()
    regs = [line.strip() for line in _build.build_info["ptxas"].splitlines()
            if "spill" in line and ("0 bytes spill" not in line)]
    info = _build.build_info
    print(f"build: {info['seconds']:.1f} s (built={info['built']}) -> "
          f"{info['path']}; ptxas lines with spills: {regs or 'none'}")

    t0 = time.perf_counter()
    grid = P.grid_graph_2d(512, 512, diagonals=True)
    grid_fused = P.precompute(grid, add_self_loops=True).to(dev)
    grid_plain = P.precompute(grid, add_self_loops=True,
                              gcn_fused=False).to(dev)
    check("dia_norm" in grid_fused.cache and "dia" in grid_plain.cache
          and "dia_norm" not in grid_plain.cache, "grid precompute keys")
    print(f"grid precompute: {time.perf_counter() - t0:.1f} s")

    print("kernel vs plain on the card:")
    records = kernel_checks(P, K, dev, grid_fused)

    with torch.inference_mode():
        print("GRAND A (synthetic Cora, K1):")
        data = P.synthetic_cora()
        g = P.precompute(data.graph, add_self_loops=True, dense=False,
                         pallas=True).to(dev)
        model = P.grand_model(1433, 64, 7, rtol=1e-3, atol=1e-3,
                              precomputed_self_loops=True,
                              generator=torch.Generator().manual_seed(0),
                              device=dev)
        x = torch.from_numpy(data.features).to(dev)
        launches_a, _, _ = grand_forward(P, model, g, x, "A")
        check(launches_a["segment_spmm"] > 0, "A: K1 not launched")

        print("GRAND B (512² grid, K2):")
        model = P.grand_model(128, 128, 7, precomputed_self_loops=True,
                              generator=torch.Generator().manual_seed(1),
                              device=dev)
        xg = torch.from_numpy(np.random.default_rng(2).normal(
            size=(grid.num_nodes, 128)).astype(np.float32)).to(dev)
        launches_b, _, _ = grand_forward(P, model, grid_fused, xg,
                                         "B fused")
        check(launches_b["dia_gcn_rhs"] > 0, "B: fused K2 not launched")
        check(launches_b["segment_spmm"] == 0, "B: K1 launched on a grid")
        conv = model.layer_2.model.layer_1
        hw, hb = conv.weight, conv.bias
        ms = cuda_ms(lambda: K.dia_gcn_rhs("tanh", xg, hw, hb,
                                           grid_fused.cache["dia_norm"]))
        print(f"  one fused GCNConv RHS layer (tanh, 128→128): {ms:.4f} ms, "
              f"{grid_fused.num_edges / (ms * 1e-3):.4e} edges/s "
              f"({grid_fused.num_edges} edges incl. self-loops)")
        launches_c, _, _ = grand_forward(P, model, grid_plain, xg,
                                         "B gcn_fused=False")
        check(launches_c["dia_spmm_stencil"] > 0,
              "B unfused: stencil K2 not launched")

    sources = {
        "segment_spmm": ("neuralgraphpde_torch/csrc/segment_spmm.cu",
                         "neuralgraphpde/kernels/segment_kernels.py:186",
                         launches_a["segment_spmm"]),
        "dia_gcn_rhs": ("neuralgraphpde_torch/csrc/dia_stencil.cu",
                        "neuralgraphpde/kernels/dia_kernels.py:223",
                        launches_b["dia_gcn_rhs"]),
        "dia_spmm_stencil": ("neuralgraphpde_torch/csrc/dia_stencil.cu",
                             "neuralgraphpde/kernels/dia_kernels.py:223",
                             launches_c["dia_spmm_stencil"]),
    }
    kernels = []
    for name, (source, replaces, launches) in sources.items():
        rec = records[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=rec["max_abs_err"],
                            max_rel_err=rec["max_rel_err"], ms=rec["ms"],
                            plain_ms=rec["plain_ms"], shape=rec["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
