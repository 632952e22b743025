"""Smoke run of the PyTorch port (``neuralgraphpde_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Versions, the card (``nvidia-smi`` name and power limit), TF32 off.
2. Build the CUDA kernels from ``neuralgraphpde_torch/csrc`` (nvcc, sm_90a);
   ptxas must report no spill in ``dia_stencil.cu`` (K2), and neither a
   spill nor a stack frame in any of the four dtype instantiations of each
   of K3's kernels (the streamed forward and backward and the resident
   forward and backward: ``fused_mlp_fwd_stream_kernel``,
   ``fused_mlp_bwd_stream_kernel``, ``fused_mlp_fwd_resident_kernel``,
   ``fused_mlp_bwd_kernel`` in ``fused_mlp.cu``) nor in any instantiation
   of K5's reduce, product and per-edge backward (the 4 of
   ``gno_reduce_kernel``, the 12 of ``gno_gemm_kernel``, the 8 of
   ``gno_edge_bwd_kernel``, whole and sliced, in ``gno.cu``), each report
   line
   attributed to the function ptxas names before it; the functions of
   ``fused_mlp.cu`` and ``gno.cu`` that spill, if any, are printed; and
   neither in the six instantiations (f32, bf16, f64, each with 16-byte
   vectors and scalar) of each RK stage kernel in ``rk_stage.cu``
   (``rk_combine_kernel``, ``rk_norm_kernel``, ``rk_scatter_kernel``, and
   ``rk_combine_dh_kernel`` and ``rk_norm_dh_kernel``, which read the step
   size from the card), nor in the two instantiations (heads of 64 and
   128) of each of K8's kernels in ``mesh_attention.cu``
   (``attention_fwd_kernel``, ``attention_bwd_kv_kernel``,
   ``attention_bwd_q_kernel``).
3. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it: max relative error ``max|k − p| / max|p|``
   (bound 1e-5 in f32, 1e-2 in bf16 against a plain version fed the same
   bf16 inputs), CUDA-event times of both and, where one PyTorch call
   computes the same function, of that call (``library``:
   ``torch.sparse.mm`` on the CSR for K1 and the plain DIA stencil,
   ``scatter_reduce_`` for K6), and the least time the card could take
   (``bound``: the compulsory bytes over 3.35 TB/s or the operations over
   67 TFLOP/s in f32, 989 TFLOP/s where every operand is bf16, whichever
   is larger; H100 SXM data sheet). K3, K5 and K6 also in their bf16
   forms, each against its plain version fed the same operands: K3 with
   bf16 weights and bf16 or f32 features, K5 with bf16 weights and ``ph``
   and ``h`` in bf16 or f32 (the precision policy leaves f32 graph data
   f32, so its features often stay f32), forward and every gradient within
   1e-2 of its own largest entry, in the JAX kernels' output dtypes; K6 on
   bf16 messages, forward and backward equal bit for bit.
   The fused edge-MLP kernels (K3) at the VMH mesh (3,000 nodes) and at
   2^15 Delaunay points, widths 4→60→60→60 tanh (the resident variant), at
   the MP-PDE ϕ on the Burgers chain (1,024 edges, 282→128 swish) and at
   2^15 points with 4→128→128→128 tanh (the streamed variant, or resident
   forward and streamed backward): forward and ``dfeats`` within 1e-5,
   ``dW``/``db`` within 1e-4 (sums over every edge in another order); the
   forward and the backward are timed (by events and on the device,
   ``torch.profiler``), the backward against autograd through the plain
   forward, and the
   training pair (forward + backward) against the plain forward under
   autograd plus its backward.
   The GNO kernels (K5) at the config-4 Darcy graph (32² grid, radius
   0.08: 1,024 nodes, 19,092 edges) and at the n = 64 grid (4,096 nodes,
   335,480 edges), K 128, IN = OUT = 64, with a bias: forward, ``dph`` and
   ``dh`` within 1e-5, ``dWl``/``dbl`` within 1e-4 (sums over every
   receiver in another order); timed as K3 is. At 32² the reduce (S, in
   the forward and again in the backward) is also printed alone: its
   device ms from the split by launch beside its own bound (ph, h, the CSR
   and senders read once, S written once; E·IN·KB multiply-adds), recorded
   as ``reduce_device_ms`` and ``reduce_bound_ms``. That bound is not
   gated: at 32² the reduce's 45 MB can stay in the 50 MB L2 across timed
   calls. At 32² a digest of the forward's output, ``dph``, ``dWl`` and
   ``dbl`` is printed, to compare bit for bit with another checkout's.
   Then K5 at the graph kernel network's widths on the ``gno-darcy``
   cell's graph (``bench_torch/traffic/darcy.py::ball_edges``: the 61²
   grid at spacing 1/60, every node within radius 0.1 by float64
   distance, self-loops: 3,721 nodes, 383,293 edges; K 1,024,
   IN = OUT = 64, a bias): the reduce's passes and the per-edge backward's
   slices (``gno_plan``), forward and backward against the plain versions
   at the same bounds, each timed by events (kernel and plain) beside its
   bound, and its device ms by launch; recorded as ``gkn`` in K5's
   ``kernels`` entries.
   The segment-max kernel (K6), max and min (−max(−m)), forward and the
   backward of its autograd call, at the ``bench.py`` ``rand`` shape (the
   K1 graph's edge-id layout, F = 128), on that graph with the edges of
   every 97th receiver dropped (empty rows), and on the Burgers chain
   (256 nodes, 1,024 edges, F = 128), messages with ties (a third rounded
   to a 0.5 grid, clamped at 0): equal to the plain versions bit for bit.
   The block-band kernels (K4 packed, K7 dense) at the scrambled-label
   Delaunay meshes that ``precompute(add_self_loops=True, dense=False,
   auto_reorder=True)`` relabels by RCM (``default_rng(0)`` points): K4 at
   2^17 points (the JAX ``bench.py`` reord mesh; 512 × 128 packed blocks),
   K7 at 3,000 and 12,000 points (256 × 256 dense bands), F = 128: the
   SpMM and the fused right-hand side (tanh, W 128×128, b) in f32 (1e-5)
   and in bf16 storage (1e-2), and the backward of each
   ``autograd.Function`` against autograd through the plain version (``dx``
   1e-5, ``dW``/``db`` 1e-4); times of the kernel (by events and on the
   device, ``torch.profiler``), the plain version, ``torch.sparse.mm`` on
   the same relabeled CSR, and K1 on that CSR (the gather path that JAX's
   dispatch passes over here). Their bound is the function's on its
   nonzeros, K1's on that CSR; the occupied 32 × 32 sub-tiles the kernel
   walks and the bytes it reads are printed beside it.
   Any kernel timed below its bound (by events or on the device) fails
   the run: no card beats its bound. The fused K2 (tanh, W 128×128, b) is
   also timed against its unfused composition on the same inputs (the
   stencil kernel, ``torch.addmm``, ``tanh``: ``unfused_ms``, three calls,
   so not a library time), which says whether the fusion pays.
4. GRAND A: full-size synthetic Cora on the segment kernel (K1).
5. GRAND B: the 512×512 8-neighbour grid on the fused DIA kernel (K2),
   then with ``gcn_fused=False`` on the plain DIA stencil.
   Each forward (at the model's tolerances, rtol = atol = 1e-3) must
   launch its kernels and give finite logits of the right shape. Parity:
   the same model at solver tolerance 1e-5 on the kernel path and with
   ``set_spmm_mode("xla")`` must take the same steps and agree within rel
   1e-4. At 1e-3 the first step's error estimate is at f32 rounding level,
   so the order of the xla path's scatter-add (atomics: it changes from run
   to run) moves the step sizes, and the xla path differs from itself by up
   to ~1e-4; the script prints that spread and the kernel path's distance
   at 1e-3 without gating on them. Then the gradient of the masked
   cross-entropy on the kernel path (K1, the fused K2 with its fused
   backward, the stencil K2 launched in its own backward) against the
   ``xla`` path run with
   ``torch.use_deterministic_algorithms``, at the model's tolerances and at
   solver tolerance 1e-5: loss rel ≤ 1e-4, every gradient within 1e-3 of
   its own largest entry, the same accepted steps. The one exception is
   counted, not assumed: where the encoder's ReLU output is zero in one run
   and positive in the other (a pre-activation within rounding of 0, the
   two paths summing in different orders), one node's term of the
   encoder's gradients moves (1.35e-3 of the encoder weight's largest
   entry on the 512² grid); then those gradients are held to 5e-3, and each
   flipped entry must sit within 1e-5 of the largest output.
   GRAND on the 2^17-point mesh (K4) and on the 12,000-point mesh (K7):
   128 → 128 → 7, features, labels and a 10% train mask drawn by a seeded
   numpy generator in the original numbering and permuted with
   ``permute_nodes``: the forward parity as above, the gradient on the
   fused right-hand side and on the plain SpMM (the graph without its
   normalized storage) against ``xla``, with the peak memory, then 3 Adam
   steps, each launching the fused kernel forward and in the backward.
   Config 1: ``train_grand_cora`` with its defaults for 20 epochs (dense
   adjacency, no kernel, as in JAX; validation accuracy ≥ 0.90), then 3
   epochs on the pallas layout, K1 launched forward and backward. The
   hybrid DIA: a GRAND forward on the 256² periodic 8-neighbour grid
   (``dia`` + ``dia_rem``) on the stencil K2 plus the COO remainder, parity
   as above.
   K2's fused backward alone on the 512² grid, tanh with W and b at F =
   out = 64 and 128, against its plain version (``dia_gcn_bwd_plain``:
   dx ≤ 1e-5 of its largest entry, dW and db ≤ 1e-4), the same bits on a
   second call, CUDA-event ms beside the composition it replaced on the
   same inputs (``plain_ms``), the bound from
   ``bench_torch/core/counts.py::gcn_backward``'s operations and the bytes
   the DIA pass moves; then one
   ``grand-grid.train`` step (1433 → 64 → 7 on the grid, one Adam step):
   every backward call on the fused kernel, none eager, no stencil in a
   backward.
   The solver's RK stage kernels (``csrc/rk_stage.cu``; no Pallas source:
   XLA fused this algebra in the JAX package), each alone at the grid
   state (262,144 × 64 f32) and at a VMH solve's state (3,000 × 1 f32)
   against the eager composition it replaced on the same inputs
   (``plain``): a Tsit5 stage input (base and six terms), the Hermite
   save (four terms), the error norm (seven terms over max(|y0|, |y1|)),
   and the backward of a step's first stage (six cotangents to ``k0``'s
   and ``y``'s), and the stage input and the error norm again with the
   step size a 0-d float64 tensor on the card (``rk_combine_dh_kernel``,
   ``rk_norm_dh_kernel``, which a captured solver attempt runs) against
   the plain versions fed its ``float``; the same bits (the norms within
   1e-6, the same bits again on a rerun, and the device-h norm the same
   bits as the host-h one), CUDA-event ms of each, and the bound (the
   bytes, each input read once and each output written once, over 3.35
   TB/s).
6. VMH training at the full configuration (24 sims × 3,000 points, ϕ
   4→60→60→60→40, γ 41→60→60→60→1, Tsit5 at rtol 1e-5 / atol 1e-3):
   the epoch-1 full-batch loss and gradients on the K3 path and on the
   ``xla`` path agree (loss rel ≤ 1e-4, each gradient within 1e-3 of its
   largest entry, the same accepted steps per sim); then 3 full-batch Rprop
   epochs on the K3 path, each launching both K3 kernels, with finite
   losses and gradients. Then one right-hand-side evaluation of that
   model (``VMHConv`` on its 3,000-point mesh, under ``inference_mode``),
   eager against one replay of its captured CUDA graph
   (``nn/conv.py::vmh_graph``), in turns (eager, graphed, graphed, eager):
   host µs an evaluation (issuing 200 calls, the card left to catch up
   after), wall µs an evaluation (the same calls to the last one's end),
   device µs and device kernels an evaluation (``torch.profiler``); every
   graphed output equal to the eager one bit for bit.
7. GNO Darcy training at the full configuration (``train_gno_darcy``
   defaults: 32 samples on the 32² grid, width 64, ϕ 6→128→128→4096, 4
   convs, Adam 1e-3, batches of 4): the first batch's loss and parameter
   gradients on the K5 path and on the ``xla`` path (every edge's 64×64
   matrix) agree (loss rel ≤ 1e-5, each gradient within 1e-4 of its
   largest entry); then one epoch of Adam steps (6) on the K5 path, each
   launching K5 16 times forward and 16 times backward, with finite losses
   and gradients; then the test MSE on the 8 held-out samples.
8. ``MPPDEConv(aggr="max")`` at the config-3 widths (H 128, K 25, ϕ
   282→128→128, ψ 256→128→128, swish) on the Burgers chain: ϕ on every
   edge, then K6 (counted); output within 1e-5 of the ``xla`` path, the
   gradients of x and of every parameter within 1e-4 of their largest
   entry.
9. MP-PDE Burgers training at the full configuration
   (``train_mppde_burgers`` defaults: 32 sims on the 256-node chain, 101
   saves, K 25, hidden 128, depth 6, Adam 1e-4, pushforward): the dataset
   build time; the first step's loss and gradients on the K3 path and the
   ``xla`` path (loss rel ≤ 1e-5, each gradient within 1e-4 of its largest
   entry); one epoch (32 Adam steps), each launching K3 48 times forward
   and 48 times backward (4 windows × 2 calls × 6 convs), with finite
   losses; the first simulation's rollout RMSE.

10. The bf16 precision policy on the paths above, each against the same
   model on the ``xla`` path in bf16 (loss rel ≤ 1e-2, each gradient
   within 5e-2 of its own largest entry; each kernel's bf16 launches
   counted from 0 over the kernel-path run): ``bf16(VMHConv)`` at
   ``bench.py``'s VMH case (2^15 Delaunay points, hidden 60, message 40;
   forward and the gradient of ``sum(y²)``, K3 resident), timed beside the
   f32 layer; ``NeuralGraphODE(bf16(VMHConv))`` at config 2 (the epoch-1
   gradient with the accepted and rejected steps per sim of the bf16 K3,
   bf16 xla and f32 runs, then one Rprop epoch); ``bf16(GNOModel)`` at
   config 4 (batch-1 gradient, K5); ``bf16(MPPDEConv(aggr="max"))`` at the
   config-3 widths with bf16 graph data (bf16 messages into K6: output and
   gradients equal bit for bit to the same path with K6's plain version,
   output equal to xla's; the gradient gap to xla's tie-splitting rule is
   printed with the number of ties); ``bf16(MPPDESolver)`` at config 3
   (step-1 gradient, K3 streamed).
11. Config 2 in f32 with ``adjoint="backsolve"``: the epoch-1 gradient on
   K3 (K3 forward and backward in each augmented evaluation) against the
   xla path's backsolve: loss rel ≤ 1e-4, each gradient within 1e-3 of its
   largest entry, the same accepted steps forward and backward per sim;
   seconds and peak memory beside the checkpoint epoch.
12. GraphCast at its published 0.25° widths (``graphcast_graphs()``: the
   40,962-node multimesh, the 721 × 1,440 grid; ``precompute_graphs`` with
   Grid2Mesh in 4 and Mesh2Grid in 8 receiver blocks, as the
   ``graphcast-0p25`` configuration runs): K1 (``segment_spmm`` on
   ``tcsr_edges``, the edge-id layout: as many columns as edges, rows the
   receivers) at F 512 on the multimesh's 327,660 edges and on the first
   Grid2Mesh and Mesh2Grid receiver blocks (a few hundred thousand edges
   each, senders of another node set) against its plain version within
   1e-5, timed beside its bound; then one AdamW step of ``GraphCast(
   recompute=True)`` on N(0, 1) inputs, with K1's counters set to 0 just
   before it: a finite loss, 36 interaction forwards, and K1 launched
   twice for each of its 28 calls a forward (16 processor layers, 12
   blocks; the recomputation runs each again), none of them in the
   backward (over the edge-id layout K1's backward is a gather); its
   seconds and peak memory are printed.
13. K8, the mesh attention (``csrc/mesh_attention.cu``), at
   GenCast's published shapes: the M6 mesh in its local order, the
   32-hop layout built on the card, 4 heads of 128: forward within 1e-5
   and every gradient within 1e-4 of the plain version, the kernel's
   forward and forward-and-backward times beside its bound (the least
   work over the pairs that attend at 67 TFLOP/s), the plain version's
   and SDPA's with the dense mask on 4,096 queries (``library_ms``, a
   yardstick the port never calls); then one GenCast AdamW step (the
   published widths, recomputation) with K8's counters set to 0 before
   it and under the profiler: a finite loss, 4 launches a layer (forward,
   the recomputation's forward, the two backward kernels), 2 of them in
   the backward, the pairs they computed (the tiles' area a launch), and
   no PyTorch attention operator. Alone: ``python3 -c`` importing
   ``chip_smoke``, TF32 off, then ``gencast_checks(P, K,
   torch.device("cuda", 0))`` (~2 min with the graph build).

The line before the last is ``{"kernels": [...]}``: twelve kernels with
their operand ``dtypes`` (K4 and K7 also with their ``device_ms``, the fused K2
with its ``unfused_ms``), the K1, K2, K4 and K7 entries with their launches
in each gradient run (K1's also in the GraphCast step, its GraphCast
shapes in ``other_shapes``) and the part of them made in the backward (the
block-band fused right-hand sides' backward launches are SpMM launches,
counted on the SpMM; the DIA one's is its own, ``dia_gcn_rhs backward``,
after K6), K3's with their launches in the backsolve gradient; then the five
bf16 forms (K3 forward and backward, K5 forward and backward, K6), each at
its bf16 path's shape and operand dtypes with its bf16 bound, library time
and launches on that path, and every form's record; then the two RK
stage wrappers (``rk_combine``, whose records are the stage input, the
Hermite save, the backward's scatter and the stage input with the step
size on the card, and ``rk_norm``, with the norm with the step size on the
card beside it), with
``replaces`` null, at the grid state with the VMH state beside it, and
their launches in GRAND B's gradient; then K8 (``mesh_attention``,
route ``cuda``, ``replaces`` null) with its training pair and its
launches, backward launches and pairs in the GenCast step. The last line
is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

F32_BOUND = 1e-5
BF16_BOUND = 1e-2
GRAND_BOUND = 1e-4
# solver tolerance of the GRAND kernel-vs-xla parity check
GRAND_PARITY_TOL = 1e-5
# K3 dW/db: sums over every edge, taken in another order than the plain
# version's
K3_PARAM_BOUND = 1e-4
VMH_LOSS_BOUND = 1e-4
VMH_GRAD_BOUND = 1e-3
VMH_POINTS_BENCH = 1 << 15
VMH_GRAPH_REPS = 200
# K5 dWl/dbl: sums over every receiver, taken in another order than the
# plain version's
K5_PARAM_BOUND = 1e-4
GNO_LOSS_BOUND = 1e-5
GNO_GRAD_BOUND = 1e-4
GNO_N_BENCH = 64  # the resolution-transfer grid
MPPDE_LOSS_BOUND = 1e-5
MPPDE_GRAD_BOUND = 1e-4
# K4/K7 dW/db: sums over every node, taken in another order than the plain
# version's
BAND_PARAM_BOUND = 1e-4
# GRAND gradients against the (deterministic) xla path: the VMH bounds, each
# gradient over its own largest entry
GRAND_LOSS_BOUND = 1e-4
GRAND_GRAD_BOUND = 1e-3
# the encoder's gradients when its ReLU output is zero in one run and not in
# the other at some entry (a pre-activation within rounding of 0 moves one
# node's term: 1.35e-3 of the encoder weight's largest entry on the 512²
# grid, H100), and the level each such entry must sit at (its output over
# the largest output)
GRAND_FLIP_BOUND = 5e-3
GRAND_FLIP_LEVEL = 1e-5
REORD_POINTS = 1 << 17  # the JAX bench.py reord mesh
K7_POINTS = (3000, 12000)
HYBRID_GRID = 256
CORA_EPOCHS = 20
CORA_VAL_ACC = 0.90
# bf16 paths (the precision policy) against the same model on the xla path
# in bf16: the two round to bf16 at other places
BF16_LOSS_BOUND = 1e-2
BF16_GRAD_BOUND = 5e-2
# the backsolve VMH gradient on K3 against the xla path's backsolve
BACKSOLVE_LOSS_BOUND = 1e-4
BACKSOLVE_GRAD_BOUND = 1e-3
# graphcast-0p25: latent width, and Grid2Mesh's and Mesh2Grid's receiver
# blocks (bench_torch/configs/graphcast-0p25.json)
GRAPHCAST_F = 512
GRAPHCAST_BLOCKS = (4, 8)
# gencast-0p25: the attention's hops on M6, and the queries of the SDPA
# yardstick (a dense (queries, nodes) mask)
GENCAST_HOPS = 32
GENCAST_SDPA_QUERIES = 4096
# H100 SXM (NVIDIA data sheet, 700 W): device-memory rate, the f32 rate
# outside the tensor cores (every kernel here computes in true f32), and
# the dense bf16 tensor-core rate (the bound of a function whose operands
# are all bf16)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
BF16 = torch.bfloat16


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


def digest(t: torch.Tensor) -> str:
    """A digest of the bytes of tensor ``t``."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()[:16]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: float, ops: float, rate: float = F32_FLOP_PER_S) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``n_bytes`` (each input read once, each output written once) and
    do ``ops`` operations (an FMA is two) at ``rate`` (the f32 rate, or the
    bf16 tensor-core rate where every operand is bf16)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_bytes(csr) -> int:
    """The layout a kernel reads: row offsets, columns, weights."""
    return nbytes(csr.row_ptr, csr.col, csr.weight)


def check_bounds(records, where: str = "kernels") -> None:
    """Fail when a record's time (``ms`` by events, ``device_ms``) is below
    its ``bound_ms``: no card beats its bound, so such a time or such a
    bound is wrong. Walks nested records."""
    if isinstance(records, dict):
        b_ms = records.get("bound_ms")
        for key in ("ms", "device_ms"):
            t = records.get(key)
            if b_ms is not None and t is not None:
                check(t >= b_ms, f"{where}: {key} {t:.4f} below its bound "
                                 f"{b_ms:.4f} ms")
        for key, value in records.items():
            check_bounds(value, f"{where}/{records.get('name', key)}")
    elif isinstance(records, list):
        for value in records:
            check_bounds(value, where)


def spills(log: str) -> list:
    """ptxas lines of ``log`` that report a spill."""
    return [line.strip() for line in log.splitlines()
            if "spill" in line and "0 bytes spill" not in line]


def ptxas_by_function(log: str) -> dict:
    """ptxas's report ``log`` by function: ``{mangled name: (spill lines,
    stack frame bytes)}`` for every function it compiled (ptxas names a
    function, then reports its stack frame and spills on a line of its
    own)."""
    out, name = {}, None
    for line in log.splitlines():
        for mark in ("Compiling entry function '", "Function properties for "):
            if mark in line:
                name = line.split(mark, 1)[1].split("'")[0].strip()
                out.setdefault(name, ([], [0]))
        if name is not None:
            out[name][0].extend(spills(line))
            frame = re.search(r"(\d+) bytes stack frame", line)
            if frame:
                out[name][1][0] = int(frame[1])
    return {f: (lines, frame[0]) for f, (lines, frame) in out.items()}


def kernel_checks(P, K, dev, grid_g, rand_edges):
    """Phase 3, K1 and K2: kernels vs plain versions. Returns the JSON
    records of the main-path shapes."""
    from neuralgraphpde_torch.kernels.segment_kernels import build_segment_csr
    from neuralgraphpde_torch.ops.bsr import host_edges
    from neuralgraphpde_torch.ops.dia import DiaMatrix

    rng = np.random.default_rng(0)
    records = {}

    def compare(label, kernel, plain, bound_to, record=None, library=None,
                work=None, unfused=None):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        rel, diff = rel_err(got, want)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        lib_ms = None if library is None else cuda_ms(library)
        unfused_ms = None if unfused is None else cuda_ms(unfused)
        b_ms = b_by = None
        line = (f"  {label:<44} rel {rel:.3e} (bound {bound_to:g})  kernel "
                f"{ms:.4f} ms  plain {plain_ms:.4f} ms")
        if library is not None:
            lib_rel = rel_err(library(), want)[0]
            line += f"  library {lib_ms:.4f} ms (rel {lib_rel:.1e})"
        if unfused is not None:
            unf_rel = rel_err(unfused(), want)[0]
            line += f"  unfused {unfused_ms:.4f} ms (rel {unf_rel:.1e})"
        if work is not None:
            b_ms, b_by = bound(*work)
            line += f"  bound {b_ms:.4f} ms ({b_by})"
        print(line)
        check_bounds(dict(ms=ms, bound_ms=b_ms), label)
        check(bool(torch.isfinite(got.float()).all()), f"{label}: non-finite")
        check(rel <= bound_to, f"{label}: rel error {rel:.3e} > "
                               f"{bound_to:g}")
        if record is not None:
            records[record] = dict(max_abs_err=diff, max_rel_err=rel, ms=ms,
                                   plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=b_ms, bound_by=b_by, shape=label)
            if unfused is not None:
                records[record]["unfused_ms"] = unfused_ms

    def normal(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev)

    def sparse_csr(csr, n_cols):
        """The same CSR as a torch sparse tensor (for ``torch.sparse.mm``,
        timed as the library call; the port never calls it)."""
        with warnings.catch_warnings():  # "beta", "invariant checks"
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(csr.row_ptr, csr.col, csr.weight,
                                           size=(csr.num_rows, n_cols))

    # K1 on full synthetic Cora, self-looped, F = 64 (the hidden width)
    cora = P.add_self_loops(P.synthetic_cora().graph)
    s, r = host_edges(cora)
    csr = build_segment_csr(s, r, cora.num_nodes).to(dev)
    x = normal(cora.num_nodes, 64)
    compare(f"K1 cora N={cora.num_nodes} E={cora.num_edges} F=64 f32",
            lambda: K.segment_spmm(x, csr),
            lambda: K.segment_spmm_plain(x, csr), F32_BOUND)
    # K1 on rand_graph(2^18, 2^22), F = 128
    s, r, n = rand_edges
    csr = build_segment_csr(s, r, n).to(dev)
    x = normal(n, 128)
    xb = x.to(torch.bfloat16)
    a = sparse_csr(csr, n)
    label = f"K1 rand N={n} E={len(r)} F=128"
    compare(f"{label} f32", lambda: K.segment_spmm(x, csr),
            lambda: K.segment_spmm_plain(x, csr), F32_BOUND,
            record="segment_spmm", library=lambda: torch.sparse.mm(a, x),
            work=(nbytes(x, x) + csr_bytes(csr), 2.0 * len(r) * 128))
    compare(f"{label} bf16", lambda: K.segment_spmm(xb, csr),
            lambda: K.segment_spmm_plain(xb, csr).to(torch.bfloat16),
            BF16_BOUND)
    del a

    # K2 on the self-looped 512² 8-neighbour grid, F = 128
    dm, dn = grid_g.cache["dia"], grid_g.cache["dia_norm"]
    n = dm.num_nodes
    e = grid_g.num_edges
    x = normal(n, 128)
    w = normal(128, 128) / np.sqrt(128.0)
    b = normal(1, 128) / 10
    gs, gr = host_edges(grid_g)
    a = sparse_csr(build_segment_csr(gs, gr, n).to(dev), n)
    label = (f"K2 grid N={n} E={e} K={len(dm.offsets)} "
             f"bw={dm.bandwidth} F=128")
    compare(f"{label} stencil f32", lambda: K.dia_spmm_stencil(x, dm),
            lambda: K.dia_rhs_plain(dm, x, None, None, None, False,
                                    torch.float32),
            F32_BOUND, record="dia_spmm_stencil",
            library=lambda: torch.sparse.mm(a, x),
            work=(nbytes(x, x, dm.values), 2.0 * e * 128))
    del a
    dm16 = DiaMatrix(dm.values.to(torch.bfloat16), dm.offsets, n)
    xb = x.to(torch.bfloat16)
    compare(f"{label} stencil bf16", lambda: K.dia_spmm_stencil(xb, dm16),
            lambda: K.dia_rhs_plain(dm16, xb, None, None, None, False,
                                    torch.bfloat16),
            BF16_BOUND)
    for act in ("tanh", "relu", None):
        # the yardstick of the fusion: the stencil kernel, then addmm and
        # tanh, on the same inputs (three calls, so not a library time)
        compare(f"{label} fused {act} W b f32",
                lambda: K.dia_gcn_rhs(act, x, w, b, dn),
                lambda: K.dia_rhs_plain(dn, x, w, b, act, True,
                                        torch.float32),
                F32_BOUND, record="dia_gcn_rhs" if act == "tanh" else None,
                work=(nbytes(x, x, dn.values, w, b),
                      2.0 * e * 128 + 2.0 * n * 128 * 128),
                unfused=(lambda: torch.tanh(torch.addmm(
                    b, K.dia_spmm_stencil(x, dn), w))) if act == "tanh"
                else None)
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


def scrambled_mesh(P, points: int, dev):
    """The Delaunay mesh of ``points`` ``default_rng(0)`` points (their
    order is random: scrambled labels) through ``precompute(
    add_self_loops=True, dense=False, auto_reorder=True)``, on ``dev``;
    prints the storage and the RCM (timed alone) and precompute seconds."""
    from neuralgraphpde_torch.ops.bsr import host_edges

    pts = np.random.default_rng(0).random((points, 2)).astype(np.float32)
    t0 = time.perf_counter()
    g = P.delaunay_graph(pts)
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    P.rcm_order(*host_edges(P.add_self_loops(g)), points)
    rcm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gp = P.precompute(g, add_self_loops=True, dense=False, auto_reorder=True)
    pre_s = time.perf_counter() - t0
    gp = gp.to(dev)
    kind = "pbanded" if "pbanded" in gp.cache else "banded"
    st = gp.cache.get(kind)
    check(st is not None and "node_order" in gp.cache
          and kind + "_norm" in gp.cache, f"mesh {points}: no block bands")
    print(f"  mesh {points} points: {g.num_edges} edges; {kind} blocks "
          f"{tuple(st.blocks.shape)} (S={st.blocks.shape[0]}, nb={st.nb}, "
          f"{st.row_height}x{st.tb}, {nbytes(st.blocks) / 1e9:.3f} GB a "
          f"storage); Delaunay {mesh_s:.1f} s, RCM order alone {rcm_s:.1f} "
          f"s, precompute (RCM, relabel, CSR layouts, 4 block storages) "
          f"{pre_s:.1f} s")
    return gp, kind


def subtile_bytes(st, f: int) -> tuple:
    """(occupied sub-tiles, bytes) of what the block-band kernel reads for
    ``A @ x`` at ``f`` features: the listed sub-tiles of the blocks, the
    index and the cols table, one x chunk per listed sub-tile and feature
    tile (each tile loads its own), out written once."""
    idx = st.tiles
    m = idx.ent.numel()
    es = st.blocks.element_size()
    return m, (m * idx.rows * idx.cols * es
               + nbytes(idx.ptr, idx.ent, st.cols) + m * idx.cols * f * es
               + 4 * st.num_nodes * f)


def band_checks(K, dev, cases):
    """Phase 3, K4 and K7: the SpMM and the fused right-hand side (tanh,
    W 128×128, b) against their plain versions on each ``(label, graph,
    kind, main_path)`` mesh, F = 128: forward in f32 and in bf16 storage,
    and the backward of each ``autograd.Function`` against autograd
    through the plain version. Times: kernel (by events and device),
    plain, ``torch.sparse.mm`` on the same relabeled CSR (library) and K1
    on that CSR. The bound is the function's, on its nonzeros (K1's on
    the same CSR); the bytes the kernel's design reads, counted from the
    occupied sub-tiles it walks (not measured), are printed beside it.
    Returns the JSON records of the main-path meshes."""
    import dataclasses

    from neuralgraphpde_torch.tools.profile_paths import device_per_call

    rng = np.random.default_rng(7)
    records = {}

    def put(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(dev)

    for label, g, kind, main_path in cases:
        st, st_rev = g.cache[kind], g.cache[kind + "_rev"]
        nrm, nrm_rev = g.cache[kind + "_norm"], g.cache[kind + "_norm_rev"]
        spmm = (K.pbanded_spmm_pallas if kind == "pbanded"
                else K.banded_spmm_pallas)
        rhs = K.pbanded_gcn_rhs if kind == "pbanded" else K.banded_gcn_rhs
        n, f = st.num_nodes, 128
        S, nb, tbr, tb = st.blocks.shape[0], st.nb, st.row_height, st.tb
        tag = "K4" if kind == "pbanded" else "K7"
        shape = (f"{tag} {label} N={n} E={g.num_edges} S={S} nb={nb} "
                 f"{tbr}x{tb} F={f}")
        x, w, b, gy = put(n, f), put(f, f, scale=f ** -0.5), put(
            1, f, scale=0.1), put(n, f)
        csr = g.cache["tcsr"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            a = torch.sparse_csr_tensor(csr.row_ptr, csr.col, csr.weight,
                                        size=(n, n))
        # the work the function needs, whatever computes it (K1's on the
        # same CSR): one multiply-add per nonzero and feature and the W
        # epilogue's; the nonzeros' values and columns, the row offsets, x
        # read once, out written once (and W, b)
        macs = float(csr.col.numel() * f)
        fn_bytes = csr_bytes(csr) + nbytes(x) + 4 * n * f
        forms = {
            "spmm": (lambda: spmm(x, st),
                     lambda: K.block_rhs_plain(st, x, None, None, None, False),
                     (fn_bytes, 2 * macs), st),
            "gcn_rhs": (lambda: rhs("tanh", x, w, b, nrm),
                        lambda: K.block_rhs_plain(nrm, x, w, b, "tanh", True),
                        (fn_bytes + nbytes(w, b), 2 * macs + 2.0 * n * f * f),
                        nrm)}
        rec, subtiles = {}, {}
        for what, (kern, plain, work, store) in forms.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            rel, diff = rel_err(got, want)
            check(bool(torch.isfinite(got).all()), f"{shape} {what}: "
                                                   f"non-finite")
            check(rel <= F32_BOUND, f"{shape} {what}: rel {rel:.3e}")
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            b_ms, b_by = bound(*work)
            occupied, own_bytes = subtile_bytes(store, f)
            subtiles[what] = dict(
                occupied=occupied, rows=store.tiles.rows,
                cols=store.tiles.cols, of=store.blocks.numel() // (
                    store.tiles.rows * store.tiles.cols),
                kernel_bytes=own_bytes, stored_bytes=nbytes(store.blocks))
            rec[what] = dict(max_abs_err=diff, max_rel_err=rel, ms=ms,
                             device_ms=device_per_call(kern)[0],
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None, shape=shape)
            check_bounds(rec[what], f"{shape} {what}")
            del got, want
        lib_rel = rel_err(torch.sparse.mm(a, x), forms["spmm"][1]())[0]
        rec["spmm"]["library_ms"] = cuda_ms(lambda: torch.sparse.mm(a, x))
        k1_ms = cuda_ms(lambda: K.segment_spmm(x, csr))
        rec["spmm"]["k1_same_csr_ms"] = rec["gcn_rhs"]["k1_same_csr_ms"] = \
            k1_ms
        # bf16 storage: bf16 blocks and x, f32 accumulation
        field = "blocks" if kind == "pbanded" else "bands"
        st16 = dataclasses.replace(st, **{field: st.blocks.to(torch.bfloat16)})
        nrm16 = dataclasses.replace(nrm,
                                    **{field: nrm.blocks.to(torch.bfloat16)})
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        rel16 = max(
            rel_err(spmm(x, st16), K.block_rhs_plain(st16, xb, None, None,
                                                     None, False))[0],
            rel_err(rhs("tanh", x, w, b, nrm16),
                    K.block_rhs_plain(nrm16, xb, wb, b, "tanh", True))[0])
        check(rel16 <= BF16_BOUND, f"{shape} bf16: rel {rel16:.3e}")
        del st16, nrm16, xb, wb
        # backward: the autograd.Function vs autograd through the plain
        leaves_k = [t.clone().requires_grad_() for t in (x, w, b)]
        leaves_p = [t.clone().requires_grad_() for t in (x, w, b)]
        rhs("tanh", *leaves_k, nrm, nrm_rev).backward(gy)
        K.block_rhs_plain(nrm, *leaves_p, "tanh", True).backward(gy)
        xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
        spmm(xk, st, st_rev).backward(gy)
        K.block_rhs_plain(st, xp, None, None, None, False).backward(gy)
        torch.cuda.synchronize()
        dx_rel = max(rel_err(leaves_k[0].grad, leaves_p[0].grad)[0],
                     rel_err(xk.grad, xp.grad)[0])
        par_rel = max(rel_err(k.grad, p.grad)[0]
                      for k, p in zip(leaves_k[1:], leaves_p[1:]))
        check(dx_rel <= F32_BOUND, f"{shape} backward dx: rel {dx_rel:.3e}")
        check(par_rel <= BAND_PARAM_BOUND, f"{shape} backward dW/db: rel "
                                           f"{par_rel:.3e}")
        del leaves_k, leaves_p, xk, xp

        def pair(fn, *inputs):
            def run():
                leaves = [t.detach().requires_grad_() for t in inputs]
                return torch.autograd.grad(fn(*leaves), leaves, gy)
            return run

        pairs = {
            "spmm": (pair(lambda xx: spmm(xx, st, st_rev), x),
                     pair(lambda xx: K.block_rhs_plain(
                         st, xx, None, None, None, False), x)),
            "gcn_rhs": (pair(lambda xx, ww, bb: rhs("tanh", xx, ww, bb, nrm,
                                                    nrm_rev), x, w, b),
                        pair(lambda xx, ww, bb: K.block_rhs_plain(
                            nrm, xx, ww, bb, "tanh", True), x, w, b))}
        for what, (kern, plain) in pairs.items():
            rec[what]["training_pair"] = dict(
                ms=cuda_ms(kern, reps=5, warmup=1),
                plain_ms=cuda_ms(plain, reps=5, warmup=1),
                max_rel_err_dx=dx_rel, max_rel_err_dw_db=par_rel)
        for what in ("spmm", "gcn_rhs"):
            r = rec[what]
            sub = subtiles[what]
            print(f"  {shape} {what}: rel {r['max_rel_err']:.3e} (bound "
                  f"{F32_BOUND:g}; bf16 {rel16:.3e}, bound {BF16_BOUND:g})  "
                  f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  "
                  f"plain {r['plain_ms']:.4f} ms  "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, on the "
                  f"nonzeros)\n    occupied {sub['rows']}x{sub['cols']} "
                  f"sub-tiles {sub['occupied']} of {sub['of']}: the kernel "
                  f"reads {sub['kernel_bytes'] / 1e6:.1f} MB by its design's "
                  f"count, not measured (the storage "
                  f"holds {sub['stored_bytes'] / 1e6:.1f} MB)"
                  + (f"  library {r['library_ms']:.4f} ms (rel "
                     f"{lib_rel:.1e})" if r["library_ms"] is not None else "")
                  + f"  K1 on the same CSR {k1_ms:.4f} ms\n"
                  f"    fwd+bwd (training pair) kernels "
                  f"{r['training_pair']['ms']:.4f} ms, plain under autograd "
                  f"{r['training_pair']['plain_ms']:.4f} ms; backward dx rel "
                  f"{dx_rel:.3e} (bound {F32_BOUND:g}), dW/db rel "
                  f"{par_rel:.3e} (bound {BAND_PARAM_BOUND:g})")
        if main_path:
            records[f"{kind}_spmm"] = rec["spmm"]
            records[f"{kind}_gcn_rhs"] = rec["gcn_rhs"]
        del a, x, w, b, gy
    return records


def grand_grad(P, K, model, g, x, labels, mask, label, xla=None):
    """The masked cross-entropy and its parameter gradients on the kernel
    path (``auto``) against the ``xla`` path, at the model's tolerances
    (the kernel run's launches are counted: the main path) and at solver
    tolerance ``GRAND_PARITY_TOL``; each gated: loss rel ≤ 1e-4, every
    gradient within 1e-3 of its own largest entry, the same accepted steps.
    The encoder's ReLU has a kink: a pre-activation within rounding of 0
    (among N × hidden of them) can be positive in one path and not in the
    other, which moves one node's term of the encoder's gradients. So each
    run keeps the encoder's output, the entries that are zero in one run
    and positive in the other are counted, and where there are any the
    encoder's gradients are held to ``GRAND_FLIP_BOUND`` instead, and each
    such entry's output must be within ``GRAND_FLIP_LEVEL`` of the largest
    output (rounding, not a wrong kernel). The ``xla`` reference runs with
    ``torch.use_deterministic_algorithms``, so it is the same every run;
    one run with its scatter-add's atomics is printed against it. ``xla``:
    the references of an earlier call on the same model and inputs.
    Returns (launch counts, the references)."""
    params = list(model.parameters())
    encoder = model.layer_1
    enc_ids = {id(p) for p in encoder.parameters()}
    enc_idx = [k for k, p in enumerate(params) if id(p) in enc_ids]
    P.update_graph(model, g)
    node = model.layer_2
    tols = node.rtol, node.atol
    kept = {}
    hook = encoder.register_forward_hook(
        lambda mod, inputs, out: kept.__setitem__("y", out.detach()))

    def run(mode, tol=None, deterministic=False):
        P.set_spmm_mode(mode)
        torch.use_deterministic_algorithms(deterministic)
        if tol is not None:
            node.rtol = node.atol = tol
        try:
            model.zero_grad(set_to_none=True)
            loss = P.masked_cross_entropy(model(x), labels, mask)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            P.set_spmm_mode("auto")
            torch.use_deterministic_algorithms(False)
            node.rtol, node.atol = tols
        return (float(loss.detach()), [p.grad.clone() for p in params],
                node.last_stats["accepted"], kept.pop("y"))

    def dist(a, b):
        """(loss rel, worst gradient error over its own largest entry
        outside the encoder, the same in the encoder, the encoder outputs
        zero in one run and positive in the other, the largest output at
        such an entry over the largest output)"""
        own = [rel_err(p, q)[0] for p, q in zip(a[1], b[1])]
        flipped = (a[3] > 0) != (b[3] > 0)
        flips = int(flipped.sum())
        level = (float(torch.maximum(a[3], b[3])[flipped].max())
                 / float(b[3].max()) if flips else 0.0)
        return (abs(a[0] - b[0]) / abs(b[0]),
                max(r for k, r in enumerate(own) if k not in enc_idx),
                max(own[k] for k in enc_idx), flips, level)

    def describe(d):
        return (f"gradient error {d[1]:.3e} of its own largest entry "
                f"outside the encoder, {d[2]:.3e} in the encoder; "
                f"{d[3]} encoder outputs zero in one run only (largest "
                f"{d[4]:.3e} of the largest output)")

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    loose = run("auto")
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {fn.__name__: fn.launches for fn in K.KERNELS if fn.launches}
    backward = {fn.__name__: fn.backward_launches for fn in K.KERNELS
                if getattr(fn, "backward_launches", 0)}
    spread = ""
    if xla is None:
        t0 = time.perf_counter()
        xla = dict(loose=run("xla", deterministic=True))
        xla_s = time.perf_counter() - t0
        xla["tight"] = run("xla", GRAND_PARITY_TOL, deterministic=True)
        atomics = dist(run("xla"), xla["loose"])
        spread = (f"\n    xla path with atomics vs deterministic: loss rel "
                  f"{atomics[0]:.3e}, {describe(atomics)} (not gated); xla "
                  f"path {xla_s:.3f} s")
    tight = run("auto", GRAND_PARITY_TOL)
    hook.remove()
    lines = []
    for tol, got, ref in ((tols[0], loose, xla["loose"]),
                          (GRAND_PARITY_TOL, tight, xla["tight"])):
        d = dist(got, ref)
        enc_bound = GRAND_FLIP_BOUND if d[3] else GRAND_GRAD_BOUND
        lines.append(f"    at rtol=atol={tol:g}: loss {got[0]:.7f} vs xla "
                     f"{ref[0]:.7f}, rel {d[0]:.3e} (bound "
                     f"{GRAND_LOSS_BOUND:g}), {describe(d)}; bounds "
                     f"{GRAND_GRAD_BOUND:g} and {enc_bound:g} in the "
                     f"encoder; accepted steps {got[2]} (xla {ref[2]})")
        check(d[0] <= GRAND_LOSS_BOUND, f"{label} at {tol:g}: loss rel "
                                        f"{d[0]:.3e}")
        check(d[1] <= GRAND_GRAD_BOUND, f"{label} at {tol:g}: gradient rel "
                                        f"{d[1]:.3e}")
        check(d[2] <= enc_bound, f"{label} at {tol:g}: encoder gradient rel "
                                 f"{d[2]:.3e} ({d[3]} flipped outputs)")
        check(d[4] <= GRAND_FLIP_LEVEL, f"{label} at {tol:g}: an encoder "
                                        f"output {d[4]:.3e} of the largest "
                                        f"is zero in one run only")
        check(got[2] == ref[2], f"{label} at {tol:g}: accepted steps differ")
    print(f"  {label}: {seconds:.3f} s at rtol=atol={tols[0]:g}, peak "
          f"{peak / 1e9:.3f} GB ({(peak - resident) / 1e9:.3f} GB above the "
          f"resident tensors); launches {launches}, of them in the backward "
          f"{backward}\n" + "\n".join(lines) + spread)
    check(all(bool(torch.isfinite(t).all()) for t in loose[1] + tight[1]),
          f"{label}: non-finite gradient")
    return dict(launches=launches, backward=backward), xla


def grand_adam(P, K, model, x, labels, mask, label, rhs, spmm, steps=3):
    """``steps`` Adam steps (lr 1e-2) on the masked cross-entropy, each
    launching the fused ``rhs`` forward and ``spmm`` in its backward.
    Returns the launch counts over the steps."""
    step = P.make_train_step(
        lambda: P.masked_cross_entropy(model(x), labels, mask),
        P.adam(model.parameters(), 1e-2))
    K.reset_launch_counts()
    for i in range(1, steps + 1):
        before = (rhs.launches, spmm.backward_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = step()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        fwd = rhs.launches - before[0]
        bwd = spmm.backward_launches - before[1]
        print(f"  {label} Adam step {i}: loss {float(loss):.7f}, "
              f"{seconds:.3f} s, {rhs.__name__} launches {fwd} forward, "
              f"{spmm.__name__} {bwd} in its backward")
        check(bool(torch.isfinite(loss)), f"{label} step {i}: non-finite loss")
        check(fwd > 0 and bwd > 0, f"{label} step {i}: {rhs.__name__} not "
                                   f"launched forward and backward")
    return dict(launches={fn.__name__: fn.launches for fn in K.KERNELS},
                backward={fn.__name__: fn.backward_launches for fn in K.KERNELS
                          if getattr(fn, "backward_launches", 0)})


def mesh_path(P, K, g, kind, label, seed):
    """GRAND (128 → 128 → 7) on a relabeled mesh: the forward parity at
    solver tolerance 1e-5, the gradient on the fused right-hand side and on
    the plain SpMM (the graph without ``*_norm``) against ``xla``, then 3
    Adam steps on the fused path. Features, labels and the 10% train mask
    are seeded numpy draws in the original numbering, permuted with
    ``permute_nodes``. Returns the launch counts of each run."""
    n, dev = g.num_nodes, g.device
    order = g.cache["node_order"].cpu().numpy()
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, 128)).astype(np.float32)
    labels = rng.integers(0, 7, n)
    mask = rng.random(n) < 0.1
    x, y, m = (torch.from_numpy(P.permute_nodes(a, order)).to(dev)
               for a in (feats, labels, mask))
    model = P.grand_model(128, 128, 7, precomputed_self_loops=True,
                          generator=torch.Generator().manual_seed(seed),
                          device=dev)
    rhs = K.pbanded_gcn_rhs if kind == "pbanded" else K.banded_gcn_rhs
    spmm = (K.pbanded_spmm_pallas if kind == "pbanded"
            else K.banded_spmm_pallas)
    with torch.no_grad():
        fwd, _, _ = grand_forward(P, model, g, x, f"{label} forward")
    check(fwd[rhs.__name__] > 0, f"{label}: {rhs.__name__} not launched")
    check(fwd["segment_spmm"] == 0, f"{label}: K1 launched on a mesh")
    fused, xla = grand_grad(P, K, model, g, x, y, m, f"{label} gradient, "
                            f"fused {rhs.__name__}")
    check(fused["launches"].get(rhs.__name__, 0) > 0
          and fused["backward"].get(spmm.__name__, 0) > 0,
          f"{label}: no {rhs.__name__} launch, or no {spmm.__name__} launch "
          f"in its backward")
    plain_g = g.copy(cache={k: v for k, v in g.cache.items()
                            if not k.startswith(kind + "_norm")})
    unfused, _ = grand_grad(P, K, model, plain_g, x, y, m,
                            f"{label} gradient, plain {spmm.__name__}",
                            xla=xla)
    check(unfused["backward"].get(spmm.__name__, 0) > 0,
          f"{label}: no {spmm.__name__} launch in the backward")
    P.update_graph(model, g)
    adam = grand_adam(P, K, model, x, y, m, label, rhs, spmm)
    return dict(forward=fwd, fused=fused, unfused=unfused, adam=adam)


def k3_work(csr, dims, backward: bool, fb: int = 4, wb: int = 4) -> tuple:
    """(bytes, operations, rate) K3 needs on ``csr`` for an MLP of widths
    ``dims``, with ``fb``-byte feats (output, cotangent, dfeats) and
    ``wb``-byte weights: the layout, feats, weights and biases (backward:
    and the output cotangent, the slots' rows) read once, the output
    (backward: dfeats, dW, db) written once; 2 operations per multiply-add
    of the per-edge MLP, three products backward (recompute, dW, dh), at the
    bf16 rate where feats and weights are both bf16."""
    e, n = csr.num_cols, csr.num_rows
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    macs = e * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    rate = BF16_FLOP_PER_S if fb == wb == 2 else F32_FLOP_PER_S
    read = csr_bytes(csr) + fb * e * dims[0] + wb * params
    if backward:
        return (read + fb * n * dims[-1] + 8 * e + fb * e * dims[0]
                + wb * params, 6.0 * macs, rate)
    return read + fb * n * dims[-1], 2.0 * macs, rate


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def bf16_forms(kernel, plain, inputs, outputs_like, work, label,
               library=None, exact=False):
    """One bf16 form of a kernel pair against its plain versions fed the
    same operands: ``kernel()`` and ``plain()`` return tuples of results
    (forward, or the backward's gradients), each within 1e-2 of its own
    largest entry (``exact``: equal bits) and in the dtype of the matching
    ``outputs_like`` tensor. Times of kernel, plain and ``library``, and
    the bound from these operands' bytes. Returns the JSON record."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for a, b, like in zip(got, want, outputs_like):
        check(a.dtype == b.dtype == like.dtype,
              f"{label}: dtype {a.dtype}, plain {b.dtype}, want {like.dtype}")
        if exact:  # infinities (empty rows) and NaN included
            check(torch.equal(a.isnan(), b.isnan()) and torch.equal(
                torch.nan_to_num(a), torch.nan_to_num(b)),
                f"{label}: kernel != plain (bits)")
        else:
            check(bool(torch.isfinite(a.float()).all()),
                  f"{label}: non-finite")
    errs = ([(0.0, 0.0)] if exact
            else [rel_err(a, b) for a, b in zip(got, want)])
    rel = max(r for r, _ in errs)
    check(rel <= BF16_BOUND, f"{label}: rel {rel:.3e} > {BF16_BOUND:g}")
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    lib_ms = None if library is None else cuda_ms(library)
    b_ms, b_by = bound(*work)
    print(f"  {label:<60} rel {rel:.3e} (bound "
          f"{'bits' if exact else BF16_BOUND})  kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms" + (f"  library {lib_ms:.4f} ms"
                                  if library is not None else "")
          + f"  bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=max(a for _, a in errs), max_rel_err=rel, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, shape=label,
                dtypes={k: dtype_name(t.dtype) for k, t in inputs.items()})


def k3_bf16(K, csr, acts, dims, feats, ws, bs, g, shape, variants):
    """K3's two bf16 forms (bf16 weights; bf16 features, or f32 features
    as the precision policy gives where the edge features concatenate f32
    graph data), forward and backward. Returns ``{form: {fused_mlp_fwd:
    record, fused_mlp_bwd: record}}``."""
    out = {}
    ws16 = [w.to(BF16) for w in ws]
    bs16 = [b.to(BF16) for b in bs]
    for form, fdt in (("bf16", BF16), ("f32 feats, bf16 weights",
                                       torch.float32)):
        x, gy = feats.to(fdt), g.to(fdt)
        fb = x.element_size()
        label = f"{shape} {form}"
        fwd = bf16_forms(
            lambda: (K.fused_mlp_fwd(acts, csr, x, ws16, bs16),),
            lambda: (K.fused_mlp_plain(acts, csr, x, ws16, bs16).detach(),),
            dict(feats=x, weights=ws16[0]), (x,),
            k3_work(csr, dims, False, fb, 2), f"{label} fwd")
        bwd = bf16_forms(
            lambda: (lambda d: (d[0],) + d[1] + d[2])(
                K.fused_mlp_bwd(acts, csr, x, ws16, bs16, gy)),
            lambda: (lambda d: (d[0],) + d[1] + d[2])(
                K.fused_mlp_bwd_plain(acts, csr, x, ws16, bs16, gy)),
            dict(feats=x, weights=ws16[0], g_out=gy),
            (x,) + tuple(ws16) + tuple(bs16),
            k3_work(csr, dims, True, fb, 2), f"{label} bwd")
        fwd["variant"], bwd["variant"] = variants
        out[form] = dict(fused_mlp_fwd=fwd, fused_mlp_bwd=bwd)
    return out


def k3_checks(K, dev, cases):
    """Phase 3, K3: forward and backward against their plain versions on
    each ``(label, csr, acts, dims, record)`` case, in f32 and in the two
    bf16 forms; the f32 forward and backward also by device time
    (``torch.profiler``). Returns the JSON records of the cases with a
    ``record`` key."""
    from neuralgraphpde_torch.tools.profile_paths import device_per_call

    rng = np.random.default_rng(3)
    records = {}
    for label, csr, acts, dims, record in cases:
        ws = [torch.from_numpy((rng.normal(size=(a, b)) / np.sqrt(a)).astype(
            np.float32)).to(dev) for a, b in zip(dims[:-1], dims[1:])]
        bs = [torch.from_numpy((rng.normal(size=(1, b)) / 3).astype(
            np.float32)).to(dev) for b in dims[1:]]
        n_layers = len(ws)
        e, n = csr.num_cols, csr.num_rows
        feats = torch.from_numpy(rng.normal(size=(e, dims[0])).astype(
            np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(size=(n, dims[-1])).astype(
            np.float32)).to(dev)
        variants = (K.fused_mlp_variant(dims),
                    K.fused_mlp_variant(dims, backward=True))
        shape = (f"K3 {label} N={n} E={e} {'-'.join(map(str, dims))} "
                 f"{'/'.join(a or 'linear' for a in acts)} f32")
        got = K.fused_mlp_fwd(acts, csr, feats, ws, bs)
        kdf, kdw, kdb = K.fused_mlp_bwd(acts, csr, feats, ws, bs, g)
        with torch.no_grad():
            want = K.fused_mlp_plain(acts, csr, feats, ws, bs)
        pdf, pdw, pdb = K.fused_mlp_bwd_plain(acts, csr, feats, ws, bs, g)
        torch.cuda.synchronize()
        fwd_rel, fwd_abs = rel_err(got, want)
        df_rel, df_abs = rel_err(kdf, pdf)
        par = [rel_err(k, p) for k, p in zip(kdw + kdb, pdw + pdb)]
        par_rel, par_abs = max(r for r, _ in par), max(a for _, a in par)
        for out in (got, kdf) + kdw + kdb:
            check(bool(torch.isfinite(out).all()), f"{shape}: non-finite")
        check(fwd_rel <= F32_BOUND, f"{shape} fwd: rel {fwd_rel:.3e}")
        check(df_rel <= F32_BOUND, f"{shape} dfeats: rel {df_rel:.3e}")
        check(par_rel <= K3_PARAM_BOUND, f"{shape} dW/db: rel {par_rel:.3e}")
        bf16 = k3_bf16(K, csr, acts, dims, feats, ws, bs, g, shape[:-4],
                       variants)

        def plain_train():
            leaves = [t.detach().requires_grad_() for t in (feats, *ws, *bs)]
            out = K.fused_mlp_plain(acts, csr, leaves[0],
                                    leaves[1:n_layers + 1],
                                    leaves[n_layers + 1:])
            return torch.autograd.grad(out, leaves, g)

        def kernel_train():
            K.fused_mlp_fwd(acts, csr, feats, ws, bs)
            return K.fused_mlp_bwd(acts, csr, feats, ws, bs, g)

        ms_f = cuda_ms(lambda: K.fused_mlp_fwd(acts, csr, feats, ws, bs))
        dev_f = device_per_call(
            lambda: K.fused_mlp_fwd(acts, csr, feats, ws, bs))[0]
        plain_f = cuda_ms(lambda: K.fused_mlp_plain(acts, csr, feats, ws, bs))
        ms_b = cuda_ms(lambda: K.fused_mlp_bwd(acts, csr, feats, ws, bs, g))
        dev_b = device_per_call(
            lambda: K.fused_mlp_bwd(acts, csr, feats, ws, bs, g))[0]
        plain_b = cuda_ms(lambda: K.fused_mlp_bwd_plain(acts, csr, feats, ws,
                                                         bs, g))
        ms_t, plain_t = cuda_ms(kernel_train), cuda_ms(plain_train)
        bound_f, by_f = bound(*k3_work(csr, dims, False))
        bound_b, by_b = bound(*k3_work(csr, dims, True))
        print(f"  {shape} ({variants[0]} forward, {variants[1]} backward)\n"
              f"    fwd    rel {fwd_rel:.3e} (bound {F32_BOUND:g})  kernel "
              f"{ms_f:.4f} ms (device {dev_f:.4f} ms)  plain {plain_f:.4f} "
              f"ms  bound {bound_f:.4f} ms ({by_f})\n"
              f"    bwd    dfeats rel {df_rel:.3e} (bound {F32_BOUND:g}), "
              f"dW/db rel {par_rel:.3e} (bound {K3_PARAM_BOUND:g})  kernel "
              f"{ms_b:.4f} ms (device {dev_b:.4f} ms)  autograd through "
              f"plain {plain_b:.4f} ms  "
              f"bound {bound_b:.4f} ms ({by_b})\n"
              f"    fwd+bwd (training pair)  kernels {ms_t:.4f} ms  plain "
              f"fwd under autograd + backward {plain_t:.4f} ms")
        if record is not None:
            records[record] = dict(
                fused_mlp_fwd=dict(
                    variant=variants[0], max_abs_err=fwd_abs,
                    max_rel_err=fwd_rel, ms=ms_f, device_ms=dev_f,
                    plain_ms=plain_f, library_ms=None, bound_ms=bound_f,
                    bound_by=by_f, shape=shape),
                fused_mlp_bwd=dict(
                    variant=variants[1], max_abs_err=max(df_abs, par_abs),
                    max_rel_err=max(df_rel, par_rel), ms=ms_b,
                    device_ms=dev_b, plain_ms=plain_b, library_ms=None,
                    bound_ms=bound_b, bound_by=by_b, shape=shape),
                bf16=bf16)
    return records


def k5_bf16(K, csr, senders, ph, h, wl, bl, g, shape):
    """K5's bf16 forms (bf16 ``Wl``/``bl``; ``ph`` and ``h`` in bf16, or f32
    ``ph`` as ``bf16(GNOConv)`` gives where the edge features come from f32
    graph data, or f32 ``ph`` and ``h`` as ``bf16(GNOModel)`` gives after
    its f32 lift), forward and backward. Returns ``{form: {fused_gno_fwd:
    record, fused_gno_bwd: record}}``."""
    e, n = csr.num_cols, csr.num_rows
    k, width = wl.shape[1], wl.shape[0]
    reduce_macs = e * width * (k + 1)
    product_macs = n * width * (k + 1) * width
    wl16, bl16 = wl.to(BF16), bl.to(BF16)
    out = {}
    for form, pdt, hdt in (("bf16", BF16, BF16),
                           ("f32 ph, bf16 h and weights", torch.float32,
                            BF16),
                           ("f32 ph and h, bf16 weights", torch.float32,
                            torch.float32)):
        x, hh, gy = ph.to(pdt), h.to(hdt), g.to(pdt)
        args = (x, hh, wl16, bl16)
        rate = BF16_FLOP_PER_S if pdt == hdt == BF16 else F32_FLOP_PER_S
        inputs = csr_bytes(csr) + nbytes(senders, *args)
        out_bytes = n * width * x.element_size()
        grads_bytes = nbytes(x, hh, wl16, bl16)
        label = f"{shape} {form}"
        dtypes = dict(ph=x, h=hh, weights=wl16)
        fwd = bf16_forms(
            lambda: (K.fused_gno_fwd(csr, senders, *args),),
            lambda: (K.fused_gno_plain(csr, senders, *args).detach(),),
            dtypes, (x,),
            (inputs + out_bytes, 2.0 * (reduce_macs + product_macs), rate),
            f"{label} fwd")
        bwd = bf16_forms(
            lambda: K.fused_gno_bwd(csr, senders, *args, gy),
            lambda: K.fused_gno_bwd_plain(csr, senders, *args, gy),
            dict(dtypes, g_out=gy), args,
            (inputs + out_bytes + grads_bytes,
             2.0 * (3 * reduce_macs + 2 * product_macs), rate),
            f"{label} bwd")
        out[form] = dict(fused_gno_fwd=fwd, fused_gno_bwd=bwd)
    return out


def k5_checks(K, dev, cases):
    """Phase 3, K5: forward and backward against their plain versions on
    each ``(label, csr, senders, main_path)`` graph; on the main-path graph
    also their device time split by launch (``torch.profiler``). Returns
    the JSON records of the main-path graph."""
    from neuralgraphpde_torch.tools.profile_paths import device_split

    rng = np.random.default_rng(5)
    k, width = 128, 64

    def put(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(dev)

    w = put(k, width * width, scale=1 / np.sqrt(k))
    b = put(1, width * width, scale=0.1)
    wl, bl = K.pack_last_layer(w, b, width, width)
    records = {}
    for label, csr, senders, main_path in cases:
        e, n = csr.num_cols, csr.num_rows
        ph, h, g = put(e, k), put(n, width), put(n, width)
        shape = f"K5 {label} N={n} E={e} K={k} IN=OUT={width} bias f32"
        got = K.fused_gno_fwd(csr, senders, ph, h, wl, bl)
        kern = K.fused_gno_bwd(csr, senders, ph, h, wl, bl, g)
        with torch.no_grad():
            want = K.fused_gno_plain(csr, senders, ph, h, wl, bl)
        plain = K.fused_gno_bwd_plain(csr, senders, ph, h, wl, bl, g)
        torch.cuda.synchronize()
        fwd_rel, fwd_abs = rel_err(got, want)
        edge = [rel_err(a, p) for a, p in zip(kern[:2], plain[:2])]
        par = [rel_err(a, p) for a, p in zip(kern[2:], plain[2:])]
        edge_rel, edge_abs = max(r for r, _ in edge), max(a for _, a in edge)
        par_rel, par_abs = max(r for r, _ in par), max(a for _, a in par)
        for out in (got,) + kern:
            check(bool(torch.isfinite(out).all()), f"{shape}: non-finite")
        check(fwd_rel <= F32_BOUND, f"{shape} fwd: rel {fwd_rel:.3e}")
        check(edge_rel <= F32_BOUND, f"{shape} dph/dh: rel {edge_rel:.3e}")
        check(par_rel <= K5_PARAM_BOUND, f"{shape} dWl/dbl: rel "
                                         f"{par_rel:.3e}")

        def plain_train():
            leaves = [t.detach().requires_grad_() for t in (ph, h, wl, bl)]
            out = K.fused_gno_plain(csr, senders, *leaves)
            return torch.autograd.grad(out, leaves, g)

        def kernel_train():
            K.fused_gno_fwd(csr, senders, ph, h, wl, bl)
            return K.fused_gno_bwd(csr, senders, ph, h, wl, bl, g)

        ms_f = cuda_ms(lambda: K.fused_gno_fwd(csr, senders, ph, h, wl, bl))
        plain_f = cuda_ms(lambda: K.fused_gno_plain(csr, senders, ph, h, wl,
                                                    bl))
        ms_b = cuda_ms(lambda: K.fused_gno_bwd(csr, senders, ph, h, wl, bl,
                                               g))
        plain_b = cuda_ms(lambda: K.fused_gno_bwd_plain(csr, senders, ph, h,
                                                        wl, bl, g))
        ms_t, plain_t = cuda_ms(kernel_train), cuda_ms(plain_train)
        # reduce-then-contract: the reduce E·IN·KB and the product
        # N·IN·KB·OUT multiply-adds forward; backward the reduce again, two
        # products (dS, dWl') and the per-edge dph' and dh rows
        reduce_macs = e * width * (k + 1)
        product_macs = n * width * (k + 1) * width
        inputs = csr_bytes(csr) + nbytes(senders, ph, h, wl, bl)
        bound_f, by_f = bound(inputs + nbytes(got),
                              2.0 * (reduce_macs + product_macs))
        bound_b, by_b = bound(inputs + nbytes(g, *kern),
                              2.0 * (3 * reduce_macs + 2 * product_macs))
        print(f"  {shape}\n"
              f"    fwd    rel {fwd_rel:.3e} (bound {F32_BOUND:g})  kernel "
              f"{ms_f:.4f} ms  plain {plain_f:.4f} ms  bound {bound_f:.4f} "
              f"ms ({by_f})\n"
              f"    bwd    dph/dh rel {edge_rel:.3e} (bound {F32_BOUND:g}), "
              f"dWl/dbl rel {par_rel:.3e} (bound {K5_PARAM_BOUND:g})  kernel "
              f"{ms_b:.4f} ms  autograd through plain {plain_b:.4f} ms  "
              f"bound {bound_b:.4f} ms ({by_b})\n"
              f"    fwd+bwd (training pair)  kernels {ms_t:.4f} ms  plain "
              f"fwd under autograd + backward {plain_t:.4f} ms")
        if main_path:
            split_f = device_split(
                lambda: K.fused_gno_fwd(csr, senders, ph, h, wl, bl))
            split_b = device_split(
                lambda: K.fused_gno_bwd(csr, senders, ph, h, wl, bl, g))
            for what, split in (("fwd", split_f), ("bwd", split_b)):
                print(f"    {what} on the device, "
                      f"{sum(split.values()):.4f} ms by launch:")
                for name, ms in split.items():
                    print(f"      {ms:.4f} ms  {name}")
            # the reduce alone: ph, h, the CSR and senders read once, S
            # (N, IN, KP) written once; E·IN·KB multiply-adds
            kp = (k + 4) // 4 * 4
            reduce_bound, reduce_by = bound(
                csr_bytes(csr) + nbytes(senders, ph, h) + 4 * n * width * kp,
                2.0 * reduce_macs)
            reduce_ms = [sum(ms for name, ms in split.items()
                             if "gno_reduce_kernel" in name)
                         for split in (split_f, split_b)]
            check(min(reduce_ms) > 0, f"{shape}: no reduce in the split")
            print(f"    reduce on the device: fwd {reduce_ms[0]:.4f} ms, "
                  f"bwd {reduce_ms[1]:.4f} ms; its bound {reduce_bound:.4f} "
                  f"ms ({reduce_by}; not gated: S may stay in L2)")
            # the bits, to compare with another checkout's (dh is left out:
            # its index_add_ sums in another order from call to call)
            print("    digests: " + ", ".join(
                f"{what} {digest(t)}" for what, t in
                zip(("out", "dph", "dWl", "dbl"), (got,) + kern[:1]
                    + kern[2:])))
            records["gno_bf16"] = k5_bf16(K, csr, senders, ph, h, wl, bl,
                                          g, shape[:-4])
            records["fused_gno_fwd"] = dict(
                max_abs_err=fwd_abs, max_rel_err=fwd_rel, ms=ms_f,
                device_ms=sum(split_f.values()), device_split=split_f,
                reduce_device_ms=reduce_ms[0], reduce_bound_ms=reduce_bound,
                plain_ms=plain_f, library_ms=None, bound_ms=bound_f,
                bound_by=by_f, shape=shape)
            records["fused_gno_bwd"] = dict(
                max_abs_err=max(edge_abs, par_abs),
                max_rel_err=max(edge_rel, par_rel), ms=ms_b,
                device_ms=sum(split_b.values()), device_split=split_b,
                reduce_device_ms=reduce_ms[1], reduce_bound_ms=reduce_bound,
                plain_ms=plain_b, library_ms=None, bound_ms=bound_b,
                bound_by=by_b, shape=shape)
    return records


def k5_gkn_checks(K, dev):
    """Phase 3, K5 at the graph kernel network's widths on the
    ``gno-darcy`` cell's graph: forward and backward against the plain
    versions, timed by events beside their bounds, device ms by launch.
    Returns ``{fused_gno_fwd: record, fused_gno_bwd: record}``."""
    from neuralgraphpde_torch.tools.profile_paths import device_split

    from bench_torch.traffic.darcy import ball_edges

    s, r = ball_edges(61, 0.1)
    n, e, k, width = 61 * 61, len(r), 1024, 64
    check(e == 383_293, f"GKN graph: {e} edges, expected 383,293")
    csr = K.build_segment_csr(np.arange(e), r, n, num_cols=e).to(dev)
    senders = torch.from_numpy(s).to(dev)
    rng = np.random.default_rng(18)

    def put(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(dev)

    wl, bl = K.pack_last_layer(put(k, width * width, scale=k ** -0.5),
                               put(1, width * width, scale=0.1), width, width)
    ph, h, g = put(e, k), put(n, width), put(n, width)
    plan = K.gno_plan(k, width, width, True)
    shape = f"K5 GKN 61² N={n} E={e} K={k} IN=OUT={width} bias f32"
    got = K.fused_gno_fwd(csr, senders, ph, h, wl, bl)
    kern = K.fused_gno_bwd(csr, senders, ph, h, wl, bl, g)
    with torch.no_grad():
        want = K.fused_gno_plain(csr, senders, ph, h, wl, bl)
    fwd_rel, fwd_abs = rel_err(got, want)
    del want
    plain = K.fused_gno_bwd_plain(csr, senders, ph, h, wl, bl, g)
    torch.cuda.synchronize()
    edge = [rel_err(a, b) for a, b in zip(kern[:2], plain[:2])]
    par = [rel_err(a, b) for a, b in zip(kern[2:], plain[2:])]
    del plain
    edge_rel, par_rel = max(v for v, _ in edge), max(v for v, _ in par)
    for out in (got,) + kern:
        check(bool(torch.isfinite(out).all()), f"{shape}: non-finite")
    check(fwd_rel <= F32_BOUND, f"{shape} fwd: rel {fwd_rel:.3e}")
    check(edge_rel <= F32_BOUND, f"{shape} dph/dh: rel {edge_rel:.3e}")
    check(par_rel <= K5_PARAM_BOUND, f"{shape} dWl/dbl: rel {par_rel:.3e}")
    del got, kern
    ms_f = cuda_ms(lambda: K.fused_gno_fwd(csr, senders, ph, h, wl, bl))
    ms_b = cuda_ms(lambda: K.fused_gno_bwd(csr, senders, ph, h, wl, bl, g))
    plain_f = cuda_ms(lambda: K.fused_gno_plain(csr, senders, ph, h, wl, bl),
                      reps=3, warmup=1)
    plain_b = cuda_ms(lambda: K.fused_gno_bwd_plain(csr, senders, ph, h, wl,
                                                    bl, g), reps=3, warmup=1)
    reduce_macs = e * width * (k + 1)
    product_macs = n * width * (k + 1) * width
    inputs = csr_bytes(csr) + nbytes(senders, ph, h, wl, bl)
    bound_f, by_f = bound(inputs + 4 * n * width, 2.0 * (reduce_macs
                                                         + product_macs))
    bound_b, by_b = bound(inputs + nbytes(g, ph, h, wl) + 4 * width,
                          2.0 * (3 * reduce_macs + 2 * product_macs))
    split_f = device_split(lambda: K.fused_gno_fwd(csr, senders, ph, h, wl,
                                                   bl), reps=5)
    split_b = device_split(lambda: K.fused_gno_bwd(csr, senders, ph, h, wl,
                                                   bl, g), reps=5)
    print(f"  {shape}\n"
          f"    plan: reduce {plan['reduce_passes']} passes of "
          f"{plan['reduce_threads']} threads, {plan['reduce_buffers']} "
          f"buffers; per-edge backward {plan['edge_slices']} slices of "
          f"{plan['edge_slice']} columns k, {plan['edge_smem']} B a block\n"
          f"    fwd    rel {fwd_rel:.3e} (bound {F32_BOUND:g})  kernel "
          f"{ms_f:.4f} ms  plain {plain_f:.4f} ms  bound {bound_f:.4f} ms "
          f"({by_f})\n"
          f"    bwd    dph/dh rel {edge_rel:.3e} (bound {F32_BOUND:g}), "
          f"dWl/dbl rel {par_rel:.3e} (bound {K5_PARAM_BOUND:g})  kernel "
          f"{ms_b:.4f} ms  autograd through plain {plain_b:.4f} ms  bound "
          f"{bound_b:.4f} ms ({by_b})")
    for what, split in (("fwd", split_f), ("bwd", split_b)):
        print(f"    {what} on the device, {sum(split.values()):.4f} ms by "
              "launch:")
        for name, ms in split.items():
            print(f"      {ms:.4f} ms  {name}")
    common = dict(plan=plan, shape=shape, plain_ms=None, library_ms=None)
    return {"fused_gno_fwd": dict(
                common, max_abs_err=fwd_abs, max_rel_err=fwd_rel, ms=ms_f,
                plain_ms=plain_f, device_ms=sum(split_f.values()),
                device_split=split_f, bound_ms=bound_f, bound_by=by_f),
            "fused_gno_bwd": dict(
                common, max_abs_err=max(a for _, a in edge + par),
                max_rel_err=max(edge_rel, par_rel), ms=ms_b, plain_ms=plain_b,
                device_ms=sum(split_b.values()), device_split=split_b,
                bound_ms=bound_b, bound_by=by_b)}


def k6_checks(K, dev, cases):
    """Phase 3, K6: the forward (max, and min as −max(−m)) and the backward
    of ``segment_max_aggregate`` against the plain versions on each
    ``(label, csr, receivers, record)`` case, F = 128, messages with ties.
    Bound: equal bits. Returns the JSON records of the cases with a
    ``record`` key."""
    gen = torch.Generator(device=dev).manual_seed(6)
    records = {}
    for label, csr, recv, record in cases:
        e, n, f = csr.num_cols, csr.num_rows, 128
        m = torch.randn(e, f, device=dev, generator=gen)
        m[::3] = (m[::3] * 2).round().clamp_min(0) / 2  # ties, many zeros
        g = torch.randn(n, f, device=dev, generator=gen)
        recv64 = recv.long()
        idx = recv64.reshape(-1, 1).expand(e, f)
        empty = int((csr.row_ptr[1:] == csr.row_ptr[:-1]).sum())
        base = f"K6 {label} N={n} E={e} F={f}"
        shape = f"{base} f32 ({empty} empty rows)"
        for sign in (1.0, -1.0):
            got = sign * K.segment_max(sign * m, csr)
            want = sign * K.segment_max_plain(sign * m, csr)
            leaf = m.clone().requires_grad_()
            (sign * K.segment_max_aggregate(sign * leaf, csr, recv)
             ).backward(g)
            winners = sign * m == K.segment_max_plain(sign * m, csr)[recv64]
            want_g = torch.where(winners, g[recv64], 0.0)
            torch.cuda.synchronize()
            what = "max" if sign > 0 else "min"
            check(torch.equal(got, want), f"{shape} {what}: kernel != plain")
            check(torch.equal(leaf.grad, want_g),
                  f"{shape} {what}: gradient != plain")
            check(bool(torch.isinf(got).any()) == (empty > 0),
                  f"{shape} {what}: empty rows")
            del leaf, winners, want_g
        err = float((got - want).abs().nan_to_num().max())

        def library():
            return torch.full((n, f), float("-inf"), device=dev
                              ).scatter_reduce_(0, idx, m, "amax")

        check(torch.equal(library(), K.segment_max_plain(m, csr)),
              f"{shape}: scatter_reduce_ != plain")
        ms = cuda_ms(lambda: K.segment_max(m, csr))
        plain_ms = cuda_ms(lambda: K.segment_max_plain(m, csr))
        lib_ms = cuda_ms(library)
        # messages and the layout read once, the output written once; one
        # compare per message element
        b_ms, b_by = bound(nbytes(m, csr.row_ptr, csr.col) + 4 * n * f,
                           float(e * f))
        print(f"  {shape}: max and min, forward and backward equal to plain "
              f"(bits)  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"scatter_reduce_ {lib_ms:.4f} ms  bound {b_ms:.4f} ms "
              f"({b_by})")
        # bf16 messages: compared in f32, written back in bf16, the same bits
        # as the plain version; the backward keeps the tie rule in bf16
        m16, g16 = m.to(BF16), g.to(BF16)
        leaf = m16.clone().requires_grad_()
        K.segment_max_aggregate(leaf, csr, recv).backward(g16)
        want16 = K.segment_max_plain(m16, csr)
        want_g = torch.where(m16 == want16[recv64], g16[recv64],
                             torch.zeros((), dtype=BF16, device=dev))
        check(torch.equal(leaf.grad, want_g),
              f"{shape} bf16: gradient != plain")

        def library16():
            return torch.full((n, f), float("-inf"), dtype=BF16, device=dev
                              ).scatter_reduce_(0, idx, m16, "amax")

        check(torch.equal(library16(), want16),
              f"{shape} bf16: scatter_reduce_ != plain")
        check(torch.equal(-K.segment_max(-m16, csr),
                          -K.segment_max_plain(-m16, csr)),
              f"{shape} bf16 min: kernel != plain")
        rec16 = bf16_forms(
            lambda: (K.segment_max(m16, csr),),
            lambda: (K.segment_max_plain(m16, csr),),
            dict(messages=m16), (m16,),
            (nbytes(m16, csr.row_ptr, csr.col) + 2 * n * f, float(e * f)),
            f"{base} bf16 ({empty} empty rows; min and backward bits too)",
            library=library16, exact=True)
        if record is not None:
            records[record] = dict(
                max_abs_err=err, max_rel_err=0.0, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, shape=shape,
                bf16=rec16)
        del m, g, idx, m16, g16, leaf
    return records


def mppde_layer_max(P, K, g, dev):
    """Phase 8: one ``MPPDEConv(aggr="max")`` at the config-3 widths on the
    Burgers chain, on the K6 path and the ``xla`` path. Returns the K6
    launches of the K6-path forward and backward."""
    from neuralgraphpde_torch.examples import train_mppde_burgers as T

    cfg = T.Config()
    H, KB = cfg.hidden, cfg.bundle
    gen = torch.Generator().manual_seed(11)
    kw = dict(activation="swish", generator=gen, device=dev)
    layer = P.MPPDEConv(P.MLP((2 * H + KB + 1, H, H), **kw),
                        P.MLP((2 * H, H, H), **kw), aggr="max")
    rng = np.random.default_rng(11)
    window = torch.from_numpy(rng.normal(size=(g.num_nodes, KB)).astype(
        np.float32)).to(dev)
    P.update_graph(layer, g.copy(ndata={"u": window, "x": g.ndata["x"]}))
    x = torch.from_numpy(rng.normal(size=(g.num_nodes, H)).astype(
        np.float32)).to(dev)
    gy = torch.from_numpy(rng.normal(size=(g.num_nodes, H)).astype(
        np.float32)).to(dev)
    params = list(layer.parameters())

    def run():
        layer.zero_grad(set_to_none=True)
        xl = x.clone().requires_grad_()
        y = layer(xl)
        y.backward(gy)
        torch.cuda.synchronize()
        return y.detach(), [xl.grad] + [p.grad.clone() for p in params]

    P.set_spmm_mode("auto")
    K.reset_launch_counts()
    y_k, grads_k = run()
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    P.set_spmm_mode("xla")
    try:
        y_x, grads_x = run()
    finally:
        P.set_spmm_mode("auto")
    out_rel = rel_err(y_k, y_x)[0]
    grad_rel = max(rel_err(a, b)[0] for a, b in zip(grads_k, grads_x))
    print(f"  N={g.num_nodes} E={g.num_edges}, H {H}, K {KB}: output rel "
          f"{out_rel:.3e} (bound {F32_BOUND:g}), worst gradient rel "
          f"{grad_rel:.3e} (bound {MPPDE_GRAD_BOUND:g}, x and "
          f"{len(params)} parameters); launches {launches}")
    check(out_rel <= F32_BOUND, f"MPPDEConv max: output rel {out_rel:.3e}")
    check(grad_rel <= MPPDE_GRAD_BOUND,
          f"MPPDEConv max: gradient rel {grad_rel:.3e}")
    check(launches["segment_max"] > 0, "MPPDEConv max: K6 not launched")
    check(launches["fused_mlp_fwd"] == 0, "MPPDEConv max: K3 launched")
    return launches


def mppde_training(P, K, model, u):
    """Phase 9: the first step's gradient on the K3 and xla paths, then one
    epoch of Adam steps on the K3 path and the first simulation's rollout
    RMSE. Returns the launch counts of the epoch."""
    from neuralgraphpde_torch.examples import train_mppde_burgers as T

    cfg = T.Config()
    params = list(model.parameters())
    starts = T.window_starts(cfg, u.shape[2])
    first = np.random.default_rng(cfg.seed).choice(starts, size=T.SAMPLES)

    def batch_grad():
        model.zero_grad(set_to_none=True)
        loss = T.batch_loss(model, u[0], first, cfg.pushforward)
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in params]

    P.set_spmm_mode("auto")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_k, grads_k = batch_grad()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    P.set_spmm_mode("xla")
    try:
        t0 = time.perf_counter()
        loss_x, grads_x = batch_grad()
        torch.cuda.synchronize()
        xla_s = time.perf_counter() - t0
    finally:
        P.set_spmm_mode("auto")
    loss_rel = abs(loss_k - loss_x) / abs(loss_x)
    grad_rel = max(rel_err(gk, gx)[0] for gk, gx in zip(grads_k, grads_x))
    print(f"  step-1 gradient (windows at {first.tolist()}), K3 path: loss "
          f"{loss_k:.7f}, {cold:.3f} s (first); xla path: loss "
          f"{loss_x:.7f}, {xla_s:.3f} s; loss rel {loss_rel:.3e} (bound "
          f"{MPPDE_LOSS_BOUND:g}), worst gradient rel {grad_rel:.3e} (bound "
          f"{MPPDE_GRAD_BOUND:g})")
    check(loss_rel <= MPPDE_LOSS_BOUND, f"MP-PDE loss rel {loss_rel:.3e}")
    check(grad_rel <= MPPDE_GRAD_BOUND, f"MP-PDE gradient rel {grad_rel:.3e}")

    step = P.make_train_step(
        lambda u_sim, s0s: T.batch_loss(model, u_sim, s0s, cfg.pushforward),
        P.adam(params, cfg.lr))
    per_step = T.SAMPLES * 2 * model.depth  # 2 calls per window, 1 per conv
    rng = np.random.default_rng(cfg.seed)
    seconds, losses = [], []
    K.reset_launch_counts()
    for i in range(cfg.num_sims):
        before = {fn.__name__: fn.launches for fn in K.KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = step(u[i], rng.choice(starts, size=T.SAMPLES))
        losses.append(float(loss))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches - before[fn.__name__]
                    for fn in K.KERNELS}
        check(np.isfinite(losses[-1]), f"step {i + 1}: non-finite loss")
        check(launches["fused_mlp_fwd"] == per_step
              and launches["fused_mlp_bwd"] == per_step,
              f"step {i + 1}: K3 launched {launches['fused_mlp_fwd']} / "
              f"{launches['fused_mlp_bwd']} times, expected {per_step}")
    totals = {fn.__name__: fn.launches for fn in K.KERNELS}
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in params), "MP-PDE: non-finite gradient")
    warm = seconds[1:]
    print(f"  one epoch, {cfg.num_sims} Adam steps: losses {losses[0]:.6f} "
          f"... {losses[-1]:.6f} (min {min(losses):.6f}); s/step first "
          f"{seconds[0]:.4f}, warm median {float(np.median(warm)):.4f} "
          f"(min {min(warm):.4f}, max {max(warm):.4f}); K3 launches per step "
          f"{per_step} + {per_step}; epoch launches {totals}")
    rmse, steps = T.rollout_rmse(model, u[0])
    print(f"  rollout RMSE of simulation 0 over {steps} steps "
          f"({steps // cfg.bundle} bundles, the first given): {rmse:.6f}")
    check(np.isfinite(rmse), "MP-PDE: non-finite rollout RMSE")
    return totals


def gno_training(P, K, model, a, u):
    """Phase 7: the first batch's gradient on the K5 and xla paths, then
    one epoch of Adam steps on the K5 path and the test MSE. Returns the
    launch counts of the Adam steps."""
    from neuralgraphpde_torch.examples import train_gno_darcy as T

    cfg = T.Config()
    params = list(model.parameters())
    perm = torch.from_numpy(np.random.default_rng(cfg.seed).permutation(
        cfg.n_train)).to(a.device)
    batches = [perm[i:i + T.BATCH] for i in range(0, cfg.n_train, T.BATCH)]

    def batch_grad(idx):
        model.zero_grad(set_to_none=True)
        loss = T.batch_loss(model, a[idx], u[idx])
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in params]

    P.set_spmm_mode("auto")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_k, grads_k = batch_grad(batches[0])
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    P.set_spmm_mode("xla")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss_x, grads_x = batch_grad(batches[0])
        torch.cuda.synchronize()
        xla_s = time.perf_counter() - t0
        xla_peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        P.set_spmm_mode("auto")
    loss_rel = abs(loss_k - loss_x) / abs(loss_x)
    grad_rel = max(rel_err(gk, gx)[0] for gk, gx in zip(grads_k, grads_x))
    print(f"  batch-1 gradient, K5 path: loss {loss_k:.7f}, {cold:.3f} s "
          f"(first); xla path: loss {loss_x:.7f}, {xla_s:.3f} s, peak "
          f"{xla_peak:.3f} GB; loss rel {loss_rel:.3e} (bound "
          f"{GNO_LOSS_BOUND:g}), worst gradient rel {grad_rel:.3e} (bound "
          f"{GNO_GRAD_BOUND:g})")
    check(loss_rel <= GNO_LOSS_BOUND, f"GNO loss rel {loss_rel:.3e}")
    check(grad_rel <= GNO_GRAD_BOUND, f"GNO gradient rel {grad_rel:.3e}")

    step = P.make_train_step(lambda a_b, u_b: T.batch_loss(model, a_b, u_b),
                             P.adam(params, cfg.lr))
    per_step = T.BATCH * model.depth  # one K5 call per conv and sample
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    for i, idx in enumerate(batches, start=1):
        before = {fn.__name__: fn.launches for fn in K.KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = step(a[idx], u[idx])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches - before[fn.__name__]
                    for fn in K.KERNELS}
        print(f"  Adam step {i}: loss {float(loss):.7f}, {seconds:.4f} s, "
              f"launches {launches}")
        check(bool(torch.isfinite(loss)), f"step {i}: non-finite loss")
        check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                  for p in params), f"step {i}: non-finite gradient")
        check(launches["fused_gno_fwd"] == per_step
              and launches["fused_gno_bwd"] == per_step,
              f"step {i}: K5 launched {launches['fused_gno_fwd']} / "
              f"{launches['fused_gno_bwd']} times, expected {per_step}")
    totals = {fn.__name__: fn.launches for fn in K.KERNELS}
    print(f"  peak memory over the Adam steps "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    with torch.no_grad():
        test_mse = float(T.batch_loss(model, a[cfg.n_train:],
                                      u[cfg.n_train:]))
    print(f"  test MSE on the {cfg.num_samples - cfg.n_train} held-out "
          f"samples: {test_mse:.7f}")
    check(np.isfinite(test_mse), "GNO: non-finite test MSE")
    return totals


def vmh_training(P, K, model, u):
    """Phase 6: the epoch-1 full-batch gradient on the K3 and xla paths,
    then 3 Rprop epochs on the K3 path. Returns the launch counts of the 3
    epochs."""
    from neuralgraphpde_torch.examples import train_vmh as T

    cfg = T.Config()
    params = list(model.parameters())
    P.set_spmm_mode("auto")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_k, stats_k = T.full_batch_grad(model, u)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    grads_k = [p.grad.clone() for p in params]
    P.set_spmm_mode("xla")
    try:
        t0 = time.perf_counter()
        loss_x, stats_x = T.full_batch_grad(model, u)
        torch.cuda.synchronize()
        xla_s = time.perf_counter() - t0
    finally:
        P.set_spmm_mode("auto")
    loss_rel = abs(float(loss_k) - float(loss_x)) / abs(float(loss_x))
    grad_rel = max(rel_err(gk, p.grad)[0] for gk, p in zip(grads_k, params))
    acc_k = [st["accepted"] for st in stats_k]
    acc_x = [st["accepted"] for st in stats_x]
    print(f"  epoch-1 gradient, K3 path: loss {float(loss_k):.7f}, "
          f"{cold:.3f} s (first); xla path: loss {float(loss_x):.7f}, "
          f"{xla_s:.3f} s; loss rel {loss_rel:.3e} (bound "
          f"{VMH_LOSS_BOUND:g}), worst gradient rel {grad_rel:.3e} (bound "
          f"{VMH_GRAD_BOUND:g}); accepted steps per sim K3 {acc_k}, xla "
          f"{acc_x}")
    check(loss_rel <= VMH_LOSS_BOUND, f"VMH loss rel {loss_rel:.3e}")
    check(grad_rel <= VMH_GRAD_BOUND, f"VMH gradient rel {grad_rel:.3e}")
    check(acc_k == acc_x, "VMH: accepted steps differ between paths")

    opt = P.rprop(params, cfg.lr, step_max=cfg.step_max)
    K.reset_launch_counts()
    for epoch in range(1, 4):
        before = {fn.__name__: fn.launches for fn in K.KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, stats = T.full_batch_grad(model, u)
        opt.step()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches - before[fn.__name__]
                    for fn in K.KERNELS}
        nfe = [st["nfe"] for st in stats]
        acc = [st["accepted"] for st in stats]
        print(f"  Rprop epoch {epoch}: loss {float(loss):.7f}, "
              f"{seconds:.3f} s/epoch, rhs evals per sim {nfe}, accepted "
              f"steps per sim {acc}, launches {launches}")
        check(bool(torch.isfinite(loss)), f"epoch {epoch}: non-finite loss")
        check(all(bool(torch.isfinite(p.grad).all()) for p in params),
              f"epoch {epoch}: non-finite gradient")
        check(launches["fused_mlp_fwd"] > 0 and launches["fused_mlp_bwd"] > 0,
              f"epoch {epoch}: K3 not launched")
    return {fn.__name__: fn.launches for fn in K.KERNELS}


def vmh_graph_rhs(model, u) -> dict:
    """Phase 6, last: one VMH right-hand-side evaluation under
    ``inference_mode``, eager against one replay of its captured CUDA graph,
    in turns (eager, graphed, graphed, eager). Returns the record."""
    from neuralgraphpde_torch.nn import conv as C
    from neuralgraphpde_torch.tools.profile_paths import device_per_call

    conv, x = model.model, u[0, 0]
    graph_fn = C.vmh_graph

    def turn(graphed: bool) -> dict:
        C.vmh_graph = graph_fn if graphed else (lambda conv, x: None)
        try:
            with torch.inference_mode():
                y = conv(x)
                torch.cuda.synchronize()
                replays = graph_fn.replays
                t0 = time.perf_counter()
                for _ in range(VMH_GRAPH_REPS):
                    conv(x)
                host = time.perf_counter() - t0
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                replays = graph_fn.replays - replays
                dev_ms, kernels = device_per_call(lambda: conv(x))
        finally:
            C.vmh_graph = graph_fn
        path = "graphed" if graphed else "eager"
        check(replays == (VMH_GRAPH_REPS if graphed else 0),
              f"VMH graph: {replays} replays in an {path} turn of "
              f"{VMH_GRAPH_REPS} calls")
        return dict(path=path, out=y,
                    host_us=host / VMH_GRAPH_REPS * 1e6,
                    wall_us=wall / VMH_GRAPH_REPS * 1e6,
                    device_us=dev_ms * 1e3, device_kernels=kernels)

    captures = graph_fn.captures
    turns = [turn(graphed) for graphed in (False, True, True, False)]
    check(graph_fn.captures - captures == 1,
          f"VMH graph: {graph_fn.captures - captures} captures, not 1")
    want = turns[0]["out"]
    for t in turns:
        same = torch.equal(t.pop("out"), want)
        print(f"  {t['path']:8s} host {t['host_us']:8.1f} us  wall "
              f"{t['wall_us']:8.1f} us  device {t['device_us']:7.1f} us  "
              f"{t['device_kernels']:.1f} device kernels an evaluation; "
              f"bits equal to the first eager turn's: {same}")
        check(same, f"VMH graph: a {t['path']} output differs from the "
                    "eager one")
    return dict(turns=turns)


def worst_grad(a, b) -> float:
    """The worst gradient error of ``a`` against ``b``, each over its own
    largest entry."""
    return max(rel_err(x, y)[0] for x, y in zip(a, b))


def bf16_counts(K) -> dict:
    """The launches that read a bf16 operand, per wrapper that counts them
    (K3, K5, K6)."""
    return {fn.__name__: fn.bf16_launches for fn in K.KERNELS
            if hasattr(fn, "bf16_launches")}


def in_mode(P, mode, fn):
    """``fn()`` with the SpMM mode set to ``mode``, then ``auto`` again;
    synchronised, with its host seconds: ``(result, seconds)``."""
    P.set_spmm_mode(mode)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    finally:
        P.set_spmm_mode("auto")


def bf16_parity(label, kernel, xla):
    """Gate a bf16 path's ``(loss, gradients)`` on the kernel path against
    the xla path in bf16: loss rel ≤ 1e-2, every gradient within 5e-2 of
    its own largest entry."""
    loss_rel = abs(kernel[0] - xla[0]) / abs(xla[0])
    grad_rel = worst_grad(kernel[1], xla[1])
    check(all(bool(torch.isfinite(t).all()) for t in kernel[1]),
          f"{label}: non-finite gradient")
    check(loss_rel <= BF16_LOSS_BOUND, f"{label}: loss rel {loss_rel:.3e}")
    check(grad_rel <= BF16_GRAD_BOUND, f"{label}: gradient rel "
                                       f"{grad_rel:.3e}")
    return (f"loss {kernel[0]:.7f} vs xla {xla[0]:.7f}, rel {loss_rel:.3e} "
            f"(bound {BF16_LOSS_BOUND:g}), worst gradient rel "
            f"{grad_rel:.3e} (bound {BF16_GRAD_BOUND:g})")


def bf16_vmh_layer(P, K, dev, pts):
    """bf16(VMHConv) at ``bench.py``'s VMH case: the 2^15-point Delaunay
    mesh with its f32 positions in ``ndata``, ϕ 4→60→60→60→40 and γ
    41→60→60→60→1 tanh: the gradient of ``sum(y²)`` (input and every
    master parameter) on K3 (resident; f32 edge features, bf16 weights)
    against the xla path in bf16, and its time beside the f32 layer's.
    Returns the bf16 launches of the kernel-path run."""
    g = P.precompute(P.delaunay_graph(pts, ndata={"x": torch.from_numpy(
        pts)}), dense=False, pallas=True).to(dev)
    gen = torch.Generator().manual_seed(12)
    kw = dict(generator=gen, device=dev)
    layer = P.VMHConv(P.MLP((4, 60, 60, 60, 40), "tanh", **kw),
                      P.MLP((41, 60, 60, 60, 1), "tanh", **kw))
    model = P.bf16(layer)
    P.update_graph(model, g)
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(g.num_nodes, 1)).astype(np.float32)).to(dev)
    params = list(layer.parameters())

    def grad(m):
        def run():
            layer.zero_grad(set_to_none=True)
            xl = x.clone().requires_grad_()
            loss = (m(xl) ** 2).sum()
            loss.backward()
            return float(loss.detach()), [xl.grad] + [p.grad.clone() for p in params]
        return run

    times = {}
    for name, m, mode in (("bf16 K3", model, "auto"),
                          ("bf16 xla", model, "xla"),
                          ("f32 K3", layer, "auto"),
                          ("f32 xla", layer, "xla")):
        in_mode(P, mode, grad(m))  # warm-up
        if name == "bf16 K3":
            K.reset_launch_counts()
        out, times[name] = in_mode(P, mode, grad(m))
        if name == "bf16 K3":
            launches, kern = bf16_counts(K), out
        elif name == "bf16 xla":
            xla = out
    line = bf16_parity("bf16 VMH layer", kern, xla)
    print(f"  N={g.num_nodes} E={g.num_edges}: {line}; forward+gradient "
          + ", ".join(f"{k} {v:.4f} s" for k, v in times.items())
          + f"; bf16 launches {launches}")
    check(launches["fused_mlp_fwd"] > 0 and launches["fused_mlp_bwd"] > 0,
          "bf16 VMH layer: K3 not launched in bf16")
    return launches


def vmh_grad_run(P, T, model, u, mode):
    """The full-batch epoch gradient in ``mode``: ``((loss, gradients),
    per-sim stats, seconds, peak GB above the resident tensors)``."""
    params = list(model.parameters())
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (loss, stats), seconds = in_mode(P, mode,
                                     lambda: T.full_batch_grad(model, u))
    peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
    return ((float(loss), [p.grad.clone() for p in params]), stats, seconds,
            peak)


def bf16_vmh_training(P, K, model_f32, u):
    """``NeuralGraphODE(bf16(VMHConv))`` at config 2 (24 sims × 3,000
    points; the solver state f32, the right-hand side in bf16): the epoch-1
    gradient on K3 against the xla path in bf16, the accepted and rejected
    steps of each beside the f32 model's, then one Rprop epoch on K3.
    Returns the bf16 launches of the K3 epoch-1 gradient."""
    import copy

    from neuralgraphpde_torch.examples import train_vmh as T

    f32 = copy.deepcopy(model_f32)
    _, stats32, s32, _ = vmh_grad_run(P, T, f32, u, "auto")
    del f32
    model = copy.deepcopy(model_f32)
    model.model = P.bf16(model.model)
    K.reset_launch_counts()
    kern, stats_k, sk, peak_k = vmh_grad_run(P, T, model, u, "auto")
    launches = bf16_counts(K)
    xla, stats_x, sx, _ = vmh_grad_run(P, T, model, u, "xla")
    line = bf16_parity("bf16 VMH training", kern, xla)

    def steps(stats):
        accepted = sorted({st["accepted"] for st in stats})
        rejected = sorted({st["steps"] - st["accepted"] for st in stats})
        return (f"accepted {accepted}, rejected {rejected}, rhs evals "
                f"{sum(st['nfe'] for st in stats)}")

    print(f"  epoch-1 gradient: {line}\n"
          f"    per sim, bf16 K3: {steps(stats_k)}; bf16 xla: "
          f"{steps(stats_x)}; f32 K3: {steps(stats32)}\n"
          f"    seconds: bf16 K3 {sk:.3f} ({peak_k:.4f} GB above resident), "
          f"bf16 xla {sx:.3f}, f32 K3 {s32:.3f}; bf16 launches {launches}")
    check(launches["fused_mlp_fwd"] > 0 and launches["fused_mlp_bwd"] > 0,
          "bf16 VMH training: K3 not launched in bf16")
    opt = P.rprop(model.parameters(), T.Config().lr,
                  step_max=T.Config().step_max)
    (loss, _), _, seconds, _ = vmh_grad_run(P, T, model, u, "auto")
    opt.step()
    print(f"  one Rprop epoch on K3: loss {loss:.7f}, {seconds:.3f} s")
    check(np.isfinite(loss), "bf16 VMH: non-finite loss")
    return launches


def backsolve_vmh(P, K, model_f32, u):
    """Config 2 in f32 with ``adjoint="backsolve"``: the epoch-1 gradient on
    K3 (each augmented evaluation runs K3 forward and backward) against the
    xla path's backsolve: loss rel ≤ 1e-4, each gradient within 1e-3 of its
    largest entry, the same accepted steps forward and backward per sim;
    its seconds and peak memory beside the checkpoint epoch's. Returns the
    launches of the K3 run."""
    import copy

    from neuralgraphpde_torch.examples import train_vmh as T

    model = copy.deepcopy(model_f32)
    model.adjoint = "checkpoint"
    _, _, s_chk, peak_chk = vmh_grad_run(P, T, model, u, "auto")
    model.adjoint = "backsolve"
    K.reset_launch_counts()
    kern, stats_k, sk, peak_k = vmh_grad_run(P, T, model, u, "auto")
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    xla, stats_x, sx, _ = vmh_grad_run(P, T, model, u, "xla")
    loss_rel = abs(kern[0] - xla[0]) / abs(xla[0])
    grad_rel = worst_grad(kern[1], xla[1])

    def steps(stats):
        return [(st["accepted"], st["backward_accepted"]) for st in stats]

    print(f"  epoch-1 gradient: loss {kern[0]:.7f} vs xla {xla[0]:.7f}, rel "
          f"{loss_rel:.3e} (bound {BACKSOLVE_LOSS_BOUND:g}), worst gradient "
          f"rel {grad_rel:.3e} (bound {BACKSOLVE_GRAD_BOUND:g}); accepted "
          f"steps per sim (forward, backward) K3 "
          f"{sorted(set(steps(stats_k)))}, xla {sorted(set(steps(stats_x)))}"
          f"; backward rhs evals per sim "
          f"{sorted({st['backward_nfe'] for st in stats_k})}\n"
          f"    seconds: backsolve K3 {sk:.3f} ({peak_k:.4f} GB above "
          f"resident), xla {sx:.3f}; checkpoint K3 {s_chk:.3f} "
          f"({peak_chk:.4f} GB); launches {launches}")
    check(loss_rel <= BACKSOLVE_LOSS_BOUND, f"backsolve VMH loss rel "
                                            f"{loss_rel:.3e}")
    check(grad_rel <= BACKSOLVE_GRAD_BOUND, f"backsolve VMH gradient rel "
                                            f"{grad_rel:.3e}")
    check(steps(stats_k) == steps(stats_x),
          "backsolve VMH: accepted steps differ between paths")
    check(launches["fused_mlp_fwd"] > 0 and launches["fused_mlp_bwd"] > 0,
          "backsolve VMH: K3 not launched")
    return launches


def bf16_gno(P, K, model_f32, a, u):
    """``bf16(GNOModel)`` at config 4: the batch-1 gradient on K5 (f32 ``ph``
    and ``h`` after the f32 lift, bf16 weights) against the xla path in
    bf16. Returns the bf16 launches of the K5 run."""
    import copy

    from neuralgraphpde_torch.examples import train_gno_darcy as T

    cfg = T.Config()
    model = P.bf16(copy.deepcopy(model_f32))
    params = list(model.parameters())
    idx = torch.from_numpy(np.random.default_rng(cfg.seed).permutation(
        cfg.n_train)[:T.BATCH]).to(a.device)

    def run():
        model.zero_grad(set_to_none=True)
        loss = T.batch_loss(model, a[idx], u[idx])
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in params]

    in_mode(P, "auto", run)  # warm-up
    K.reset_launch_counts()
    kern, sk = in_mode(P, "auto", run)
    launches = bf16_counts(K)
    xla, sx = in_mode(P, "xla", run)
    line = bf16_parity("bf16 GNO", kern, xla)
    print(f"  batch-1 gradient: {line}; K5 path {sk:.4f} s, xla {sx:.4f} s;"
          f" bf16 launches {launches}")
    check(launches["fused_gno_fwd"] > 0 and launches["fused_gno_bwd"] > 0,
          "bf16 GNO: K5 not launched in bf16")
    return launches


def bf16_mppde(P, K, model_f32, u):
    """``bf16(MPPDESolver)`` at config 3: the step-1 gradient on K3
    (streamed; f32 edge features, bf16 weights) against the xla path in
    bf16. Returns the bf16 launches of the K3 run."""
    import copy

    from neuralgraphpde_torch.examples import train_mppde_burgers as T

    cfg = T.Config()
    inner = copy.deepcopy(model_f32)
    model = P.bf16(inner)
    model.bundle = inner.bundle  # what batch_loss reads
    params = list(model.parameters())
    starts = T.window_starts(cfg, u.shape[2])
    first = np.random.default_rng(cfg.seed).choice(starts, size=T.SAMPLES)

    def run():
        model.zero_grad(set_to_none=True)
        loss = T.batch_loss(model, u[0], first, cfg.pushforward)
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in params]

    in_mode(P, "auto", run)  # warm-up
    K.reset_launch_counts()
    kern, sk = in_mode(P, "auto", run)
    launches = bf16_counts(K)
    xla, sx = in_mode(P, "xla", run)
    line = bf16_parity("bf16 MP-PDE", kern, xla)
    print(f"  step-1 gradient: {line}; K3 path {sk:.4f} s, xla {sx:.4f} s; "
          f"bf16 launches {launches}")
    check(launches["fused_mlp_fwd"] > 0 and launches["fused_mlp_bwd"] > 0,
          "bf16 MP-PDE: K3 not launched in bf16")
    return launches


def bf16_mppde_layer_max(P, K, g, dev):
    """``bf16(MPPDEConv(aggr="max"))`` at the config-3 widths on the
    Burgers chain, its graph data given in bf16 so that the messages are
    bf16: the K6 path (bf16 launches counted); the same layer with K6's
    plain version in its place (the same tie rule: the output equal bit for
    bit, the gradients within 5e-2 of their largest entry, since the
    gather's backward adds its bf16 rows with atomics, in an order that
    changes from run to run); the xla path (output equal: a max rounds
    nothing; its gradient splits a tied maximum's cotangent, so the gap is
    printed with the number of ties, not gated). Returns the bf16 launches
    of the K6 run."""
    import importlib

    from neuralgraphpde_torch.examples import train_mppde_burgers as T

    seg = importlib.import_module("neuralgraphpde_torch.kernels."
                                  "segment_kernels")
    cfg = T.Config()
    H, KB = cfg.hidden, cfg.bundle
    gen = torch.Generator().manual_seed(13)
    kw = dict(activation="swish", generator=gen, device=dev)
    layer = P.MPPDEConv(P.MLP((2 * H + KB + 1, H, H), **kw),
                        P.MLP((2 * H, H, H), **kw), aggr="max")
    model = P.bf16(layer)
    rng = np.random.default_rng(13)
    window = torch.from_numpy(rng.normal(size=(g.num_nodes, KB)).astype(
        np.float32)).to(dev, BF16)
    P.update_graph(model, g.copy(ndata={"u": window,
                                        "x": g.ndata["x"].to(BF16)}))
    x = torch.from_numpy(rng.normal(size=(g.num_nodes, H)).astype(
        np.float32)).to(dev)
    gy = torch.from_numpy(rng.normal(size=(g.num_nodes, H)).astype(
        np.float32)).to(dev)
    params = list(layer.parameters())
    kept = {}
    hook = layer.phi.register_forward_hook(
        lambda mod, inputs, out: kept.__setitem__("m", out.detach()))

    def run():
        layer.zero_grad(set_to_none=True)
        xl = x.clone().requires_grad_()
        y = model(xl)
        y.backward(gy)
        return y.detach(), [xl.grad] + [p.grad.clone() for p in params]

    in_mode(P, "auto", run)  # warm-up
    K.reset_launch_counts()
    (y_k, grads_k), sk = in_mode(P, "auto", run)
    launches = bf16_counts(K)
    messages = kept.pop("m")
    kernel_wrapper = seg.segment_max
    seg.segment_max = seg.segment_max_plain  # the plain version in its place
    try:
        (y_p, grads_p), _ = in_mode(P, "auto", run)
    finally:
        seg.segment_max = kernel_wrapper
    (y_x, grads_x), sx = in_mode(P, "xla", run)
    hook.remove()
    recv = g.receivers.long()
    top = K.segment_max_plain(messages, g.cache["tcsr_edges"])
    ties = int((torch.zeros_like(top, dtype=torch.int32).index_add_(
        0, recv, (messages == top[recv]).int()) > 1).sum())
    xla_gap = worst_grad(grads_k, grads_x)
    plain_gap = worst_grad(grads_k, grads_p)
    print(f"  N={g.num_nodes} E={g.num_edges}, H {H}, K {KB}, bf16 messages "
          f"({dtype_name(messages.dtype)}): output equal to the plain K6 "
          f"path's bits: {torch.equal(y_k, y_p)}, gradients within "
          f"{plain_gap:.3e} of their largest entry (bound "
          f"{BF16_GRAD_BOUND:g}); output vs xla rel "
          f"{rel_err(y_k, y_x)[0]:.3e} (bound {BF16_LOSS_BOUND:g}); "
          f"gradients vs xla {xla_gap:.3e} of their largest entry with "
          f"{ties} tied maxima (xla splits a tie's cotangent, K6 gives each "
          f"tied edge all of it: not gated); K6 path {sk:.4f} s, xla "
          f"{sx:.4f} s; bf16 launches {launches}")
    check(messages.dtype == BF16, "bf16 MPPDEConv max: messages not bf16")
    check(torch.equal(y_k, y_p), "bf16 MPPDEConv max: output != the plain "
                                 "K6 path's")
    check(plain_gap <= BF16_GRAD_BOUND, f"bf16 MPPDEConv max: gradient "
                                        f"{plain_gap:.3e} from the plain K6 "
                                        f"path's")
    check(rel_err(y_k, y_x)[0] <= BF16_LOSS_BOUND,
          "bf16 MPPDEConv max: output vs xla")
    check(launches["segment_max"] > 0, "bf16 MPPDEConv max: K6 not launched "
                                       "in bf16")
    return launches


def rk_checks(dev) -> dict:
    """Phase 5, the RK stage kernels alone against the eager compositions
    they replaced (their plain versions, run on the card), at the grid
    state and at a VMH solve's state. Returns the records by name, each
    with the VMH record under ``other_shapes``."""
    from neuralgraphpde_torch.kernels import rk_kernels as rk
    from neuralgraphpde_torch.ode.tableaus import TSIT5

    hf = 0.0371
    hd = torch.tensor(hf, dtype=torch.float64, device=dev)
    stage6 = TSIT5.a[6]
    first = [[TSIT5.a[m][0] for m in range(6, 0, -1)], [1.0] * 6]
    cases = [
        # (record, what, kernel, plain, inputs read, outputs written)
        ("rk_combine", "Tsit5 stage input, base + 6 terms",
         lambda y, y1, ks: rk.rk_combine(y, hf, stage6, ks[:6]),
         lambda y, y1, ks: rk.combine_plain(y, hf, stage6, ks[:6]), 7, 1),
        ("rk_combine hermite", "Hermite save, 4 terms",
         lambda y, y1, ks: rk.rk_combine(None, None, (0.3, 0.01, 0.7, -0.02),
                                         [y, ks[0], y1, ks[6]], False),
         lambda y, y1, ks: rk.combine_plain(
             None, None, (0.3, 0.01, 0.7, -0.02), [y, ks[0], y1, ks[6]],
             False), 4, 1),
        ("rk_norm", "error norm, 7 terms, max(|y0|, |y1|)",
         lambda y, y1, ks: rk.rk_norm(hf, TSIT5.b_err, ks, y, y1, 1e-3,
                                      1e-3),
         lambda y, y1, ks: rk.norm_plain(hf, TSIT5.b_err, ks, y, y1, 1e-3,
                                         1e-3), 9, 0),
        ("rk_combine device h", "Tsit5 stage input, h on the card",
         lambda y, y1, ks: rk.rk_combine(y, hd, stage6, ks[:6]),
         lambda y, y1, ks: rk.combine_plain(y, hf, stage6, ks[:6]), 7, 1),
        ("rk_norm device h", "error norm, 7 terms, h on the card",
         lambda y, y1, ks: rk.rk_norm(hd, TSIT5.b_err, ks, y, y1, 1e-3,
                                      1e-3),
         lambda y, y1, ks: rk.norm_plain(hf, TSIT5.b_err, ks, y, y1, 1e-3,
                                         1e-3), 9, 0),
        ("rk_scatter", "first stage's backward, 6 cotangents to 2",
         lambda y, y1, ks: rk.rk_scatter(ks[:6], first, hf, [True, False]),
         lambda y, y1, ks: rk.scatter_plain(ks[:6], first, hf,
                                            [True, False]), 6, 2)]
    host_norm = next(c[2] for c in cases if c[0] == "rk_norm")
    records = {}
    for label, shape in (("grid", (512 * 512, 64)), ("VMH", (3000, 1))):
        gen = torch.Generator(device=dev).manual_seed(0)
        y, y1, *ks = [torch.randn(shape, device=dev, generator=gen)
                      for _ in range(9)]
        state = y.numel() * y.element_size()
        for name, what, kernel, plain, reads, writes in cases:
            got, want = kernel(y, y1, ks), plain(y, y1, ks)
            if name.startswith("rk_norm"):
                rel = abs(float(got) - float(want)) / float(want)
                same = torch.equal(kernel(y, y1, ks), got)
                check(rel <= 1e-6 and same, f"{name} at {label}: rel "
                                            f"{rel:.3e}, rerun same {same}")
                if name != "rk_norm":  # h on the card: the host-h bits
                    check(torch.equal(got, host_norm(y, y1, ks)),
                          f"{name} at {label}: not the host-h norm's bits")
            else:
                got = got if isinstance(got, list) else [got]
                want = want if isinstance(want, list) else [want]
                rel = max(rel_err(a, b)[0] for a, b in zip(got, want))
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"{name} at {label}: not the eager bits (rel "
                      f"{rel:.3e})")
            ms = cuda_ms(lambda: kernel(y, y1, ks))
            plain_ms = cuda_ms(lambda: plain(y, y1, ks))
            b_ms, b_by = bound((reads + writes) * state, 0.0)
            rec = dict(name=name, what=what, shape=list(shape), ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, max_rel_err=rel, max_abs_err=None,
                       bits=("rerun same, host-h same"
                             if name == "rk_norm device h" else
                             "rerun same" if name == "rk_norm" else "same"))
            print(f"  {name:<19} {label:<5} {what}: {ms:.4f} ms (eager "
                  f"{plain_ms:.4f} ms, {plain_ms / ms:.1f}x), bound "
                  f"{b_ms:.4f} ms by {b_by} ({b_ms / ms:.0%} of it), "
                  f"{rec['bits']} (rel {rel:.1e})")
            if label == "grid":
                records[name] = rec
            else:
                records[name]["other_shapes"] = [rec]
        del y, y1, ks
    return records


def _k2_composition_bwd(dm, dmt, x, w, y, g, act):
    """K2's backward as it was before its fused pass, the JAX package's
    ``_rhs_bwd`` step by step (phase 5's ``plain_ms``): ``dz = g ·
    act'(y)``, the aggregate recomputed by the stencil, ``dW = aggᵀ dz``,
    ``dz Wᵀ``, then ``dx`` = the stencil on ``dia_norm_rev``, ``db = Σ
    dz``; ``(dx, dW, db)`` in f32."""
    from neuralgraphpde_torch.kernels import dia_kernels as D

    dz = g.float() * D.act_grad_from_y(act, y.float())
    agg = D._stencil(dm, x, D.dia_spmm_stencil, True)
    gup = dz @ w.float().t()
    return (D._stencil(dmt, gup, D.dia_spmm_stencil, True), agg.t() @ dz,
            dz.sum(0))


def k2_backward_checks(P, K, dev, grid_g) -> dict:
    """Phase 5, K2's fused backward alone on the self-looped 512² grid
    (``cache['dia_norm_rev']``), tanh with W and b at F = out = 64 (dW from
    the kernel's tiles) and 128 (dW as one product on u): against its plain
    version on the card (``dia_gcn_bwd_plain``, f32; dx ≤ 1e-5 of its
    largest entry, dW and db ≤ 1e-4), the same bits on a second call, and
    CUDA-event ms beside the composition it replaced (``_k2_composition_bwd``:
    dz, db, the recomputed aggregate, two products, the second stencil) on
    the same inputs. The bound takes ``bench_torch/core/counts.py::
    gcn_backward``'s operations and the bytes the DIA pass moves (g, y and
    x read once, dx written once, K values a row, W, dW and db), below the
    CSR structure's bytes that count assumes. Then one step of
    ``grand-grid.train``'s model (1433 → 64 → 7 on the grid,
    ``precompute(dense=False, auto_reorder=True)``, one Adam step) with the
    counters from 0: every fused backward call launches the kernel once,
    none is eager, no stencil runs in a backward. Returns the F 64 record,
    its ``other_shapes`` and the step's counts."""
    from bench_torch.core.counts import gcn_backward
    from neuralgraphpde_torch.kernels import dia_kernels as D

    dm, dmt = grid_g.cache["dia_norm"], grid_g.cache["dia_norm_rev"]
    n, nnz, k = dm.num_nodes, grid_g.num_edges, len(dmt.offsets)
    gen = torch.Generator(device=dev).manual_seed(5)
    records = []
    for f in (64, 128):
        x = torch.randn(n, f, device=dev, generator=gen)
        w = torch.randn(f, f, device=dev, generator=gen) / f ** 0.5
        b = torch.randn(1, f, device=dev, generator=gen) / 10
        with torch.no_grad():
            y = K.dia_gcn_rhs("tanh", x, w, b, dm)
        g = torch.randn(n, f, device=dev, generator=gen)

        def kernel():
            return D._gcn_bwd(dmt, x, w, y, g, "tanh", True, True, True)

        def composition():
            return _k2_composition_bwd(dm, dmt, x, w, y, g, "tanh")

        got, again = kernel(), kernel()
        want = D.dia_gcn_bwd_plain(dmt, x, w, y, g, "tanh")
        old = composition()
        torch.cuda.synchronize()
        errs = [rel_err(a, c)[0] for a, c in zip(got, want)]
        old_errs = [rel_err(a, c)[0] for a, c in zip(old, want)]
        same = all(torch.equal(a.view(torch.int32), c.view(torch.int32))
                   for a, c in zip(got, again))
        ms, plain_ms = cuda_ms(kernel), cuda_ms(composition)
        ops = gcn_backward(n, nnz, f, f, input_grad=True).ops
        dia_bytes = 4 * (4 * n * f + k * n + 2 * f * f + f)
        b_ms, b_by = bound(dia_bytes, ops)
        print(f"  K2 fused backward, grid N={n} nnz={nnz} F=out={f} tanh: "
              f"dx rel {errs[0]:.3e}, dW {errs[1]:.3e}, db {errs[2]:.3e}; "
              f"same bits twice {same}; kernel {ms:.4f} ms, composition "
              f"{plain_ms:.4f} ms (rel {max(old_errs):.1e}), bound "
              f"{b_ms:.4f} ms ({b_by}: {dia_bytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} GFLOP)")
        check(errs[0] <= 1e-5 and max(errs[1:]) <= 1e-4,
              f"K2 backward F {f}: rel errors {errs}")
        check(old_errs[0] <= 1e-5 and max(old_errs[1:]) <= 1e-4,
              f"K2 backward F {f}: the composition's rel errors {old_errs}")
        check(same, f"K2 backward F {f}: two calls differ")
        check(ms >= b_ms, f"K2 backward F {f}: {ms:.4f} ms below its bound")
        records.append(dict(
            max_abs_err=max(rel_err(a, c)[1] for a, c in zip(got, want)),
            max_rel_err=max(errs), ms=ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            shape=f"K2 fused backward grid N={n} F=out={f} tanh W b"))
        del x, w, b, y, g, got, again, want, old
    # one grand-grid.train step: the cell's widths, graph and storage
    grid = P.grid_graph_2d(512, 512, diagonals=True)
    cell_g = P.precompute(grid, add_self_loops=True, dense=False,
                          auto_reorder=True).to(dev)
    check("dia_norm_rev" in cell_g.cache, "grand-grid step: no DIA storage")
    model = P.grand_model(1433, 64, 7, precomputed_self_loops=True,
                          generator=torch.Generator().manual_seed(0),
                          device=dev)
    P.update_graph(model, cell_g)
    x = torch.randn(n, 1433, device=dev, generator=gen)
    labels = torch.randint(0, 7, (n,), device=dev, generator=gen)
    mask = torch.rand(n, device=dev, generator=gen) < 0.1
    step = P.make_train_step(
        lambda: P.masked_cross_entropy(model(x), labels, mask),
        P.adam(model.parameters(), 1e-2))
    K.reset_launch_counts()
    loss, _ = step()
    torch.cuda.synchronize()
    counts = dict(
        dia_gcn_rhs=K.dia_gcn_rhs.launches,
        dia_gcn_rhs_backward=K.dia_gcn_rhs.backward_launches,
        dia_gcn_rhs_backward_eager=K.dia_gcn_rhs.backward_eager,
        dia_spmm_stencil_backward=K.dia_spmm_stencil.backward_launches,
        rhs_evals=model.layer_2.last_stats["nfe"])
    print(f"  one grand-grid.train step (1433 → 64 → 7): loss "
          f"{float(loss):.7f}; counters {counts}")
    check(bool(torch.isfinite(loss)), "grand-grid step: non-finite loss")
    check(counts["dia_gcn_rhs_backward"] > 0
          and counts["dia_gcn_rhs_backward_eager"] == 0
          and counts["dia_spmm_stencil_backward"] == 0,
          f"grand-grid step: the fused K2 backward did not take every "
          f"backward call: {counts}")
    rec = records[0]
    rec["other_shapes"] = records[1:]
    rec["runs"] = [dict(run="grand-grid.train step", **counts)]
    return rec


def graphcast_checks(P, K, dev) -> dict:
    """Phase 12: K1 at GraphCast's shapes against its plain version, then
    one GraphCast training step with K1's launches counted. Returns the K1
    records (``shapes``) and the step's ``launches`` and ``backward``."""
    from neuralgraphpde_torch.models import graphcast as gc

    t0 = time.perf_counter()
    graphs = P.graphcast_graphs()
    prepared = {k: g.to(dev) for k, g in
                gc.precompute_graphs(graphs, GRAPHCAST_BLOCKS).items()}
    print(f"  graphs and precompute: {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(22)
    f = GRAPHCAST_F
    cases = [("multimesh", prepared["mesh"])]
    for name, count in zip(("grid2mesh", "mesh2grid"), GRAPHCAST_BLOCKS):
        first = next(iter(prepared[name].cache["receiver_blocks"]))[0]
        cases.append((f"{name} block 1 of {count}", first))
    shapes = []
    for label, g in cases:
        csr = g.cache["tcsr_edges"]
        x = torch.from_numpy(rng.normal(size=(g.num_edges, f)).astype(
            np.float32)).to(dev)
        got, want = K.segment_spmm(x, csr), K.segment_spmm_plain(x, csr)
        torch.cuda.synchronize()
        rel, diff = rel_err(got, want)
        ms = cuda_ms(lambda: K.segment_spmm(x, csr))
        plain_ms = cuda_ms(lambda: K.segment_spmm_plain(x, csr))
        b_ms, b_by = bound(nbytes(x, got) + csr_bytes(csr),
                           2.0 * g.num_edges * f)
        shape = (f"K1 GraphCast {label}: {csr.num_rows} receivers, "
                 f"{g.num_edges} edges, F={f} f32")
        print(f"  {shape:<66} rel {rel:.3e} (bound {F32_BOUND:g})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms "
              f"({b_by})")
        check(csr.num_cols == g.num_edges and csr.num_rows == g.num_nodes,
              f"{label}: not the edge-id layout")
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite")
        check(rel <= F32_BOUND, f"{label}: rel error {rel:.3e} > "
                                f"{F32_BOUND:g}")
        rec = dict(max_abs_err=diff, max_rel_err=rel, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                   bound_by=b_by, shape=shape)
        check_bounds(rec, shape)
        shapes.append(rec)
        del x, got, want

    model = P.GraphCast(recompute=True,
                        generator=torch.Generator().manual_seed(22),
                        device=dev).set_graphs(prepared)
    gen = torch.Generator(device=dev).manual_seed(22)
    n = graphs.mesh2grid.num_nodes
    x = torch.randn((n, 474), generator=gen, device=dev)
    y = torch.randn((n, 227), generator=gen, device=dev)
    node_w = torch.from_numpy(gc.area_weights(graphs.grid_lat)).to(dev)
    chan_w = torch.ones(227, device=dev)
    opt = P.adamw(model.parameters(), 1e-3, 0.9, 0.95, 1e-8, 0.1)
    step = P.make_train_step(
        lambda: P.weighted_mse(x[:, :227] + model(x), y, node_w, chan_w),
        opt)
    calls = len(model.processor) + sum(GRAPHCAST_BLOCKS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    K.segment_spmm.launches = K.segment_spmm.backward_launches = 0
    forwards = gc.interaction_forwards
    t0 = time.perf_counter()
    loss, _ = step()
    value = float(loss)
    seconds = time.perf_counter() - t0
    launches = K.segment_spmm.launches
    backward = K.segment_spmm.backward_launches
    forwards = gc.interaction_forwards - forwards
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  one AdamW step (the published widths, recomputation, blocks "
          f"{GRAPHCAST_BLOCKS}): loss {value:.6f}, {seconds:.2f} s (the "
          f"first), peak {peak / 1e9:.2f} GB; {forwards} interaction "
          f"forwards; segment_spmm launches {launches} ({calls} K1 calls a "
          f"forward, run again in the recomputation), of them in the "
          f"backward {backward}")
    check(math.isfinite(value), "GraphCast step: non-finite loss")
    check(forwards == 36, f"GraphCast step: {forwards} interaction "
                          f"forwards, expected 36")
    check(launches == 2 * calls and backward == 0,
          f"GraphCast step: K1 launched {launches} times ({backward} in "
          f"the backward), expected {2 * calls} (0)")
    del model, opt, step, prepared, x, y
    torch.cuda.empty_cache()
    return dict(shapes=shapes, launches={"segment_spmm": launches},
                backward={"segment_spmm": backward})


def gencast_checks(P, K, dev) -> dict:
    """Phase 13: K8, the mesh attention, at GenCast's published shapes (the
    M6 mesh in its local order, 32 hops, 4 heads of 128) against its plain
    version, forward and every gradient, timed beside its bound (the work
    over the pairs that attend, ``bench_torch/core/gencast_counts.py``),
    its plain version and ``library_ms``: SDPA with the dense mask on
    ``GENCAST_SDPA_QUERIES`` queries against every key, a yardstick the
    port never calls; then one full-size GenCast AdamW step with K8's
    counters set to 0 before it, under the profiler: launches, backward
    launches and pairs, and no PyTorch attention operator. Returns the
    record and the step's counts."""
    from bench_torch.core import gencast_counts as gnc
    from neuralgraphpde_torch.kernels import attention_kernels as ak
    from neuralgraphpde_torch.models import gencast as gm

    t0 = time.perf_counter()
    graphs = P.gencast_graphs()
    built = time.perf_counter()
    prepared = {k: g.to(dev) for k, g in gm.precompute_graphs(
        graphs, GENCAST_HOPS, GRAPHCAST_BLOCKS, dev).items()}
    torch.cuda.synchronize()
    lay = prepared["mesh"].cache["attention_layout"]
    n, heads, d = lay.num_nodes, 4, 128
    print(f"  graphs {built - t0:.1f} s, precompute (the {GENCAST_HOPS}-hop "
          f"layout on the card) {time.perf_counter() - built:.2f} s: "
          f"{n} nodes, {lay.pairs} pairs, {lay.tiles} tiles, fill "
          f"{lay.fill:.4f}")
    gen = torch.Generator(device=dev).manual_seed(24)
    q, k, v, cot = (torch.randn((n, heads * d), generator=gen, device=dev)
                    for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = K.mesh_attention(*leaves, lay, heads)
    g_got = torch.autograd.grad(got, leaves, cot)
    want = ak.mesh_attention_plain(*leaves, lay, heads)
    g_want = torch.autograd.grad(want, leaves, cot)
    torch.cuda.synchronize()
    rel, diff = rel_err(got, want)
    grads = [rel_err(a, b)[0] for a, b in zip(g_got, g_want)]
    del want, g_want, got, g_got

    def train_pair():
        out = K.mesh_attention(*leaves, lay, heads)
        torch.autograd.grad(out, leaves, cot)

    ms = cuda_ms(lambda: K.mesh_attention(q, k, v, lay, heads), reps=5,
                 warmup=1)
    pair_ms = cuda_ms(train_pair, reps=3, warmup=1)
    plain_ms = cuda_ms(lambda: ak.mesh_attention_plain(q, k, v, lay, heads),
                       reps=2, warmup=1)
    fwd = gnc.attention_forward(lay.pairs, n, heads, d)
    bwd = gnc.attention_backward(lay.pairs, n, heads, d)
    b_ms, b_by = bound(fwd.bytes, fwd.ops)
    bb_ms, _ = bound(bwd.bytes, bwd.ops)
    m = GENCAST_SDPA_QUERIES
    rows = torch.zeros((m, n), dtype=torch.bool, device=dev)
    rp = lay.row_ptr.tolist()
    offs = torch.arange(64, device=dev)
    for i in range(m // 64):
        t0_, t1_ = rp[i], rp[i + 1]
        keys = (lay.cols[t0_:t1_].long()[:, None] * 64 + offs).reshape(-1)
        bits = ak._bit_mask(lay.masks[t0_:t1_]).permute(1, 0, 2).reshape(
            64, -1)
        real = keys < n
        rows[i * 64:(i + 1) * 64, keys[real]] = bits[:, real]
    qb = q[:m].view(m, heads, d).transpose(0, 1)[None]
    kb, vb = (t.view(n, heads, d).transpose(0, 1)[None] for t in (k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qb, kb, vb,
                                                      attn_mask=rows),
                         reps=3, warmup=1)
    shape = (f"K8 GenCast M6, {GENCAST_HOPS} hops: {n} nodes, {lay.pairs} "
             f"pairs in {lay.tiles} tiles (fill {lay.fill:.3f}), "
             f"{heads} x {d} f32")
    print(f"  {shape}: rel {rel:.3e} (bound {F32_BOUND:g}), gradients "
          f"{', '.join(f'{g:.3e}' for g in grads)} (bound "
          f"{K3_PARAM_BOUND:g}); kernel {ms:.2f} ms, forward and backward "
          f"{pair_ms:.2f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.2f} ms "
          f"forward ({b_by}) and {bb_ms:.2f} ms backward; SDPA on {m} "
          f"queries with the dense mask {library_ms:.2f} ms")
    check(rel <= F32_BOUND, f"K8: rel error {rel:.3e}")
    check(all(g <= K3_PARAM_BOUND for g in grads), f"K8 gradients {grads}")
    rec = dict(max_abs_err=diff, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
               shape=shape, training_pair=dict(
                   ms=pair_ms, bound_ms=b_ms + bb_ms, grad_rel=grads),
               library=f"SDPA, {m} queries x every key, dense bool mask")
    check_bounds(rec, shape)
    del q, k, v, cot, leaves, rows, qb, kb, vb

    model = P.GenCast(recompute=True,
                      generator=torch.Generator().manual_seed(24),
                      device=dev).set_graphs(prepared)
    ng = graphs.mesh2grid.num_nodes
    x = torch.randn((ng, 188), generator=gen, device=dev)
    r = torch.randn((ng, 84), generator=gen, device=dev)
    eps = torch.randn((ng, 84), generator=gen, device=dev)
    sigma = torch.tensor(1.7, device=dev)
    node_w = torch.from_numpy(P.models.graphcast.area_weights(
        graphs.grid_lat)).to(dev)
    chan_w = torch.ones(84, device=dev)
    opt = P.adamw(model.parameters(), 1e-3, 0.9, 0.95, 1e-8, 0.1)
    step = P.make_train_step(lambda: P.edm_weighted_mse(
        model(x, r + sigma * eps, sigma), r, sigma, node_w, chan_w), opt)
    step()  # the first step allocates what the second reuses
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    fn = K.mesh_attention
    fn.launches = fn.backward_launches = fn.pairs = 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        loss, _ = step()
        value = float(loss)
        seconds = time.perf_counter() - t0
    fused = sorted({e.name for e in prof.events()
                    if "attention" in e.name and e.name.startswith("aten::")})
    peak = torch.cuda.max_memory_allocated(dev)
    layers = len(model.processor)
    print(f"  one AdamW step (the published widths, recomputation): loss "
          f"{value:.6f}, {seconds:.2f} s (the second), peak "
          f"{peak / 1e9:.2f} GB; mesh_attention launches {fn.launches}, of "
          f"them in the backward {fn.backward_launches}, pairs "
          f"{fn.pairs} ({fn.pairs / lay.pairs:.2f} x the pairs that "
          f"attend); PyTorch attention operators: {fused or 'none'}")
    check(math.isfinite(value), "GenCast step: non-finite loss")
    check(fn.launches == 4 * layers and fn.backward_launches == 2 * layers,
          f"GenCast step: K8 launched {fn.launches} times "
          f"({fn.backward_launches} in the backward), expected "
          f"{4 * layers} ({2 * layers})")
    check(fn.pairs == 4 * layers * lay.tiles * 64 * 64,
          f"GenCast step: {fn.pairs} pairs")
    check(not fused, f"GenCast step ran {fused}")
    counts = dict(launches={"mesh_attention": fn.launches},
                  backward={"mesh_attention": fn.backward_launches},
                  pairs=fn.pairs, seconds=seconds, peak_bytes=peak)
    del model, opt, step, prepared, x, r, eps
    torch.cuda.empty_cache()
    return dict(record=rec, step=counts)


def grand_forward(P, model, g, x, label):
    """A first (cold) forward on the kernel path, a second (warm) one whose
    kernel launches are counted (the main path), two forwards on the xla
    path at the model's tolerances (their spread is printed), then the
    parity check at solver tolerance ``GRAND_PARITY_TOL``; returns (launch
    counts of the warm run, its seconds, solver stats)."""
    from neuralgraphpde_torch import kernels as K

    node = model.layer_2
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
    stats = dict(node.last_stats)
    check(tuple(logits.shape) == (g.num_nodes, model.layer_3.out_dims),
          f"{label}: logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    tols = node.rtol, node.atol
    P.set_spmm_mode("xla")
    try:
        ref_a, ref_b = model(x), model(x)
        node.rtol = node.atol = GRAND_PARITY_TOL
        ref = model(x)
        ref_stats = dict(node.last_stats)
        P.set_spmm_mode("auto")
        tight = model(x)
        tight_stats = dict(node.last_stats)
        torch.cuda.synchronize()
    finally:
        P.set_spmm_mode("auto")
        node.rtol, node.atol = tols
    rel, _ = rel_err(tight, ref)
    loose, spread = rel_err(logits, ref_a)[0], rel_err(ref_b, ref_a)[0]
    print(f"  {label}: {seconds:.4f} s/forward warm ({cold:.4f} s cold), "
          f"rhs evals {stats['nfe']}, steps {stats['steps']} (accepted "
          f"{stats['accepted']}); launches {launches}\n"
          f"    at rtol=atol={tols[0]:g}: rel vs xla {loose:.3e}, xla vs "
          f"xla {spread:.3e} (not gated)\n"
          f"    parity at rtol=atol={GRAND_PARITY_TOL:g}: rel vs xla "
          f"{rel:.3e} (bound {GRAND_BOUND:g}); kernel path {tight_stats}, "
          f"xla path {ref_stats}")
    check(rel <= GRAND_BOUND, f"{label}: rel {rel:.3e} vs xla > "
                              f"{GRAND_BOUND:g}")
    check(tight_stats["accepted"] == ref_stats["accepted"],
          f"{label}: accepted steps differ between paths")
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
    from neuralgraphpde_torch.examples import train_gno_darcy as G
    from neuralgraphpde_torch.examples import train_grand_cora as C
    from neuralgraphpde_torch.examples import train_mppde_burgers as M
    from neuralgraphpde_torch.examples import train_vmh as T
    from neuralgraphpde_torch.kernels import _build
    from neuralgraphpde_torch.ops.bsr import host_edges

    dev = torch.device("cuda", 0)
    _build.library()
    info = _build.build_info

    print(f"build: {info['seconds']:.1f} s (built={info['built']}) -> "
          f"{info['path']}; ptxas lines with spills: "
          f"{spills(info['ptxas']) or 'none'}")
    # K2 (csrc/dia_stencil.cu) is built to spill nothing
    k2_log = info["ptxas_by_source"].get("dia_stencil.cu", "")
    check("dia_stencil_kernel" in k2_log and "dia_gcn_rhs_kernel" in k2_log,
          "build: no ptxas report for dia_stencil.cu")
    check(not spills(k2_log), f"build: dia_stencil.cu spills: "
                              f"{spills(k2_log)}")
    # K3's kernels (csrc/fused_mlp.cu) and K5's reduce, product and
    # per-edge backward (csrc/gno.cu) are built to spill nothing and to keep
    # no local array (a stack frame of 0 bytes), in every instantiation: K3's
    # four dtype pairs, the reduce's 4, the product's 12 (three operand
    # layouts by four dtype combinations) and the per-edge backward's 8
    # (whole and sliced by four); the RK stage kernels' 6 and K8's 2 (heads
    # of 64 and 128) likewise
    gated = {"fused_mlp.cu": {"fused_mlp_fwd_stream_kernel": 4,
                              "fused_mlp_bwd_stream_kernel": 4,
                              "fused_mlp_fwd_resident_kernel": 4,
                              "fused_mlp_bwd_kernel": 4},
             "gno.cu": {"gno_reduce_kernel": 4, "gno_gemm_kernel": 12,
                        "gno_edge_bwd_kernel": 8},
             "rk_stage.cu": {"rk_combine_kernel": 6, "rk_norm_kernel": 6,
                             "rk_scatter_kernel": 6,
                             "rk_combine_dh_kernel": 6,
                             "rk_norm_dh_kernel": 6},
             "mesh_attention.cu": {"attention_fwd_kernel": 2,
                                   "attention_bwd_kv_kernel": 2,
                                   "attention_bwd_q_kernel": 2}}
    for source, kernels in gated.items():
        funcs = ptxas_by_function(info["ptxas_by_source"].get(source, ""))
        spilling = {f: lines for f, (lines, _) in funcs.items() if lines}
        print(f"build: {source} functions that spill: "
              f"{spilling or 'none'}")
        for kernel, count in kernels.items():
            # the mangled name: its length, the name, its template arguments
            found = {f: r for f, r in funcs.items()
                     if re.search(rf"\d{kernel}I", f)}
            check(len(found) == count, f"build: {len(found)} instantiations "
                                       f"of {kernel} in ptxas's report")
            spill = {f: lines for f, (lines, _) in found.items() if lines}
            frames = {f: frame for f, (_, frame) in found.items() if frame}
            check(not spill, f"build: {kernel} spills: {spill}")
            check(not frames, f"build: {kernel} keeps a stack frame: "
                              f"{frames}")

    t0 = time.perf_counter()
    grid = P.grid_graph_2d(512, 512, diagonals=True)
    grid_fused = P.precompute(grid, add_self_loops=True).to(dev)
    grid_plain = P.precompute(grid, add_self_loops=True,
                              gcn_fused=False).to(dev)
    check("dia_norm" in grid_fused.cache and "dia" in grid_plain.cache
          and "dia_norm" not in grid_plain.cache, "grid precompute keys")
    print(f"grid precompute: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vmh_model, vmh_u = T.setup(T.Config(), dev)
    csr_main = vmh_model.model.graph.cache["tcsr_edges"]
    pts = np.random.default_rng(0).random((VMH_POINTS_BENCH, 2))
    _, r = host_edges(P.delaunay_graph(pts.astype(np.float32)))
    csr_bench = K.build_segment_csr(np.arange(len(r)), r, VMH_POINTS_BENCH,
                                    num_cols=len(r)).to(dev)
    print(f"VMH dataset, model and meshes: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gno_model, gno_a, gno_u = G.setup(G.Config(), dev)
    gno_g = gno_model.graph
    m = GNO_N_BENCH
    s, r = P.darcy_dataset(num_samples=0, n=m,
                           radius=max(0.08, 1.6 / (m + 1))).graph.host_coo
    gno_cases = [
        ("Darcy 32²", gno_g.cache["tcsr_edges"], gno_g.senders, True),
        (f"Darcy {m}²", K.build_segment_csr(
            np.arange(len(r)), r, m * m, num_cols=len(r)).to(dev),
         torch.from_numpy(s).to(dev), False)]
    print(f"GNO dataset, model and graphs: {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mppde_model, mppde_u = M.setup(M.Config(), dev)
    torch.cuda.synchronize()
    mppde_g = mppde_model.graph
    print(f"MP-PDE Burgers dataset ({tuple(mppde_u.shape)} sims × nodes × "
          f"saves, RK4 on the card) and model: "
          f"{time.perf_counter() - t0:.2f} s")
    print("scrambled-label Delaunay meshes, precompute(add_self_loops=True, "
          "dense=False, auto_reorder=True):")
    reord_g, kind = scrambled_mesh(P, REORD_POINTS, dev)
    check(kind == "pbanded", f"2^17 mesh: {kind}, not packed bands")
    k7_meshes = {}
    for points in K7_POINTS:
        k7_meshes[points], kind = scrambled_mesh(P, points, dev)
        check(kind == "banded", f"{points} mesh: {kind}, not dense bands")
    rg = P.rand_graph(2 ** 18, 2 ** 22, seed=0)
    s, r = host_edges(rg)
    rand_edges = (s, r, rg.num_nodes)
    kept = r % 97 != 0  # every 97th receiver loses its edges
    r_empty = r[kept]

    def edge_layout(r, n):
        return (K.build_segment_csr(np.arange(len(r)), r, n,
                                    num_cols=len(r)).to(dev),
                torch.from_numpy(r.astype(np.int32)).to(dev))

    k6_cases = [
        ("rand", *edge_layout(r, rg.num_nodes), "segment_max"),
        ("rand, every 97th row empty", *edge_layout(r_empty, rg.num_nodes),
         None),
        ("Burgers", mppde_g.cache["tcsr_edges"], mppde_g.receivers,
         "segment_max Burgers")]
    tanh3 = ("tanh", "tanh", "tanh")
    label_bench = f"Delaunay 2^{VMH_POINTS_BENCH.bit_length() - 1}"
    k3_cases = [
        ("VMH mesh", csr_main, tanh3, (4, 60, 60, 60), "VMH"),
        (label_bench, csr_bench, tanh3, (4, 60, 60, 60), "hidden 60"),
        ("MP-PDE phi, Burgers", mppde_g.cache["tcsr_edges"], ("swish",),
         (2 * mppde_model.hidden + mppde_model.bundle + 1,
          mppde_model.hidden), "MP-PDE"),
        (label_bench, csr_bench, tanh3, (4, 128, 128, 128), "hidden 128")]

    print("kernel vs plain on the card:")
    records = kernel_checks(P, K, dev, grid_fused, rand_edges)
    k3_records = k3_checks(K, dev, k3_cases)
    records.update(k3_records["VMH"])
    records.update(k5_checks(K, dev, gno_cases))
    gkn_records = k5_gkn_checks(K, dev)
    records.update(k6_checks(K, dev, k6_cases))
    del k6_cases
    records.update(band_checks(K, dev, [
        ("2^17 scrambled Delaunay", reord_g, "pbanded", True),
        ("3,000 scrambled Delaunay", k7_meshes[3000], "banded", False),
        ("12,000 scrambled Delaunay", k7_meshes[12000], "banded", True)]))

    print("GRAND A (synthetic Cora, K1):")
    data = P.synthetic_cora()
    g = P.precompute(data.graph, add_self_loops=True, dense=False,
                     pallas=True).to(dev)
    model = P.grand_model(1433, 64, 7, rtol=1e-3, atol=1e-3,
                          precomputed_self_loops=True,
                          generator=torch.Generator().manual_seed(0),
                          device=dev)
    x = torch.from_numpy(data.features).to(dev)
    with torch.no_grad():
        launches_a, _, _ = grand_forward(P, model, g, x, "A")
    check(launches_a["segment_spmm"] > 0, "A: K1 not launched")
    grad_a, _ = grand_grad(
        P, K, model, g, x, torch.from_numpy(data.labels).to(dev),
        torch.from_numpy(data.train_mask).to(dev), "A gradient (K1)")
    check(grad_a["backward"].get("segment_spmm", 0) > 0,
          "A: K1 not launched in the backward")

    print("GRAND B (512² grid, K2):")
    model = P.grand_model(128, 128, 7, precomputed_self_loops=True,
                          generator=torch.Generator().manual_seed(1),
                          device=dev)
    grid_rng = np.random.default_rng(2)
    xg = torch.from_numpy(grid_rng.normal(
        size=(grid.num_nodes, 128)).astype(np.float32)).to(dev)
    yg = torch.from_numpy(grid_rng.integers(0, 7, grid.num_nodes)).to(dev)
    mg = torch.from_numpy(grid_rng.random(grid.num_nodes) < 0.1).to(dev)
    with torch.no_grad():
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
    grad_b, xla_b = grand_grad(P, K, model, grid_fused, xg, yg, mg,
                               "B gradient, fused K2")
    check(grad_b["backward"].get("dia_gcn_rhs", 0) > 0
          and grad_b["backward"].get("dia_spmm_stencil", 0) == 0,
          "B: the fused K2 backward not launched, or a stencil in it")
    grad_c, _ = grand_grad(P, K, model, grid_plain, xg, yg, mg,
                           "B gradient, gcn_fused=False (stencil K2)",
                           xla=xla_b)
    check(grad_c["backward"].get("dia_spmm_stencil", 0) > 0,
          "B unfused: stencil K2 not launched in the backward")
    del xla_b
    print("K2's fused backward alone, and in one grand-grid.train step:")
    k2_bwd = k2_backward_checks(P, K, dev, grid_fused)
    print("RK stage kernels alone (no Pallas source), against the eager "
          "composition:")
    rk_records = rk_checks(dev)

    print("GRAND on the 2^17-point scrambled Delaunay mesh (K4):")
    k4 = mesh_path(P, K, reord_g, "pbanded", "K4 mesh", seed=3)
    print("GRAND on the 12,000-point scrambled Delaunay mesh (K7):")
    k7 = mesh_path(P, K, k7_meshes[12000], "banded", "K7 mesh", seed=4)

    print(f"config 1: train_grand_cora defaults ({CORA_EPOCHS} epochs, "
          f"dense adjacency, as in JAX), then 3 epochs on the pallas "
          f"layout (K1):")
    cfg = C.Config(epochs=CORA_EPOCHS)
    cora_model, cora_data = C.setup(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = C.train(cora_model, cora_data, cfg).history[-1]
    torch.cuda.synchronize()
    print(f"  {CORA_EPOCHS} epochs in {time.perf_counter() - t0:.2f} s: "
          f"train acc {last['train_acc']:.4f}, val acc {last['val_acc']:.4f} "
          f"(gate {CORA_VAL_ACC:g})")
    check(last["val_acc"] >= CORA_VAL_ACC,
          f"config 1: val acc {last['val_acc']:.4f} < {CORA_VAL_ACC:g}")
    cfg = C.Config(epochs=3)
    cora_model, cora_data = C.setup(cfg, dev, dense=False, pallas=True)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    C.train(cora_model, cora_data, cfg)
    torch.cuda.synchronize()
    print(f"  3 epochs on K1 in {time.perf_counter() - t0:.2f} s: "
          f"segment_spmm launches {K.segment_spmm.launches}, of them in the "
          f"backward {K.segment_spmm.backward_launches}")
    check(K.segment_spmm.backward_launches > 0
          and K.segment_spmm.launches > K.segment_spmm.backward_launches,
          "config 1 on K1: K1 not launched forward and backward")
    del cora_model, cora_data

    print(f"hybrid DIA ({HYBRID_GRID}² periodic 8-neighbour grid, stencil "
          f"K2 + COO remainder):")
    hyb = P.precompute(P.grid_graph_2d(HYBRID_GRID, HYBRID_GRID,
                                       periodic=True, diagonals=True),
                       add_self_loops=True).to(dev)
    check({"dia", "dia_rev", "dia_rem"} <= set(hyb.cache)
          and "dia_norm" not in hyb.cache, "hybrid grid: no dia + dia_rem")
    print(f"  {hyb.num_nodes} nodes, {hyb.num_edges} edges, "
          f"{len(hyb.cache['dia'].offsets)} diagonals, "
          f"{hyb.cache['dia_rem'].senders.numel()} remainder edges")
    model = P.grand_model(64, 64, 7, precomputed_self_loops=True,
                          generator=torch.Generator().manual_seed(5),
                          device=dev)
    xh = torch.from_numpy(np.random.default_rng(5).normal(
        size=(hyb.num_nodes, 64)).astype(np.float32)).to(dev)
    with torch.no_grad():
        launches_h, _, _ = grand_forward(P, model, hyb, xh, "hybrid")
    check(launches_h["dia_spmm_stencil"] > 0, "hybrid: stencil K2 not "
                                              "launched")

    print("bf16 VMH layer (bf16(VMHConv) on the 2^15-point Delaunay mesh, "
          "K3):")
    launches_vl = bf16_vmh_layer(P, K, dev, pts.astype(np.float32))
    print("bf16 VMH training (NeuralGraphODE(bf16(VMHConv)), config 2, K3):")
    launches_vb = bf16_vmh_training(P, K, vmh_model, vmh_u)
    print("backsolve VMH (config 2 in f32, adjoint='backsolve', K3):")
    launches_bs = backsolve_vmh(P, K, vmh_model, vmh_u)

    print("VMH training (24 sims x 3,000 points, K3):")
    launches_v = vmh_training(P, K, vmh_model, vmh_u)
    print("VMH right-hand side, eager against one CUDA graph replay "
          "(inference_mode, 3,000 points):")
    vmh_graph_record = vmh_graph_rhs(vmh_model, vmh_u)

    print("bf16 GNO (bf16(GNOModel), config 4, K5):")
    launches_gb = bf16_gno(P, K, gno_model, gno_a, gno_u)
    print("GNO Darcy training (32 samples on the 32² grid, K5):")
    launches_g = gno_training(P, K, gno_model, gno_a, gno_u)

    print("MPPDEConv(aggr='max') at the config-3 widths (K6):")
    launches_k6 = mppde_layer_max(P, K, mppde_g, dev)
    print("bf16 MPPDEConv(aggr='max') on bf16 graph data (K6):")
    launches_k6b = bf16_mppde_layer_max(P, K, mppde_g, dev)

    print("bf16 MP-PDE (bf16(MPPDESolver), config 3, K3 streamed):")
    launches_mb = bf16_mppde(P, K, mppde_model, mppde_u)
    print("MP-PDE Burgers training (32 sims on the 256-node chain, K3):")
    launches_m = mppde_training(P, K, mppde_model, mppde_u)

    print("GraphCast at its published 0.25° widths (K1 at F 512):")
    graphcast = graphcast_checks(P, K, dev)
    print("GenCast at its published 0.25° widths (K8, the mesh attention):")
    gencast = gencast_checks(P, K, dev)

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
        "fused_mlp_fwd": ("neuralgraphpde_torch/csrc/fused_mlp.cu",
                          "neuralgraphpde/kernels/fused_mlp_kernels.py:121",
                          launches_v["fused_mlp_fwd"]),
        "fused_mlp_bwd": ("neuralgraphpde_torch/csrc/fused_mlp.cu",
                          "neuralgraphpde/kernels/fused_mlp_kernels.py:232",
                          launches_v["fused_mlp_bwd"]),
        "fused_gno_fwd": ("neuralgraphpde_torch/csrc/gno.cu",
                          "neuralgraphpde/kernels/gno_kernels.py:90",
                          launches_g["fused_gno_fwd"]),
        "fused_gno_bwd": ("neuralgraphpde_torch/csrc/gno.cu",
                          "neuralgraphpde/kernels/gno_kernels.py:198",
                          launches_g["fused_gno_bwd"]),
        "segment_max": ("neuralgraphpde_torch/csrc/segment_max.cu",
                        "neuralgraphpde/kernels/segment_kernels.py:398",
                        launches_k6["segment_max"]),
        # the mesh kernels' counts come from the fused main path: the
        # fused right-hand side forward, the SpMM in its backward
        "banded_spmm": ("neuralgraphpde_torch/csrc/banded.cu",
                        "neuralgraphpde/kernels/banded_kernels.py:68",
                        k7["fused"]["launches"].get("banded_spmm_pallas", 0)),
        "pbanded_spmm": ("neuralgraphpde_torch/csrc/banded.cu",
                         "neuralgraphpde/kernels/banded_kernels.py:181",
                         k4["adam"]["launches"].get("pbanded_spmm_pallas", 0)),
        "banded_gcn_rhs": ("neuralgraphpde_torch/csrc/banded.cu",
                           "neuralgraphpde/kernels/banded_kernels.py:337",
                           k7["fused"]["launches"].get("banded_gcn_rhs", 0)),
        "pbanded_gcn_rhs": ("neuralgraphpde_torch/csrc/banded.cu",
                            "neuralgraphpde/kernels/banded_kernels.py:434",
                            k4["adam"]["launches"].get("pbanded_gcn_rhs", 0)),
    }
    # each differentiable kernel's wrapper, its launches in the gradient
    # runs and the part of them made in backward passes
    runs = {
        "segment_spmm": ("segment_spmm", [
            ("GRAND A gradient", grad_a),
            ("GraphCast training step", graphcast)]),
        "dia_gcn_rhs": ("dia_gcn_rhs", [("GRAND B gradient", grad_b)]),
        "dia_spmm_stencil": ("dia_spmm_stencil", [
            ("GRAND B gradient", grad_b),
            ("GRAND B gradient, gcn_fused=False", grad_c)]),
        "banded_spmm": ("banded_spmm_pallas", [
            ("K7 mesh gradient, fused", k7["fused"]),
            ("K7 mesh gradient, plain SpMM", k7["unfused"])]),
        "pbanded_spmm": ("pbanded_spmm_pallas", [
            ("K4 mesh, 3 Adam steps", k4["adam"]),
            ("K4 mesh gradient, fused", k4["fused"]),
            ("K4 mesh gradient, plain SpMM", k4["unfused"])]),
        "banded_gcn_rhs": ("banded_gcn_rhs", [
            ("K7 mesh gradient, fused", k7["fused"])]),
        "pbanded_gcn_rhs": ("pbanded_gcn_rhs", [
            ("K4 mesh, 3 Adam steps", k4["adam"]),
            ("K4 mesh gradient, fused", k4["fused"])])}
    for name in ("banded_spmm", "pbanded_spmm"):
        check(sources[name][2] > 0, f"{name}: no launch on the fused path")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_rel_err", "shape")
    kernels = []
    for name, (source, replaces, launches) in sources.items():
        rec = records[name]
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=launches,
                     **{k: rec[k] for k in keys})
        if name in ("fused_mlp_fwd", "fused_mlp_bwd"):
            # K3's two variants: the record above is the resident one on
            # the VMH path; the streamed one runs config 3's MP-PDE ϕ
            entry["variants"] = [
                dict(variant=rec["variant"], path="VMH training",
                     launches=launches, ms=rec["ms"], shape=rec["shape"]),
                dict(path="MP-PDE training", launches=launches_m[name],
                     **{k: k3_records["MP-PDE"][name][k]
                        for k in ("variant",) + keys}),
                # on no model path (the VMH ϕ at 2^15 points, hidden 60:
                # bench.py's VMH case, and at hidden 128), so no run of a
                # path counts their launches
                dict(path="none (VMH phi at 2^15 points)", launches=None,
                     **{k: k3_records["hidden 60"][name][k]
                        for k in ("variant",) + keys}),
                dict(path="none (VMH phi at hidden 128)", launches=None,
                     **{k: k3_records["hidden 128"][name][k]
                        for k in ("variant",) + keys})]
            for v, run in zip(entry["variants"], ("VMH", "MP-PDE",
                                                  "hidden 60", "hidden 128")):
                v["device_ms"] = k3_records[run][name]["device_ms"]
        if name in gkn_records:
            entry["gkn"] = gkn_records[name]
        if name == "segment_spmm":
            entry["other_shapes"] = graphcast["shapes"]
        if name == "segment_max":
            burgers = records["segment_max Burgers"]
            entry["other_shapes"] = [{k: burgers[k] for k in keys}]
        if name in runs:
            fn, counted = runs[name]
            entry["runs"] = [
                dict(run=run, launches=counts["launches"].get(fn, 0),
                     backward_launches=counts["backward"].get(fn, 0))
                for run, counts in counted]
        for extra in ("k1_same_csr_ms", "training_pair", "device_ms",
                      "device_split", "reduce_device_ms", "reduce_bound_ms",
                      "unfused_ms"):
            if extra in rec:
                entry[extra] = rec[extra]
        entry["dtypes"] = {"every operand": "float32"}
        kernels.append(entry)
    # the backsolve VMH gradient: K3 forward and backward in every augmented
    # evaluation
    for entry in kernels:
        if entry["name"] in ("fused_mlp_fwd", "fused_mlp_bwd"):
            entry["runs"] = [dict(run="backsolve VMH epoch-1 gradient",
                                  launches=launches_bs[entry["name"]])]
    # the bf16 forms: each record at the shape and in the operand dtypes of
    # its bf16 path (under the policy the features stay f32 where they
    # concatenate f32 graph data), the path's bf16 launches, every form's
    # record beside it
    k3_vmh, k3_mp = k3_records["VMH"]["bf16"], k3_records["MP-PDE"]["bf16"]
    mixed = "f32 feats, bf16 weights"
    gno_form = "f32 ph and h, bf16 weights"
    bf16_entries = {
        "fused_mlp_fwd": (k3_vmh[mixed], launches_vb, "VMH training"),
        "fused_mlp_bwd": (k3_vmh[mixed], launches_vb, "VMH training"),
        "fused_gno_fwd": (records["gno_bf16"][gno_form], launches_gb,
                          "GNO batch-1 gradient"),
        "fused_gno_bwd": (records["gno_bf16"][gno_form], launches_gb,
                          "GNO batch-1 gradient")}
    for name, (form, launches, path) in bf16_entries.items():
        rec = form[name]
        source, replaces, _ = sources[name]
        check(launches[name] > 0, f"{name} bf16: no launch on its path")
        entry = dict(name=f"{name} bf16", route="cuda", source=source,
                     replaces=replaces, launches=launches[name], path=path,
                     **{k: rec[k] for k in keys + ("dtypes",)})
        forms = (k3_vmh if name.startswith("fused_mlp")
                 else records["gno_bf16"])
        entry["forms"] = {f: {k: v[name][k] for k in keys + ("dtypes",)}
                          for f, v in forms.items()}
        if name.startswith("fused_mlp"):
            entry["variants"] = [
                dict(path="VMH training", variant=rec["variant"],
                     launches=launches[name]),
                dict(path="MP-PDE step-1 gradient",
                     launches=launches_mb[name],
                     **{k: k3_mp[mixed][name][k]
                        for k in ("variant",) + keys + ("dtypes",)}),
                dict(path="bf16 VMH layer (2^15 points)",
                     launches=launches_vl[name])]
        kernels.append(entry)
    rec = records["segment_max Burgers"]["bf16"]
    check(launches_k6b["segment_max"] > 0, "segment_max bf16: no launch")
    kernels.append(dict(
        name="segment_max bf16", route="cuda", source=sources[
            "segment_max"][0], replaces=sources["segment_max"][1],
        launches=launches_k6b["segment_max"],
        path="bf16 MPPDEConv(aggr='max') on bf16 graph data",
        **{k: rec[k] for k in keys + ("dtypes",)},
        other_shapes=[{k: records["segment_max"]["bf16"][k]
                       for k in keys + ("dtypes",)}]))
    # K2's fused backward: the JAX package's custom VJP of the fused form
    # (a composition of the Pallas kernel and XLA), one launch a call
    kernels.append(dict(
        name="dia_gcn_rhs backward", route="cuda",
        source="neuralgraphpde_torch/csrc/dia_stencil.cu",
        replaces="neuralgraphpde/kernels/dia_kernels.py:367",
        launches=k2_bwd["runs"][0]["dia_gcn_rhs_backward"],
        runs=k2_bwd["runs"] + [dict(
            run="GRAND B gradient",
            backward_launches=grad_b["backward"].get("dia_gcn_rhs", 0))],
        **{k: k2_bwd[k] for k in keys}, other_shapes=k2_bwd["other_shapes"],
        dtypes={"every operand": "float32"}))
    # the RK stage wrappers: no TPU kernel (XLA fused this algebra), their
    # launches in GRAND B's gradient
    for name, extra in (("rk_combine", ("rk_combine hermite", "rk_scatter",
                                        "rk_combine device h")),
                        ("rk_norm", ("rk_norm device h",))):
        rec = rk_records[name]
        kernels.append(dict(
            name=name, route="cuda",
            source="neuralgraphpde_torch/csrc/rk_stage.cu", replaces=None,
            launches=grad_b["launches"].get(name, 0),
            runs=[dict(run="GRAND B gradient",
                       launches=grad_b["launches"].get(name, 0),
                       backward_launches=grad_b["backward"].get(name, 0))],
            **{k: rec[k] for k in keys}, what=rec["what"],
            other_shapes=rec["other_shapes"] + [rk_records[e]
                                                for e in extra],
            dtypes={"every operand": "float32"}))
        check(kernels[-1]["launches"] > 0, f"{name}: no launch in GRAND B")
    # K8: no TPU kernel (the JAX package has no attention), its launches
    # in one GenCast training step
    kernels.append(dict(
        name="mesh_attention", route="cuda",
        source="neuralgraphpde_torch/csrc/mesh_attention.cu",
        replaces=None, launches=gencast["step"]["launches"]["mesh_attention"],
        runs=[dict(run="GenCast training step",
                   launches=gencast["step"]["launches"]["mesh_attention"],
                   backward_launches=gencast["step"]["backward"][
                       "mesh_attention"],
                   pairs=gencast["step"]["pairs"])],
        **{k: gencast["record"][k] for k in keys},
        training_pair=gencast["record"]["training_pair"],
        library=gencast["record"]["library"],
        dtypes={"every operand": "float32"}))
    check_bounds(kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"vmh_graph": vmh_graph_record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
