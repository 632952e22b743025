"""Times of the DIA kernels (K2) built in other forms, on one GPU: other
rows per thread, and another checkout's package.

    python scripts/dia_variants.py [--variants r4-8 r8 r4 r16 ...]
                                   [--parent DIR] [--out PATH.json]

A variant ``r<s>-<f>`` builds the kernels with ``s`` consecutive rows a
thread in the stencil kernel and ``f`` in the fused one (``kStencilRows``
and ``kFusedRows`` in ``csrc/dia_stencil.cu``; the fused form's 64-row tile
then has ``64 / f`` row groups); ``r<rows>`` sets both. A suffix
``-b<rows>x<blocks>`` sets the fused backward's rows a thread in its
prologue and the blocks an SM its registers are held to (``kBwdRows``,
``kBwdBlocks``). The package as it is builds ``r4-8-b4x3``. For each one
this copies the package under
``build/dia_variants/<variant>/``, edits the copy's source (a pattern that
does not match exactly once stops the run) and, in a process of its own,
builds that copy. The variant ``parent`` runs the package of the checkout
at ``--parent`` as it is (``scripts/_variants.py``).

Each process times, at the 512² 8-neighbour grid with self-loops and F =
128 (``chip_smoke.py``'s K2 shapes), the stencil in f32 and in bf16 and the
fused right-hand side (tanh, W 128×128, b) in f32 and in bf16, and the
fused form's unfused composition (the stencil kernel, ``torch.addmm``,
``tanh``): CUDA-event ms over 20 calls and device ms per call
(``tools.profile_paths.device_per_call``), and each kernel's error against
its plain version; and the fused right-hand side's backward alone (tanh,
W and b, F = out = 64 and 128, through autograd on a kept graph, so that a
parent without the fused backward times its composition), its gradients'
error against the plain version's. Prints the ptxas lines of
``dia_stencil.cu`` with their registers and spills. The package itself is
not changed.
"""
from __future__ import annotations

import re

from _variants import PACKAGE, copy_package, edit, main


def variant(name: str):
    """The directory holding the package of variant ``name``."""
    rows = re.fullmatch(r"r(\d+)(?:-(\d+))?(?:-b(\d+)x(\d+))?", name)
    if rows is None:
        raise SystemExit(f"unknown variant {name!r}")
    root = copy_package("dia_variants", name)
    cu = root / PACKAGE.name / "csrc" / "dia_stencil.cu"
    consts = [("kStencilRows", rows[1]), ("kFusedRows", rows[2] or rows[1])]
    if rows[3]:
        consts += [("kBwdRows", rows[3]), ("kBwdBlocks", rows[4])]
    for const, value in consts:
        edit(cu, rf"constexpr int {const} = \d+;",
             f"constexpr int {const} = {value};")
    return root


def child(name: str) -> dict:
    """Times of the package on ``PYTHONPATH`` (one variant)."""
    import numpy as np
    import torch

    import neuralgraphpde_torch as P
    from neuralgraphpde_torch import kernels as K
    from neuralgraphpde_torch.kernels import _build
    from neuralgraphpde_torch.ops.dia import DiaMatrix
    from neuralgraphpde_torch.tools.profile_paths import device_per_call

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    log = _build.build_info.get("ptxas_by_source", {}).get(
        "dia_stencil.cu", _build.build_info["ptxas"])
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    g = P.precompute(P.grid_graph_2d(512, 512, diagonals=True),
                     add_self_loops=True).to(dev)
    dm, dn = g.cache["dia"], g.cache["dia_norm"]
    n = dm.num_nodes
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(dev)

    x, w, b = normal(n, 128), normal(128, 128, scale=128 ** -0.5), \
        normal(1, 128, scale=0.1)
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    dm16 = DiaMatrix(dm.values.to(torch.bfloat16), dm.offsets, n)
    dn16 = DiaMatrix(dn.values.to(torch.bfloat16), dn.offsets, n)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = {
        "stencil f32": (lambda: K.dia_spmm_stencil(x, dm),
                        lambda: K.dia_rhs_plain(dm, x, None, None, None,
                                                False, f32)),
        "stencil bf16": (lambda: K.dia_spmm_stencil(xb, dm16),
                         lambda: K.dia_rhs_plain(dm16, xb, None, None, None,
                                                 False, bf16)),
        "fused tanh f32": (lambda: K.dia_gcn_rhs("tanh", x, w, b, dn),
                           lambda: K.dia_rhs_plain(dn, x, w, b, "tanh", True,
                                                   f32)),
        "fused tanh bf16": (lambda: K.dia_gcn_rhs("tanh", xb, w, b, dn16),
                            lambda: K.dia_rhs_plain(dn16, xb, wb, b, "tanh",
                                                    True, bf16)),
        "unfused tanh f32": (
            lambda: torch.tanh(torch.addmm(b, K.dia_spmm_stencil(x, dn), w)),
            lambda: K.dia_rhs_plain(dn, x, w, b, "tanh", True, f32)),
    }
    gt = normal(n, 128)
    for f in (64, 128):
        xf, wf, bf = (t.contiguous().requires_grad_()
                      for t in (x[:, :f], w[:f, :f], b[:, :f]))
        y = K.dia_gcn_rhs("tanh", xf, wf, bf, dn, g.cache["dia_norm_rev"])
        yp = K.dia_rhs_plain(dn, xf, wf, bf, "tanh", True, f32)
        gf = gt[:, :f].contiguous()
        cases[f"fused backward tanh f32 F{f}"] = (
            (lambda y=y, xf=xf, wf=wf, bf=bf, gf=gf: torch.autograd.grad(
                y, (xf, wf, bf), gf, retain_graph=True)),
            (lambda yp=yp, xf=xf, wf=wf, bf=bf, gf=gf: torch.autograd.grad(
                yp, (xf, wf, bf), gf, retain_graph=True)))
    out = dict(variant=name, ptxas=ptxas, cases={})
    for what, (kernel, plain) in cases.items():
        got, want = kernel(), plain()
        if isinstance(got, tuple):  # gradients: the worst over the leaves
            rel = max(float((a - c).abs().max() / c.abs().max())
                      for a, c in zip(got, want))
        else:
            got, want = got.float(), want.float()
            rel = float((got - want).abs().max() / want.abs().max())
        for _ in range(3):
            kernel()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            kernel()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 20
        device_ms, kernels = device_per_call(kernel)
        out["cases"][what] = dict(rel=rel, ms=ms, device_ms=device_ms,
                                  kernels_per_call=kernels)
        print(f"{name} {what}: rel {rel:.3e}, {ms:.4f} ms by events, "
              f"{device_ms:.4f} device ms, {kernels:g} kernels a call",
              flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(main(__file__, ["r4-8-b4x3", "r8", "r4", "r16"],
                          variant, child, parent=True))
