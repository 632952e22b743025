"""Times of K3's kernels built in other forms, on one GPU: other thread
counts a block, other recompute task shapes in the forward, other rows a
resident forward block, and another checkout's package.

    python scripts/fused_mlp_variants.py
        [--variants t256-c2-r512-f256x4-s56 ...] [--parent DIR]
        [--out PATH.json]

A variant ``t<threads>-c<cols>-r<resident>-f<fwd>x<blocks>-s<slots>``
builds the streamed forward and backward with ``threads`` threads a block
(``kChunkThreads`` in ``csrc/fused_mlp.cu``), the forward's recompute
tasks, streamed and resident, with ``cols`` columns a lane (``kFwdCols``:
1, 2 or 4; a task of fewer columns takes more chunk rows), the resident
backward with ``resident`` threads a block (``kResThreads``), the resident
forward with ``fwd`` threads a block and registers for ``blocks`` blocks an
SM (``kResFwdThreads``, ``kResFwdBlocks``), and gives a resident forward
block about ``slots`` edge slots (``_FWD_SLOTS`` in
``kernels/fused_mlp_kernels.py``). The package as it is builds
``t256-c2-r512-f256x4-s56``. For each one this copies the package under
``build/fused_mlp_variants/<variant>/``, edits the copy (a pattern that
does not match exactly once stops the run) and, in a process of its own,
builds that copy. The variant ``parent`` runs the package of the checkout
at ``--parent`` as it is (``scripts/_variants.py``).

Each process times K3 in f32, forward (``fused_mlp_fwd``) and backward
(``fused_mlp_bwd``: the kernel, the in-order sum of its partials and the
``dfeats`` fill), at four shapes: the MP-PDE ϕ on the Burgers chain (256
nodes, 1,024 edges, 282→128 swish: both streamed), 2^15 Delaunay points
with 4→128→128→128 tanh (resident forward, streamed backward), and
4→60→60→60 tanh at the VMH mesh (3,000 points) and at 2^15 points (both
resident): CUDA-event ms over 20 calls, device ms per call
(``tools.profile_paths.device_per_call``), the errors of the forward, of
``dfeats`` and of ``dW``/``db`` against the plain versions, each relative to
its largest entry, and a digest of every output's bytes. Every variant's
outputs are then compared with the first ``parent``'s, bit for bit. Prints
the ptxas lines of ``fused_mlp.cu`` (registers, stack frame and spills of
every function it compiled). The package itself is not changed.
"""
from __future__ import annotations

import hashlib
import re

from _variants import PACKAGE, copy_package, edit, main

SHAPES = ("MP-PDE phi, Burgers", "2^15 points, hidden 128", "VMH mesh",
          "2^15 points, hidden 60")


def variant(name: str):
    """The directory holding the package of variant ``name``."""
    form = re.fullmatch(r"t(\d+)-c([124])-r(\d+)-f(\d+)x(\d+)-s(\d+)",
                        name)
    if form is None:
        raise SystemExit(f"unknown variant {name!r}")
    root = copy_package("fused_mlp_variants", name)
    src = root / PACKAGE.name / "csrc" / "fused_mlp.cu"
    edit(src, r"constexpr int kChunkThreads = \d+;",
         f"constexpr int kChunkThreads = {form[1]};")
    edit(src, r"constexpr int kFwdCols = \d+;",
         f"constexpr int kFwdCols = {form[2]};")
    edit(src, r"constexpr int kResThreads = \d+;",
         f"constexpr int kResThreads = {form[3]};")
    edit(src, r"constexpr int kResFwdThreads = \d+, kResFwdBlocks = \d+;",
         f"constexpr int kResFwdThreads = {form[4]}, "
         f"kResFwdBlocks = {form[5]};")
    edit(root / PACKAGE.name / "kernels" / "fused_mlp_kernels.py",
         r"_FWD_SLOTS = \d+", f"_FWD_SLOTS = {form[6]}")
    return root


def ptxas_lines(log: str) -> list:
    """One line per function of ptxas's report ``log``: its name, then its
    registers, stack frame and spills."""
    out, name = {}, None
    for line in log.splitlines():
        for mark in ("Compiling entry function '", "Function properties for "):
            if mark in line:
                name = line.split(mark, 1)[1].split("'")[0].strip()
                out.setdefault(name, [])
        if name is not None and ("stack frame" in line or "Used" in line):
            out[name].append(line.replace("ptxas info    :", "").strip())
    return [f"{name}: {'; '.join(lines)}" for name, lines in out.items()]


def digest(tensors) -> str:
    """A digest of the bytes of ``tensors``."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def child(name: str) -> dict:
    """Times of the package on ``PYTHONPATH`` (one variant)."""
    import numpy as np
    import torch

    import neuralgraphpde_torch as P
    from neuralgraphpde_torch import kernels as K
    from neuralgraphpde_torch.examples import train_mppde_burgers as M
    from neuralgraphpde_torch.examples import train_vmh as T
    from neuralgraphpde_torch.kernels import _build
    from neuralgraphpde_torch.ops.bsr import host_edges
    from neuralgraphpde_torch.tools.profile_paths import device_per_call

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    log = _build.build_info.get("ptxas_by_source", {}).get(
        "fused_mlp.cu", _build.build_info["ptxas"])
    model, _ = M.setup(M.Config(), dev)
    vmh, _ = T.setup(T.Config(), dev)
    pts = np.random.default_rng(0).random((1 << 15, 2))
    _, r = host_edges(P.delaunay_graph(pts.astype(np.float32)))
    bench = K.build_segment_csr(np.arange(len(r)), r, 1 << 15,
                                num_cols=len(r)).to(dev)
    rng = np.random.default_rng(3)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(dev)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    out = dict(variant=name, ptxas=ptxas_lines(log), cases={})
    tanh3 = ("tanh",) * 3
    for what, csr, acts, dims in zip(SHAPES, (
            model.graph.cache["tcsr_edges"], bench,
            vmh.model.graph.cache["tcsr_edges"], bench), (
            ("swish",), tanh3, tanh3, tanh3), (
            (282, 128), (4, 128, 128, 128), (4, 60, 60, 60),
            (4, 60, 60, 60))):
        ws = [normal(a, b, scale=a ** -0.5) for a, b in zip(dims[:-1],
                                                             dims[1:])]
        bs = [normal(1, b, scale=1 / 3) for b in dims[1:]]
        feats, g = normal(csr.num_cols, dims[0]), normal(csr.num_rows,
                                                         dims[-1])

        def kernel():
            return K.fused_mlp_bwd(acts, csr, feats, ws, bs, g)

        def forward():
            return K.fused_mlp_fwd(acts, csr, feats, ws, bs)

        got, want = kernel(), K.fused_mlp_bwd_plain(acts, csr, feats, ws,
                                                    bs, g)
        fwd = forward()
        case = dict(
            variants=[K.fused_mlp_variant(dims),
                      K.fused_mlp_variant(dims, backward=True)],
            rel_dfeats=rel(got[0], want[0]),
            rel_params=max(rel(a, b) for a, b in zip(got[1] + got[2],
                                                     want[1] + want[2])),
            rel_fwd=rel(fwd, K.fused_mlp_plain(acts, csr, feats, ws, bs)),
            digest_fwd=digest([fwd]),
            digest_bwd=digest((got[0],) + got[1] + got[2]))
        for tag, fn in (("", kernel), ("fwd_", forward)):
            for _ in range(3):
                fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn()
            end.record()
            end.synchronize()
            case[tag + "ms"] = start.elapsed_time(end) / 20
            case[tag + "device_ms"], case[tag + "kernels_per_call"] = \
                device_per_call(fn)
        out["cases"][what] = case
        print(f"{name} {what} ({'/'.join(case['variants'])}): dfeats rel "
              f"{case['rel_dfeats']:.3e}, dW/db rel {case['rel_params']:.3e}"
              f", {case['ms']:.4f} ms by events, {case['device_ms']:.4f} "
              f"device ms, {case['kernels_per_call']:g} kernels a call; "
              f"forward rel {case['rel_fwd']:.3e}, {case['fwd_ms']:.4f} ms "
              f"by events, {case['fwd_device_ms']:.4f} device ms",
              flush=True)
    return out


def same_bits(result: dict) -> None:
    """Each variant's outputs against the first ``parent``'s digests."""
    runs = result["variants"]
    ref = next((v for v in runs if v["variant"] == "parent"), None)
    if ref is None:
        return
    for v in runs:
        v["same_bits_as_parent"] = {
            what: {d: case[d] == ref["cases"][what][d]
                   for d in ("digest_fwd", "digest_bwd")}
            for what, case in v["cases"].items()
            if what in ref["cases"]}
        print(f"{v['variant']} same bits as parent: "
              f"{v['same_bits_as_parent']}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main(__file__, ["t256-c2-r512-f256x4-s56",
                                     "t256-c2-r512-f256x1-s56",
                                     "t256-c2-r512-f256x3-s56",
                                     "t256-c2-r512-f512x2-s56",
                                     "t256-c2-r512-f128x4-s56",
                                     "t256-c2-r512-f256x4-s112"], variant,
                          child, parent=True, summary=same_bits))
