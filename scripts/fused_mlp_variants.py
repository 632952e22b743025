"""Times of K3's streamed backward built in other forms, on one GPU: other
thread counts a block, other rows a block, and another checkout's package.

    python scripts/fused_mlp_variants.py [--variants t256-s1 t128-s1 ...]
                                         [--parent DIR] [--out PATH.json]

A variant ``t<threads>-s<spread>`` builds the streamed backward with
``threads`` threads a block (``kBwdThreads`` in ``csrc/fused_mlp.cu``) and
``spread`` times the rows a block that spread the graph over one block per
SM (``rows = per_sm`` in ``_rows_rule``, ``kernels/fused_mlp_kernels.py``).
The package as it is builds ``t256-s1``. For each one this copies the
package under ``build/fused_mlp_variants/<variant>/``, edits the copy (a
pattern that does not match exactly once stops the run) and, in a process
of its own, builds that copy. The variant ``parent`` runs the package of
the checkout at ``--parent`` as it is (``scripts/_variants.py``).

Each process times the K3 backward in f32 (``fused_mlp_bwd``: the streamed
kernel and the in-order sum of its partials) at the MP-PDE ϕ on the
Burgers chain (256 nodes, 1,024 edges, 282→128 swish) and at 2^15 Delaunay
points with 4→128→128→128 tanh (``chip_smoke.py``'s shapes): CUDA-event ms
over 20 calls, device ms per call (``tools.profile_paths.device_per_call``)
and the errors of ``dfeats`` and of ``dW``/``db`` against autograd through
the plain version, each relative to its largest entry; the same times and
error for the forward (``fused_mlp_fwd``, which shares the W-tile stream
with the backward) at those shapes. Prints the ptxas
lines of ``fused_mlp.cu`` (registers, stack and spills) of the streamed
kernels. The package itself is not changed.
"""
from __future__ import annotations

import re

from _variants import PACKAGE, copy_package, edit, main


def variant(name: str):
    """The directory holding the package of variant ``name``."""
    form = re.fullmatch(r"t(\d+)-s(\d+)", name)
    if form is None:
        raise SystemExit(f"unknown variant {name!r}")
    root = copy_package("fused_mlp_variants", name)
    edit(root / PACKAGE.name / "csrc" / "fused_mlp.cu",
         r"constexpr int kBwdThreads = \d+;",
         f"constexpr int kBwdThreads = {form[1]};")
    edit(root / PACKAGE.name / "kernels" / "fused_mlp_kernels.py",
         r"rows = per_sm if backward",
         f"rows = min(n_rows, per_sm * {form[2]}) if backward")
    return root


def child(name: str) -> dict:
    """Times of the package on ``PYTHONPATH`` (one variant)."""
    import numpy as np
    import torch

    import neuralgraphpde_torch as P
    from neuralgraphpde_torch import kernels as K
    from neuralgraphpde_torch.examples import train_mppde_burgers as M
    from neuralgraphpde_torch.kernels import _build
    from neuralgraphpde_torch.ops.bsr import host_edges
    from neuralgraphpde_torch.tools.profile_paths import device_per_call

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    log = _build.build_info.get("ptxas_by_source", {}).get(
        "fused_mlp.cu", _build.build_info["ptxas"])
    ptxas, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            keep = "_stream_kernel" in line
            if keep and "Compiling" in line:
                ptxas.append(line.strip())
        elif keep and ("registers" in line or "spill" in line):
            ptxas.append(line.strip())
    model, _ = M.setup(M.Config(), dev)
    pts = np.random.default_rng(0).random((1 << 15, 2))
    _, r = host_edges(P.delaunay_graph(pts.astype(np.float32)))
    bench = K.build_segment_csr(np.arange(len(r)), r, 1 << 15,
                                num_cols=len(r)).to(dev)
    rng = np.random.default_rng(3)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(dev)

    out = dict(variant=name, ptxas=ptxas, cases={})
    for what, csr, acts, dims in (
            ("MP-PDE phi, Burgers", model.graph.cache["tcsr_edges"],
             ("swish",), (282, 128)),
            ("2^15 points, hidden 128", bench, ("tanh",) * 3,
             (4, 128, 128, 128))):
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

        def rel(a, b):
            return float((a - b).abs().max() / b.abs().max())

        rel_df = rel(got[0], want[0])
        rel_p = max(rel(a, b) for a, b in zip(got[1] + got[2],
                                              want[1] + want[2]))
        rel_fwd = rel(forward(), K.fused_mlp_plain(acts, csr, feats, ws, bs))
        case = dict(rel_dfeats=rel_df, rel_params=rel_p, rel_fwd=rel_fwd)
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
        print(f"{name} {what}: dfeats rel {rel_df:.3e}, dW/db rel "
              f"{rel_p:.3e}, {case['ms']:.4f} ms by events, "
              f"{case['device_ms']:.4f} device ms, "
              f"{case['kernels_per_call']:g} kernels a call; forward rel "
              f"{rel_fwd:.3e}, {case['fwd_ms']:.4f} ms by events, "
              f"{case['fwd_device_ms']:.4f} device ms", flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(main(__file__, ["t256-s1", "t128-s1", "t384-s1",
                                     "t256-s2", "t256-s4"], variant, child,
                          parent=True))
