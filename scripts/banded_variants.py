"""Device time of the block-band kernels (K4, K7) built in other forms, on
one GPU: other sub-tile heights, and the sub-tile walk without its
non-finite check.

    python scripts/banded_variants.py [--variants r64 r32 r16 r32-noscan]
                                      [--out PATH.json]

A variant ``r<rows>`` builds the kernel for ``rows``-row sub-tiles:
``SUBTILE_ROWS`` in ``ops/bsr.py`` and ``kR`` in ``csrc/banded.cu`` (its
blocks have ``4·kR`` threads). The suffix ``-noscan`` also drops the check
of each copied x chunk for an inf or NaN (the loop that skips zero products
is then never taken; the barrier stays), to time what that check costs.

For each variant this copies the package under
``build/banded_variants/<variant>/``, edits the copy's sources (a pattern
that does not match exactly once stops the run), and in a process of its
own builds that copy and times, by device time
(``tools.profile_paths.per_calls``), the SpMM, the fused right-hand side
(tanh, W 128×128, b) and the SpMM on bf16 storage at F = 128 on the meshes
``chip_smoke.py`` uses: K4 on the 2^17-point and K7 on the 12,000-point
scrambled Delaunay mesh after ``precompute(add_self_loops=True,
dense=False, auto_reorder=True)``. Each also prints its occupied sub-tiles
and its error against the plain version. The package itself is not
changed.
"""
from __future__ import annotations

import dataclasses
import re

from _variants import PACKAGE, copy_package, edit, main

MESHES = (1 << 17, 12000)
NO_SCAN = ("__syncthreads_or(copied_nonfinite<T>(cur + Smem<T>::kA))",
           "(__syncthreads(), false)")


def variant(name: str):
    """A copy of the package built as variant ``name``; returns the
    directory that holds it."""
    rows, _, suffix = name.partition("-")
    if not re.fullmatch(r"r\d+", rows) or suffix not in ("", "noscan"):
        raise SystemExit(f"unknown variant {name!r}")
    root = copy_package("banded_variants", name)
    cu, bsr = (root / PACKAGE.name / "csrc" / "banded.cu",
               root / PACKAGE.name / "ops" / "bsr.py")
    edit(cu, r"constexpr int kR = \d+;", f"constexpr int kR = {rows[1:]};")
    edit(bsr, r"SUBTILE_ROWS, SUBTILE_COLS = \d+,",
         f"SUBTILE_ROWS, SUBTILE_COLS = {rows[1:]},")
    if suffix == "noscan":
        edit(cu, re.escape(NO_SCAN[0]), NO_SCAN[1])
    return root


def child(name: str) -> dict:
    """Times of the package on ``PYTHONPATH`` (one variant)."""
    import numpy as np
    import torch

    import neuralgraphpde_torch as P
    from neuralgraphpde_torch import kernels as K
    from neuralgraphpde_torch.kernels import _build
    from neuralgraphpde_torch.ops.bsr import SUBTILE_ROWS
    from neuralgraphpde_torch.tools.profile_paths import per_calls

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    out = dict(variant=name, rows=SUBTILE_ROWS, meshes={})
    for points in MESHES:
        pts = np.random.default_rng(0).random((points, 2)).astype(np.float32)
        g = P.precompute(P.delaunay_graph(pts), add_self_loops=True,
                         dense=False, auto_reorder=True).to(dev)
        kind = "pbanded" if "pbanded" in g.cache else "banded"
        st, nrm = g.cache[kind], g.cache[kind + "_norm"]
        spmm = (K.pbanded_spmm_pallas if kind == "pbanded"
                else K.banded_spmm_pallas)
        rhs = K.pbanded_gcn_rhs if kind == "pbanded" else K.banded_gcn_rhs
        rng = np.random.default_rng(7)

        def put(*shape, scale=1.0):
            return torch.from_numpy((rng.normal(size=shape) * scale).astype(
                np.float32)).to(dev)

        x, w, b = put(st.num_nodes, 128), put(128, 128, scale=128 ** -0.5), \
            put(1, 128, scale=0.1)
        field = "blocks" if kind == "pbanded" else "bands"
        st16 = dataclasses.replace(st, **{field: st.blocks.to(torch.bfloat16)})
        xb = x.to(torch.bfloat16)
        head = f"{name} {kind} {points}"
        out["meshes"][f"{kind} {points}"] = dict(
            occupied=st.tiles.ent.numel(),
            rel_spmm=rel(spmm(x, st), K.block_rhs_plain(st, x, None, None,
                                                        None, False)),
            rel_rhs=rel(rhs("tanh", x, w, b, nrm), K.block_rhs_plain(
                nrm, x, w, b, "tanh", True)),
            times=per_calls(head, {
                "spmm": lambda: spmm(x, st),
                "rhs": lambda: rhs("tanh", x, w, b, nrm),
                "spmm_bf16": lambda: spmm(xb, st16)}))
        print(f"{head}: occupied {st.tiles.ent.numel()}", flush=True)
        del g, st, nrm, st16
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    raise SystemExit(main(__file__, ["r64", "r32", "r16", "r32-noscan"],
                          variant, child))
