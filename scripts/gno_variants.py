"""Times of K5 built in other forms, on one GPU: other product tiles,
stages and splits, other register budgets and task widths of the per-edge
backward, other reduce tiles and blocks, and another checkout's package.

    python scripts/gno_variants.py
        [--variants m128n64r2c1k32s3p2-e3t8-u8t384b2 ...]
        [--parent DIR] [--out PATH.json]

A variant ``m<BM>n<BN>r<RG>c<CG>k<BK>s<S>p<P>-e<B>t<TR>-u<RI>t<RT>b<RB>``
builds the products (``gno_gemm_kernel`` in ``csrc/gno.cu``) with a BM × BN
output tile a block, RG × CG groups of 4 rows × 4 columns a thread and S
stages of BK-deep operand tiles, splits a product with few tiles for about
P blocks an SM (``_BLOCKS_PER_SM`` in ``kernels/gno_kernels.py``), holds the
per-edge backward's registers to B blocks an SM (``kEdgeBlocks``) with
tasks of at most TR edges (``kMaxTR``: 1, 2, 4 or 8), and builds the reduce
(``gno_reduce_kernel``) with RI × 4 tiles of S a thread (``kRI``: 4, 8 or
16), at most RT threads a block (``kRedThreads``, a multiple of 32) and
its registers held to RB blocks an SM (``kRedBlocks``). The package as it
is builds ``m128n64r2c1k32s3p2-e3t8-u8t384b2``. For each one this copies
the package under ``build/gno_variants/<variant>/``, edits the copy (a
pattern that does not match exactly once stops the run) and, in a process
of its own, builds that copy. The variant ``parent`` runs the package of
the checkout at ``--parent`` as it is (``scripts/_variants.py``).

Each process times K5 in f32, K 128, IN = OUT = 64, with a bias, at the GNO
Darcy 32² graph (``train_gno_darcy``'s: 1,024 nodes, 19,092 edges) and at
the 64² grid (4,096 nodes, 335,480 edges): forward and backward by CUDA
events over 20 calls, device ms a call split by launch
(``split``, which runs on a parent checkout too), the reduce's device ms
(``gno_reduce_kernel``, in the forward and again in the backward), the
products' TFLOP/s where the kernel names tell the three apart (2 · rows ·
columns · IN · (K + 1) useful operations over the product's device time:
S·Wl', g·Wl'ᵀ, Sᵀ·g), the max relative error of out, dph, dh, dWl and dbl
against the plain versions (``max|k − p| / max|p|``) and a digest of each
output's bytes (the outputs of calls under
``torch.use_deterministic_algorithms``, so that dh's ``index_add_`` sums
in a fixed order). Every
variant's digests are compared with the first ``parent``'s: K5's sums move
with the products' tiles and splits (not with the reduce's tiles, whose
every entry keeps its slot order), so the errors against the plain
versions are what holds a variant. Prints the ptxas lines of ``gno.cu``.
"""
from __future__ import annotations

import hashlib
import re

from _variants import PACKAGE, copy_package, edit, main

SHAPES = ("Darcy 32²", "Darcy 64²")
# the products' kernel names by template arguments (A along k, B along k)
PRODUCTS = {"S.Wl'": "gno_gemm_kernel<true, false",
            "g.Wl'^T": "gno_gemm_kernel<true, true",
            "S^T.g": "gno_gemm_kernel<false, false"}


def variant(name: str):
    """The directory holding the package of variant ``name``."""
    form = re.fullmatch(r"m(\d+)n(\d+)r(\d+)c(\d+)k(\d+)s(\d+)p(\d+)"
                        r"-e(\d+)t([1248])-u(4|8|16)t(\d+)b(\d+)", name)
    if form is None:
        raise SystemExit(f"unknown variant {name!r}")
    (bm, bn, rg, cg, bk, st, per_sm, blocks, tr, ri, red_threads,
     red_blocks) = form.groups()
    root = copy_package("gno_variants", name)
    src = root / PACKAGE.name / "csrc" / "gno.cu"
    edit(src, r"constexpr int kBM = \d+, kBN = \d+, kRG = \d+, kCG = \d+;",
         f"constexpr int kBM = {bm}, kBN = {bn}, kRG = {rg}, kCG = {cg};")
    edit(src, r"constexpr int kBK = \d+, kStages = \d+;",
         f"constexpr int kBK = {bk}, kStages = {st};")
    edit(src, r"constexpr int kEdgeThreads = 256, kEdgeBlocks = \d+;",
         f"constexpr int kEdgeThreads = 256, kEdgeBlocks = {blocks};")
    edit(src, r"constexpr int kMaxTR = \d+;", f"constexpr int kMaxTR = {tr};")
    edit(src, r"constexpr int kRI = \d+, kRedThreads = \d+, kRedBlocks = \d+;",
         f"constexpr int kRI = {ri}, kRedThreads = {red_threads}, "
         f"kRedBlocks = {red_blocks};")
    py = root / PACKAGE.name / "kernels" / "gno_kernels.py"
    edit(py, r"_TILE_M = \d+", f"_TILE_M = {bm}")
    edit(py, r"_TILE_N = \d+", f"_TILE_N = {bn}")
    edit(py, r"_BLOCKS_PER_SM = \d+", f"_BLOCKS_PER_SM = {per_sm}")
    return root


def split(fn, reps: int = 20) -> dict:
    """Device ms a call of ``fn`` by kernel name, after 3 warm-up calls."""
    from collections import defaultdict

    from neuralgraphpde_torch.tools.profile_paths import profile

    for _ in range(3):
        fn()
    by_name = defaultdict(float)
    for name, _, dur, _ in profile(fn, reps)[0]:
        by_name[name[:90]] += dur / 1e3 / reps
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1]))


def digest(t) -> str:
    """A digest of the bytes of tensor ``t``."""
    import torch

    return hashlib.sha256(t.detach().contiguous().cpu().view(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest()[:16]


def child(name: str) -> dict:
    """Times of the package on ``PYTHONPATH`` (one variant)."""
    import numpy as np
    import torch

    import neuralgraphpde_torch as P
    from neuralgraphpde_torch import kernels as K
    from neuralgraphpde_torch.examples import train_gno_darcy as G
    from neuralgraphpde_torch.kernels import _build

    from fused_mlp_variants import ptxas_lines

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    log = _build.build_info.get("ptxas_by_source", {}).get(
        "gno.cu", _build.build_info["ptxas"])
    model, _, _ = G.setup(G.Config(), dev)
    s, r = P.darcy_dataset(num_samples=0, n=64, radius=0.08).graph.host_coo
    graphs = (
        (model.graph.cache["tcsr_edges"], model.graph.senders),
        (K.build_segment_csr(np.arange(len(r)), r, 64 * 64,
                             num_cols=len(r)).to(dev),
         torch.from_numpy(s).to(dev)))
    rng = np.random.default_rng(5)
    k, width = 128, 64

    def put(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to(dev)

    wl, bl = K.pack_last_layer(put(k, width * width, scale=k ** -0.5),
                               put(1, width * width, scale=0.1), width,
                               width)
    out = dict(variant=name, ptxas=ptxas_lines(log), cases={})
    for what, (csr, senders) in zip(SHAPES, graphs):
        n = csr.num_rows
        ph, h, g = put(csr.num_cols, k), put(n, width), put(n, width)

        def forward():
            return K.fused_gno_fwd(csr, senders, ph, h, wl, bl)

        def backward():
            return K.fused_gno_bwd(csr, senders, ph, h, wl, bl, g)

        # dh's per-edge rows go onto the senders by index_add_, whose
        # atomics change its bits from call to call unless PyTorch takes its
        # deterministic path
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            got = (forward(),) + backward()
        finally:
            torch.use_deterministic_algorithms(False)
        with torch.no_grad():
            want = (K.fused_gno_plain(csr, senders, ph, h, wl, bl),)
        want += K.fused_gno_bwd_plain(csr, senders, ph, h, wl, bl, g)
        names = ("out", "dph", "dh", "dWl", "dbl")
        case = dict(
            rel={a: float((x - y).abs().max() / y.abs().max())
                 for a, x, y in zip(names, got, want)},
            digests={a: digest(x) for a, x in zip(names, got)})
        useful = 2.0 * n * width * width * (k + 1)
        for tag, fn in (("fwd", forward), ("bwd", backward)):
            for _ in range(3):
                fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn()
            end.record()
            end.synchronize()
            by_name = split(fn)
            case[tag] = dict(ms=start.elapsed_time(end) / 20,
                             device_ms=sum(by_name.values()), split=by_name,
                             reduce_ms=sum(v for key, v in by_name.items()
                                           if "gno_reduce_kernel" in key))
            for product, mark in PRODUCTS.items():
                ms = sum(v for key, v in by_name.items() if mark in key)
                if ms > 0:
                    case[tag][f"{product} TFLOP/s"] = useful / ms / 1e9
        out["cases"][what] = case
        rates = {p: round(v, 2) for t in ("fwd", "bwd")
                 for p, v in case[t].items() if p.endswith("TFLOP/s")}
        print(f"{name} {what}: fwd {case['fwd']['ms']:.4f} ms by events, "
              f"{case['fwd']['device_ms']:.4f} device ms; bwd "
              f"{case['bwd']['ms']:.4f} ms by events, "
              f"{case['bwd']['device_ms']:.4f} device ms; reduce "
              f"{case['fwd']['reduce_ms']:.4f} / {case['bwd']['reduce_ms']:.4f}"
              f" device ms; rel "
              f"{ {a: f'{v:.2e}' for a, v in case['rel'].items()} }; "
              f"{rates}", flush=True)
        for tag in ("fwd", "bwd"):
            for key, ms in case[tag]["split"].items():
                print(f"    {tag} {ms:.4f}  {key}", flush=True)
    return out


def same_bits(result: dict) -> None:
    """Each variant's digests against the first ``parent``'s."""
    runs = result["variants"]
    ref = next((v for v in runs if v["variant"] == "parent"), None)
    if ref is None:
        return
    for v in runs:
        v["same_bits_as_parent"] = {
            what: {a: d == ref["cases"][what]["digests"][a]
                   for a, d in case["digests"].items()}
            for what, case in v["cases"].items() if what in ref["cases"]}
        print(f"{v['variant']} same bits as parent: "
              f"{v['same_bits_as_parent']}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main(__file__, ["m128n64r2c1k32s3p2-e3t8-u8t384b2",
                                     "m128n64r2c1k32s3p2-e3t8-u8t384b1",
                                     "m128n64r2c1k32s3p2-e3t8-u8t288b3",
                                     "m128n64r2c1k32s3p2-e3t8-u4t544b2",
                                     "m128n64r2c1k32s3p2-e3t8-u16t384b1"],
                          variant, child, parent=True, summary=same_bits))
