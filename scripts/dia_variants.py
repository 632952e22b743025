"""Times of the DIA kernels (K2) built in other forms, on one GPU: other
rows per thread, and another checkout's package.

    python scripts/dia_variants.py [--variants r4-8 r8 r4 r16 ...]
                                   [--parent DIR] [--out PATH.json]

A variant ``r<s>-<f>`` builds the kernels with ``s`` consecutive rows a
thread in the stencil kernel and ``f`` in the fused one (``kStencilRows``
and ``kFusedRows`` in ``csrc/dia_stencil.cu``; the fused form's 64-row tile
then has ``64 / f`` row groups); ``r<rows>`` sets both. The package as it
is builds ``r4-8``. For each one this copies the package under
``build/dia_variants/<variant>/``, edits the copy's source (a pattern that
does not match exactly once stops the run) and, in a process of its own,
builds that copy. The variant ``parent`` runs the package of the checkout
at ``--parent`` as it is (for example the parent commit, unpacked with
``git archive`` into a directory that ``.gitignore`` lists); name it
before and after the others to compare in turns.

Each process times, at the 512² 8-neighbour grid with self-loops and F =
128 (``chip_smoke.py``'s K2 shapes), the stencil in f32 and in bf16 and the
fused right-hand side (tanh, W 128×128, b) in f32 and in bf16, and the
fused form's unfused composition (the stencil kernel, ``torch.addmm``,
``tanh``): CUDA-event ms over 20 calls and device ms per call
(``tools.profile_paths.device_per_call``), and each kernel's error against
its plain version. Prints the ptxas lines of ``dia_stencil.cu`` with their
registers and spills. The package itself is not changed.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "neuralgraphpde_torch"


def variant(name: str, parent) -> Path:
    """The directory holding the package of variant ``name``."""
    if name == "parent":
        if parent is None:
            raise SystemExit("variant 'parent' needs --parent DIR")
        return Path(parent).resolve()
    rows = re.fullmatch(r"r(\d+)(?:-(\d+))?", name)
    if rows is None:
        raise SystemExit(f"unknown variant {name!r}")
    root = ROOT / "build" / "dia_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = root / PACKAGE.name / "csrc" / "dia_stencil.cu"
    text = cu.read_text()
    for const, value in (("kStencilRows", rows[1]),
                         ("kFusedRows", rows[2] or rows[1])):
        text, count = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
        if count != 1:
            raise RuntimeError(f"{cu}: no single match of {const}")
    cu.write_text(text)
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
    out = dict(variant=name, ptxas=ptxas, cases={})
    for what, (kernel, plain) in cases.items():
        got, want = kernel().float(), plain().float()
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


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--variants", nargs="+",
                   default=["r4-8", "r8", "r4", "r16"])
    p.add_argument("--parent", help="a checkout whose package is 'parent'")
    p.add_argument("--out", help="write the times here as JSON")
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        print(json.dumps(child(args.child)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = dict(card=card, variants=[])
    for name in args.variants:
        root = variant(name, args.parent)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", name],
            cwd=root, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": str(root)})
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed:\n{proc.stderr}")
        result["variants"].append(json.loads(proc.stdout.splitlines()[-1]))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
