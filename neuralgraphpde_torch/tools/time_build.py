"""Time the CUDA kernel build two ways, from nothing built.

    python -m neuralgraphpde_torch.tools.time_build [--rounds N]

``parallel`` is ``kernels._build.library()``: one ``nvcc -c`` per source,
all started together, then a link. ``serial`` is one ``nvcc -shared`` over
every source with the same flags. Rounds alternate serial, parallel,
parallel, serial so that a drift in the machine's load falls on both. Each
build goes to a fresh directory under ``build/`` that is removed after.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import time

from ..kernels import _build


def serial_build(out_dir) -> float:
    out_dir.mkdir(parents=True)
    sources = [str(p) for p in sorted(_build.CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out_dir / "lib.so"), *sources], check=True,
                   capture_output=True)
    return time.perf_counter() - t0


def parallel_build(out_dir) -> float:
    _build.BUILD_DIR, _build._lib = out_dir, None
    t0 = time.perf_counter()
    _build.library()
    return time.perf_counter() - t0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=1,
                   help="serial-parallel-parallel-serial rounds")
    args = p.parse_args()
    root = _build.BUILD_DIR.parent / "build_timing"
    shutil.rmtree(root, ignore_errors=True)
    times = {"serial": [], "parallel": []}
    build = {"serial": serial_build, "parallel": parallel_build}
    try:
        for i in range(args.rounds):
            for j, how in enumerate(("serial", "parallel", "parallel",
                                     "serial")):
                seconds = build[how](root / f"{i}_{j}_{how}")
                times[how].append(seconds)
                print(f"{how:<8} {seconds:.2f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    print(f"{len(sources)} sources {sources}: serial "
          f"{min(times['serial']):.2f}-{max(times['serial']):.2f} s, "
          f"parallel {min(times['parallel']):.2f}-"
          f"{max(times['parallel']):.2f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
