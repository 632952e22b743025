"""Build and load the port's CUDA kernels.

Every ``neuralgraphpde_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, then
linked into one shared library with a plain C interface under
``build/torch_kernels/`` at the repository root, and loaded with ``ctypes``.
The build runs at first use; the library's file name carries a hash of the
sources and flags, so an edited source is rebuilt. Nothing here runs at
import time.

No ``--use_fast_math``: ``tanhf``, ``expf`` and division stay exact.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)  # a host array of ints
_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers
_DP = ctypes.POINTER(ctypes.c_double)  # a host array of doubles
_D = ctypes.c_double
_LL = ctypes.c_longlong
# C entry point -> argument types; every one returns a cudaError_t as int
_SIGNATURES = {
    "ngpde_segment_spmm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "ngpde_segment_max": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "ngpde_dia_stencil": (_P, _P, _I, _IP, _I, _P, _P, _P, _I, _I, _I, _I,
                          _I, _P),
    "ngpde_dia_gcn_rhs": (_P, _P, _I, _IP, _I, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _I, _P),
    "ngpde_dia_gcn_bwd": (_P, _P, _I, _IP, _I, _P, _P, _P, _P, _P, _P, _P,
                          _P, _I, _I, _I, _I, _I, _I, _P),
    "ngpde_dia_gcn_bwd_blocks": (_I, _I, _I, _I, _I, _I, _I, _IP),
    "ngpde_fused_mlp_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                            _P, _I, _I, _P),
    "ngpde_fused_mlp_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _P, _P, _P, _P, _I, _I, _P),
    "ngpde_fused_mlp_variant": (_I, _P, _I),
    "ngpde_gno_fwd": (_P,) * 10 + (_I,) * 9 + (_P,),
    "ngpde_gno_bwd": (_P,) * 14 + (_I,) * 9 + (_P,),
    "ngpde_gno_plan": (_I, _I, _I, _I, _IP),
    "ngpde_block_spmm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I,
                         _P, _P, _I, _I, _P),
    "ngpde_block_gcn_rhs": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                            _P, _P, _I, _I, _I, _I, _I, _P),
    "ngpde_rk_combine": (_PP, _DP, _I, _P, _D, _I, _I, _P, _LL, _I, _I, _I,
                         _P),
    "ngpde_rk_combine_dh": (_PP, _DP, _I, _P, _P, _I, _P, _LL, _I, _I, _I,
                            _P),
    "ngpde_rk_norm": (_PP, _DP, _I, _D, _I, _I, _P, _P, _D, _D, _P, _P, _LL,
                      _I, _I, _I, _P),
    "ngpde_rk_norm_dh": (_PP, _DP, _I, _P, _I, _P, _P, _D, _D, _P, _P, _LL,
                         _I, _I, _I, _P),
    "ngpde_rk_scatter": (_PP, _I, _PP, _DP, _IP, _I, _D, _LL, _I, _I, _I,
                         _P),
    "ngpde_mesh_attention_fwd": (_P,) * 8 + (_I,) * 4 + (_D, _P),
    "ngpde_mesh_attention_bwd": (_P,) * 12 + (_I,) * 4 + (_D, _P),
}

_lib = None
# what the last build did: seconds, library path, nvcc's -Xptxas -v report
# (also by source; kept beside the library, so a cached one has it too)
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    path = home / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sources:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so = BUILD_DIR / f"libngpde_torch_{digest.hexdigest()[:16]}.so"
    report = so.with_suffix(".ptxas.json")  # nvcc's report, by source
    t0 = time.perf_counter()
    built = not so.exists()
    if built:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objs, procs = [], []
        for src in (p for p in sources if p.suffix == ".cu"):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        tmp = so.with_name(f"{tag}.tmp")
        try:
            outs = [proc.communicate()[0] for proc in procs]
            failed = [(proc.returncode, out) for proc, out in zip(procs, outs)
                      if proc.returncode != 0]
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(
                    f"({code})\n{out}" for code, out in failed))
            proc = subprocess.run(
                [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
        finally:
            for obj in objs:  # a failed build leaves no objects behind
                obj.unlink(missing_ok=True)
        by_source = {src.name: out for src, out in zip(
            (p for p in sources if p.suffix == ".cu"), outs)}
        tmp_report = report.with_name(f"{tag}.json")
        tmp_report.write_text(json.dumps(by_source))
        os.replace(tmp_report, report)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ngpde_error_string.argtypes = (ctypes.c_int,)
    lib.ngpde_error_string.restype = ctypes.c_char_p
    by_source = (json.loads(report.read_text()) if report.exists()
                 else {})
    build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                      built=built, ptxas="".join(by_source.values()),
                      ptxas_by_source=by_source)
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().ngpde_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
