"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Importing this package builds nothing: the library is compiled at
the first kernel launch (``kernels._build``)."""
from .dia_kernels import dia_gcn_rhs, dia_rhs_plain, dia_spmm_stencil
from .segment_kernels import (SegmentCSR, build_segment_csr, segment_spmm,
                              segment_spmm_plain)

# every kernel wrapper, each counting its launches in ``.launches``
KERNELS = (segment_spmm, dia_spmm_stencil, dia_gcn_rhs)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = [
    "dia_gcn_rhs", "dia_rhs_plain", "dia_spmm_stencil", "SegmentCSR",
    "build_segment_csr", "segment_spmm", "segment_spmm_plain", "KERNELS",
    "reset_launch_counts",
]
