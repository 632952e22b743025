"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Importing this package builds nothing: the library is compiled at
the first kernel launch (``kernels._build``)."""
from .attention_kernels import (AttentionLayout, build_attention_layout,
                                mesh_attention, mesh_attention_plain)
from .banded_kernels import (banded_gcn_rhs, banded_spmm_pallas,
                             block_rhs_plain, pbanded_gcn_rhs,
                             pbanded_spmm_pallas)
from .dia_kernels import (dia_gcn_bwd_plain, dia_gcn_rhs, dia_rhs_plain,
                          dia_spmm_stencil)
from .fused_mlp_kernels import (fused_mlp_aggregate, fused_mlp_bwd,
                                fused_mlp_bwd_plain, fused_mlp_fwd,
                                fused_mlp_plain, fused_mlp_variant)
from .gno_kernels import (fused_gno_aggregate, fused_gno_bwd,
                          fused_gno_bwd_plain, fused_gno_fwd, fused_gno_plain,
                          gno_plan, pack_last_layer)
from .rk_kernels import rk_combine, rk_norm
from .segment_kernels import (SegmentCSR, build_segment_csr, segment_max,
                              segment_max_aggregate, segment_max_plain,
                              segment_spmm, segment_spmm_plain)

# every kernel wrapper, each counting its launches in ``.launches`` (the
# differentiable ones also count the part made in backward passes in
# ``.backward_launches``; ``dia_gcn_rhs`` the backward calls that took its
# eager composition or the CPU in ``.backward_eager``; K3, K5 and K6 count
# the launches that read a bf16
# operand in ``.bf16_launches``, K5 its reduce's passes over the rows in
# ``.reduce_passes``; ``rk_combine`` counts the RK stage
# algebra's combinations and their backward's scatters, ``rk_norm`` its
# error norms; ``mesh_attention`` the (query, key) scores its launches
# computed in ``.pairs``)
KERNELS = (segment_spmm, dia_spmm_stencil, dia_gcn_rhs, fused_mlp_fwd,
           fused_mlp_bwd, fused_gno_fwd, fused_gno_bwd, segment_max,
           banded_spmm_pallas, pbanded_spmm_pallas, banded_gcn_rhs,
           pbanded_gcn_rhs, rk_combine, rk_norm, mesh_attention)


_COUNTERS = ("launches", "backward_launches", "backward_eager",
             "bf16_launches", "reduce_passes", "pairs")


def launch_counts() -> dict:
    """Every counter of every kernel wrapper, ``{(wrapper, name): value}``."""
    return {(fn, name): getattr(fn, name) for fn in KERNELS
            for name in _COUNTERS if hasattr(fn, name)}


def add_launch_counts(counts: dict) -> None:
    """Add ``{(wrapper, name): n}`` to the wrappers' counters."""
    for (fn, name), n in counts.items():
        setattr(fn, name, getattr(fn, name) + n)


def reset_launch_counts() -> None:
    for fn, name in launch_counts():
        setattr(fn, name, 0)


__all__ = [
    "AttentionLayout", "build_attention_layout", "mesh_attention",
    "mesh_attention_plain", "banded_gcn_rhs", "banded_spmm_pallas",
    "block_rhs_plain",
    "pbanded_gcn_rhs", "pbanded_spmm_pallas",
    "dia_gcn_bwd_plain", "dia_gcn_rhs", "dia_rhs_plain", "dia_spmm_stencil",
    "fused_mlp_aggregate",
    "fused_mlp_bwd", "fused_mlp_bwd_plain", "fused_mlp_fwd",
    "fused_mlp_plain", "fused_mlp_variant", "fused_gno_aggregate", "fused_gno_bwd",
    "fused_gno_bwd_plain", "fused_gno_fwd", "fused_gno_plain", "gno_plan",
    "pack_last_layer", "rk_combine", "rk_norm", "SegmentCSR", "build_segment_csr", "segment_max",
    "segment_max_aggregate", "segment_max_plain",
    "segment_spmm", "segment_spmm_plain", "KERNELS", "launch_counts",
    "add_launch_counts", "reset_launch_counts",
]
