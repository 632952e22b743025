"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates) and the least time a piece of work can take on it.

The configurations here are true float32 (TF32 off), so the operation peak
is the f32 rate outside the tensor cores. The rates assume the full 700 W
power limit; the run records the card's limit beside every number."""
from __future__ import annotations

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, n_bytes: float) -> float:
    """Seconds at least: the larger of ``ops`` operations (a multiply-add
    is two) at the f32 rate and ``n_bytes`` (each input read once, each
    output written once) at HBM's rate."""
    return max(ops / F32_FLOP_PER_S, n_bytes / HBM_BYTES_PER_S)
