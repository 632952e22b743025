"""GenCast's attention counts (``core/gencast_counts.py``) against counts
made by hand on a 4-node path, 0 – 1 – 2 – 3, at one hop: 10 pairs (each
node and its neighbours: 2 + 3 + 3 + 2), one head of width 2."""
from bench_torch.core import gencast_counts as gnc
from bench_torch.core import graphcast_counts as gcc

PAIRS, N, H, D = 10, 4, 1, 2


def test_attention_forward_by_hand():
    w = gnc.attention_forward(PAIRS, N, H, D)
    # a pair: q·k 4, scale 1, max 1, exp of the difference 2, sum 1, p·v 4
    # = 13; a node: the division 2 and the log-sum-exp 2
    assert w.ops == 13 * 10 + 4 * 4 == 146
    # q, k, v in and o out, 8 floats each; the log-sum-exp 4
    assert w.bytes == 4 * (32 + 4)


def test_attention_backward_by_hand():
    w = gnc.attention_backward(PAIRS, N, H, D)
    # a pair: dV 4, dp 4, ds 2, dQ 4, dK 4 = 18; a node: δ = dO·O 4 and
    # the two scales 4
    assert w.ops == 18 * 10 + 8 * 4 == 212
    # q, k, v, o, dO in and dq, dk, dv out, 8 floats each; the lse 4
    assert w.bytes == 4 * (64 + 4)


def test_block_counts_by_hand():
    # latent 2, ffw 4, one head on the 4-node path
    f = gnc.block_forward(PAIRS, N, 2, 1, 4)
    ln = 2 * 7 * 8  # two conditional LayerNorms
    dense = 4 * (2 * 4 * 2 * 2 + 8)  # Q, K, V and the projection
    ffw = gcc.mlp_forward(N, (2, 4, 2), False).ops
    assert ffw == (64 + 16) + (64 + 8) + 16
    assert f.ops == ln + dense + 146 + ffw + 16
    b = gnc.block_backward(PAIRS, N, 2, 1, 4)
    assert b.ops == (2 * 11 * 8 + 4 * (4 * 4 * 2 * 2 + 8) + 16 + 212
                     + gcc.mlp_backward(N, (2, 4, 2), False, True).ops + 16)
