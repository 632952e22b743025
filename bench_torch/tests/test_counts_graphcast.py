"""GraphCast's operation and byte counts (``core/graphcast_counts.py``)
against counts made by hand on a 4-node graph: 6 edges, latent 2."""
from bench_torch.core import graphcast_counts as gcc

N, E, L = 4, 6, 2


def test_mlp_forward_by_hand():
    # (3 → 2 → 2) on 4 rows: 2·4·3·2 + 8, 2·4·2·2 + 8, swish 8, LN 7·8
    w = gcc.mlp_forward(N, (3, 2, 2), True)
    assert w.ops == 56 + 40 + 8 + 56
    # x 12, parameters 6 + 2 + 4 + 2 + LN 4 = 18, out 8 floats
    assert w.bytes == 4 * (12 + 18 + 8)
    assert gcc.mlp_forward(N, (3, 2, 2), False).ops == 56 + 40 + 8


def test_mlp_backward_by_hand():
    # LN 11·8; layer 1 dW 48 + db 8 (no dx); layer 2 dW 32 + db 8 + dx 32;
    # swish' 2·8
    w = gcc.mlp_backward(N, (3, 2, 2), True, input_grad=False)
    assert w.ops == 88 + 56 + 72 + 16
    # cotangent 8, output 8, x 12, parameters and their gradients 2·18
    assert w.bytes == 4 * (8 + 8 + 12 + 36)
    assert gcc.mlp_backward(N, (3, 2, 2), True, True).ops == w.ops + 48


def test_interaction_forward_by_hand():
    w = gcc.interaction_forward(N, N, E, L)
    ops = (2 * 4 * 4  # W_s v_s: 2·n_s·L·L
           + 32 + 8  # W_r v_r and its bias
           + 48 + 24  # W_e e: 2·6·4, the two gathered adds
           + 12  # swish
           + 48 + 12 + 84  # second layer, its bias, LN 7·12
           + 12  # the sum onto the receivers
           + 12  # e + m
           + (64 + 8) + (32 + 8) + 8 + 56  # φ_v (4 → 2 → 2), LN
           + 8)  # v + φ_v
    assert w.ops == ops == 508
    # v_s 8, v_r 8, e 12, φ_e 24 and φ_v 20 parameters, v' 8, e' 12;
    # senders and receivers 12, row offsets 5
    assert w.bytes == 4 * (8 + 8 + 12 + 44 + 8 + 12) + 4 * (12 + 5)


def test_interaction_backward_by_hand():
    w = gcc.interaction_backward(N, N, E, L)
    ops = (312  # φ_v's backward with its input gradient
           + 8 + 12  # the residuals' adds
           + 132 + 96 + 12  # LN 11·12, second layer dW and dx, db
           + 24  # swish'
           + 96  # dW_e and de
           + 64 + 12  # dW_s, dv_s, the senders' sum
           + 64 + 12 + 8)  # dW_r, dv_r, the receivers' sum, db
    assert w.ops == ops == 852
    # cotangents 8 + 12; saved v_s, v_r, e 28; parameters and gradients
    # 2·44; gradients of v_s, v_r, e 28; the graph 17 indices
    assert w.bytes == 4 * (20 + 28 + 88 + 28) + 4 * 17


def test_embedded_edges_and_no_kept_edges():
    """Grid2Mesh and Mesh2Grid: the raw features (3 wide) embedded inside
    the call, no edge latents returned."""
    w = gcc.interaction_forward(N, N, E, L, edge_in=3, keep_edges=False)
    embed = gcc.mlp_forward(E, (3, 2, 2), True).ops
    assert embed == 84 + 60 + 12 + 84
    assert w.ops == 508 - 12 + embed
    b = gcc.interaction_backward(N, N, E, L, edge_in=3, keep_edges=False)
    assert b.ops == 852 - 12 + gcc.mlp_backward(E, (3, 2, 2), True,
                                                 False).ops


def test_weighted_mse_by_hand():
    # 4 points, 3 channels: 5·12 + 2·4 forward, 3·12 backward
    assert gcc.weighted_mse(N, 3).ops == 60 + 8 + 36
