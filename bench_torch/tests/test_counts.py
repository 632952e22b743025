"""The operation and byte counts against counts made by hand on a 4-node
graph."""
import pytest

from bench_torch.core import counts
from bench_torch.core.peaks import bound_s

# a 4-node path 0-1-2-3, both directions, with self-loops: 6 + 4 = 10
# nonzeros
N, NNZ = 4, 10


def test_gcn_forward_by_hand():
    # fin = fout = 2: SpMM 2·10·2 = 40, W 2·4·2·2 = 32, bias 8, act 8
    w = counts.gcn_forward(N, NNZ, 2, 2)
    assert w.ops == 40 + 32 + 8 + 8
    # x 8, W 4, b 2, out 8 floats; CSR 5 offsets + 10 columns + 10 values
    assert w.bytes == 4 * (8 + 4 + 2 + 8) + 4 * (5 + 10 + 10)


def test_gcn_forward_multiplies_first_when_narrower():
    # fin 3, fout 1: the SpMM runs at width 1
    w = counts.gcn_forward(N, NNZ, 3, 1)
    assert w.ops == 2 * 10 * 1 + 2 * 4 * 3 * 1 + 4 + 4


@pytest.mark.parametrize("input_grad", [True, False])
def test_gcn_backward_by_hand(input_grad):
    # act' 2·8, db 8, h = Âᵀg 40, dW 32, dx 32 when needed
    w = counts.gcn_backward(N, NNZ, 2, 2, input_grad)
    assert w.ops == 16 + 8 + 40 + 32 + (32 if input_grad else 0)
    # gy 8, out 8, x 8, W 4, dW 4, db 2 (+ dx 8); the same CSR
    floats = 8 + 8 + 8 + 4 + 4 + 2 + (8 if input_grad else 0)
    assert w.bytes == 4 * floats + 4 * 25


def test_vmh_forward_by_hand():
    # ϕ 4→3→2 (hidden 3, message 2), γ 3→3→1, state 1, pos 2; 6 edges
    e = 6
    w = counts.vmh_forward(N, e, 1, 2, (4, 3, 2), (3, 3, 1))
    feats = e * 3
    hidden = e * (2 * 4 * 3 + 3 + 3)  # product, bias, tanh
    reduce = e * 3 + N * 3  # sum of the penultimate, the mean's division
    last = N * (2 * 3 * 2 + 2)  # the linear last layer per node
    gamma = N * (2 * 3 * 3 + 3 + 3) + N * (2 * 3 * 1 + 1)
    assert w.ops == feats + hidden + reduce + last + gamma
    params = (4 * 3 + 3 + 3 * 2 + 2) + (3 * 3 + 3 + 3 * 1 + 1)
    # u 4, pos 8, out 4, params; receiver CSR: 5 offsets, 6 senders
    assert w.bytes == 4 * (4 + 8 + 4 + params) + 4 * (5 + 6)


def test_vmh_backward_by_hand():
    e = 6
    w = counts.vmh_backward(N, e, 1, 2, (4, 3, 2), (3, 3, 1))
    prods = 2 * (e * 2 * 4 * 3 + N * 2 * 3 * 2
                 + N * (2 * 3 * 3 + 2 * 3 * 1))
    acts = 2 * (e * 3 + N * 3)
    biases = e * 3 + N * (2 + 3 + 1)
    assert w.ops == prods + acts + biases + e * 3 + e * 3
    params = (4 * 3 + 3 + 3 * 2 + 2) + (3 * 3 + 3 + 3 * 1 + 1)
    assert w.bytes == 4 * (4 + 4 + 8 + params + 4 + params) + 4 * (5 + 6)


def test_dense_and_loss_by_hand():
    assert counts.dense_forward(N, 2, 3).ops == 2 * 4 * 2 * 3 + 12
    assert counts.dense_backward(N, 2, 3, True).ops == 48 + 12 + 48
    assert counts.softmax_cross_entropy(N, 3).ops == 8 * 12


def test_bound_takes_the_slower_resource():
    assert bound_s(67e12, 0) == pytest.approx(1.0)
    assert bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert bound_s(67e12, 6.7e12) == pytest.approx(2.0)
