"""The control, the plain reference in TF32 (the next precision down from
the configurations' true float32), comes out not correct, as does the
planted half-batch fault; at a small size, on the card where there is one
and with TF32 rounding of the products on the CPU otherwise."""
import pytest
import torch

from bench_torch import control
from bench_torch.core import compare
from bench_torch.tests import tiny

torch.set_num_threads(1)

CELLS = tiny.CELLS


def _device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny.load(name)
    dev = _device()
    for seed in (1, 2, 3):
        rec = control.readings(cell, [], [seed], dev)[0]
        assert compare.judge(rec["program"], cell.limits)[0], rec
        assert not compare.judge(rec["control"], cell.limits)[0], rec
        if "half_batch" in rec:
            assert not compare.judge(rec["half_batch"], cell.limits)[0]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.0])
    assert control._tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 3.0]
