"""The faults of ``test_faults.py`` planted where the graph kernel network's
cell produces them: half of the nodes of a Darcy sample left out of the
MSE (the mean over the rest), a step that leaves the state unchanged, and
``GNOConv``'s answer altered in every entry (a kernel's bias)."""
import pytest
import torch

import neuralgraphpde_torch as ngp
from neuralgraphpde_torch.train import losses

from bench_torch.tests import tiny
from bench_torch.tests.test_faults import _altered

torch.set_num_threads(1)

GKN = [w["name"] for w in tiny.BENCH["workloads"]
       if w["config"] == "gno-darcy" and w["name"] in tiny.TRAIN]

_ORIG_MSE = losses.mse


def _half_nodes_mse(pred, target):
    half = pred.shape[0] // 2
    return _ORIG_MSE(pred[:half], target[:half])


def test_gkn_cell_is_listed():
    assert GKN == ["gno-darcy.train"]


@pytest.mark.parametrize("name", GKN)
def test_gkn_unchanged_state_is_caught(name, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a: None)
    ok, result = tiny.run(tiny.load(name))
    assert not ok
    assert result["numbers"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", GKN)
def test_gkn_half_batch_is_caught(name, monkeypatch):
    monkeypatch.setattr(losses, "mse", _half_nodes_mse)
    ok, _ = tiny.run(tiny.load(name))
    assert not ok


@pytest.mark.parametrize("name", GKN)
def test_gkn_altered_answer_is_caught(name, monkeypatch):
    _altered(ngp.GNOConv, monkeypatch, every=True)
    ok, _ = tiny.run(tiny.load(name))
    assert not ok
