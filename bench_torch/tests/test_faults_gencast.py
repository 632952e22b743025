"""The faults of ``test_faults.py`` planted where GenCast's cell produces
them: half of the grid left out of the weighted MSE under the EDM weight
(the mean over the rest), a step that leaves the state unchanged, and
``MeshAttention``'s output altered in every entry (a kernel's bias), in
its forward and in its recomputation alike."""
import pytest
import torch

import neuralgraphpde_torch as ngp
from neuralgraphpde_torch.train import losses

from bench_torch.tests import tiny

torch.set_num_threads(1)

GENCAST = [w["name"] for w in tiny.BENCH["workloads"]
           if w["config"] == "gencast-0p25" and w["name"] in tiny.TRAIN]

_ORIG_LOSS = losses.weighted_mse


def _half_grid_loss(pred, target, node_weight, channel_weight):
    half = pred.shape[0] // 2
    return _ORIG_LOSS(pred[:half], target[:half], node_weight[:half],
                      channel_weight)


def _biased(monkeypatch, share: float = 1e-3):
    attend = ngp.MeshAttention.attend

    def altered(self, q, k, v):
        out = attend(self, q, k, v)
        return out + share * out.detach().abs().amax()

    monkeypatch.setattr(ngp.MeshAttention, "attend", altered)


@pytest.fixture(autouse=True)
def _adamw_steps(monkeypatch):
    """Each case starts from AdamW's own update (``test_faults_graphcast.
    py`` says why)."""
    if "step" in vars(torch.optim.AdamW):
        monkeypatch.delattr(torch.optim.AdamW, "step")


def test_gencast_cell_is_listed():
    assert GENCAST == ["gencast.train"]


@pytest.mark.parametrize("name", GENCAST)
def test_gencast_unchanged_state_is_caught(name, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a: None)
    ok, result = tiny.run(tiny.load(name))
    assert not ok
    assert result["numbers"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", GENCAST)
def test_gencast_half_grid_is_caught(name, monkeypatch):
    monkeypatch.setattr(losses, "weighted_mse", _half_grid_loss)
    ok, _ = tiny.run(tiny.load(name))
    assert not ok


@pytest.mark.parametrize("name", GENCAST)
def test_gencast_altered_answer_is_caught(name, monkeypatch):
    _biased(monkeypatch)
    ok, _ = tiny.run(tiny.load(name))
    assert not ok
