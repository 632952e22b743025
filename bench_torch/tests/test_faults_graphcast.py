"""The faults of ``test_faults.py`` planted where GraphCast's cell produces
them: half of the grid left out of the weighted MSE (the mean over the
rest), a step that leaves the state unchanged, and ``InteractionConv``'s
receiver latents altered in every entry (a kernel's bias)."""
import pytest
import torch

import neuralgraphpde_torch as ngp
from neuralgraphpde_torch.train import losses

from bench_torch.tests import tiny

torch.set_num_threads(1)

GRAPHCAST = [w["name"] for w in tiny.BENCH["workloads"]
             if w["config"] == "graphcast-0p25" and w["name"] in tiny.TRAIN]

_ORIG_LOSS = losses.weighted_mse


def _half_grid_loss(pred, target, node_weight, channel_weight):
    half = pred.shape[0] // 2
    return _ORIG_LOSS(pred[:half], target[:half], node_weight[:half],
                      channel_weight)


def _biased(monkeypatch, share: float = 1e-3):
    forward = ngp.InteractionConv.forward

    def altered(self, v_s, v_r, e):
        out = forward(self, v_s, v_r, e)
        bump = share * out.nodes.detach().abs().amax()
        return out._replace(nodes=out.nodes + bump)

    monkeypatch.setattr(ngp.InteractionConv, "forward", altered)


@pytest.fixture(autouse=True)
def _adamw_steps(monkeypatch):
    """Each case starts from AdamW's own update. ``torch.optim`` wraps a
    class's ``step`` once, at the class's first optimizer, and keeps the
    wrapper on that class: an AdamW made while another test had a no-op
    planted on ``Adam.step`` (``test_faults.py``'s unchanged state) keeps
    the no-op after that test restores ``Adam``, and every later run would
    come out not correct whatever this file plants."""
    if "step" in vars(torch.optim.AdamW):
        monkeypatch.delattr(torch.optim.AdamW, "step")


def test_graphcast_cell_is_listed():
    assert GRAPHCAST == ["graphcast.train"]


@pytest.mark.parametrize("name", GRAPHCAST)
def test_graphcast_unchanged_state_is_caught(name, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a: None)
    ok, result = tiny.run(tiny.load(name))
    assert not ok
    assert result["numbers"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", GRAPHCAST)
def test_graphcast_half_grid_is_caught(name, monkeypatch):
    monkeypatch.setattr(losses, "weighted_mse", _half_grid_loss)
    ok, _ = tiny.run(tiny.load(name))
    assert not ok


@pytest.mark.parametrize("name", GRAPHCAST)
def test_graphcast_altered_answer_is_caught(name, monkeypatch):
    _biased(monkeypatch)
    ok, _ = tiny.run(tiny.load(name))
    assert not ok
