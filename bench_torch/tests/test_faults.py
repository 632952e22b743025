"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: a step that leaves the state
unchanged, half of the batch left out (the mean over the rest), and an
answer altered where it is produced. The cells run on one card, so no
exchange between cards can be left out."""
import pytest
import torch

import neuralgraphpde_torch as ngp
from neuralgraphpde_torch.examples import train_vmh
from neuralgraphpde_torch.train import losses

from bench_torch.tests import tiny

torch.set_num_threads(1)

TRAIN = tiny.TRAIN


def _half_mask_loss(logits, labels, mask):
    kept = mask.nonzero()[:, 0]
    half = mask.clone()
    half[kept[len(kept) // 2:]] = False
    return _ORIG_LOSS(logits, labels, half)


_ORIG_LOSS = losses.masked_cross_entropy
_ORIG_GRAD = train_vmh.full_batch_grad


def _half_sims_grad(model, u):
    return _ORIG_GRAD(model, u[: u.shape[0] // 2])


def _altered(cls, monkeypatch, every: bool, share: float = 1e-3):
    """``cls``'s output moved by ``share`` of its largest magnitude: every
    entry (a kernel's bias), or only the first."""
    forward = cls.forward

    def altered(self, x, *args, **kwargs):
        y = forward(self, x, *args, **kwargs)
        bump = torch.zeros_like(y)
        bump.view(-1)[:None if every else 1] = share * y.detach().abs().amax()
        return y + bump

    monkeypatch.setattr(cls, "forward", altered)


@pytest.mark.parametrize("name", TRAIN)
def test_unchanged_state_is_caught(name, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a: None)
    monkeypatch.setattr(ngp.Rprop, "step", lambda self, *a: None)
    ok, result = tiny.run(tiny.load(name))
    assert not ok
    assert result["numbers"]["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_is_caught(name, monkeypatch):
    monkeypatch.setattr(losses, "masked_cross_entropy", _half_mask_loss)
    monkeypatch.setattr(train_vmh, "full_batch_grad", _half_sims_grad)
    ok, _ = tiny.run(tiny.load(name))
    assert not ok


@pytest.mark.parametrize("name", TRAIN)
def test_altered_answer_is_caught(name, monkeypatch):
    _altered(ngp.GCNConv, monkeypatch, every=True)
    _altered(ngp.VMHConv, monkeypatch, every=True)
    ok, _ = tiny.run(tiny.load(name))
    assert not ok


def test_altered_rollout_is_caught(monkeypatch):
    # one entry of the trajectory off by 1% of its largest magnitude: the
    # rollout's limit (0.2%) sits above what a sound float32 rollout of the
    # trained surrogate reads in its first saves
    _altered(ngp.NeuralGraphODE, monkeypatch, every=False, share=1e-2)
    ok, _ = tiny.run(tiny.load("vmh.rollout"))
    assert not ok
