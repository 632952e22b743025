"""Every cell end to end on the CPU at a small size: set-up, the window,
a traced run, and the comparison with the plain reference, which the
port's plain path passes."""
import pytest
import torch

from bench_torch.tests import tiny

torch.set_num_threads(1)

CELLS = tiny.CELLS


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    cell = tiny.load(name)
    ok, result = tiny.run(cell, trace=True)
    assert ok, result["numbers"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in cell.per_layer}
    # no device here: the device-trace metrics find nothing to read
    assert set(result["metrics"]) <= names
    assert "dispatch.precompute_s" in result["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_reports_its_end_to_end_metrics(name):
    cell = tiny.load(name)
    _, result = tiny.run(cell, seed=5, trace=False, seconds=0.2)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())


def test_same_seed_same_inputs_and_weights():
    cell = tiny.load(next(c for c in tiny.TRAIN if c.startswith("grand")))
    mod, cfg = cell.program, cell.config
    a = mod.make_data(cfg, cell.traffic, 2 ** 31 + 7, tiny.CPU)
    b = mod.make_data(cfg, cell.traffic, 2 ** 31 + 7, tiny.CPU)
    c = mod.make_data(cfg, cell.traffic, 2 ** 31 + 8, tiny.CPU)
    assert (a["senders"] == b["senders"]).all()
    assert (a["receivers"] == b["receivers"]).all()
    assert torch.equal(a["x"], b["x"]) and torch.equal(a["mask"], b["mask"])
    assert not torch.equal(a["x"], c["x"])
    assert int(a["mask"].sum()) == int(c["mask"].sum())


@pytest.mark.parametrize("name", tiny.TRAIN)
def test_episode_restores_the_step_object(name):
    """Between episodes the window puts the same step object back in the
    state the window started from, parameters and optimizer state."""
    from bench_torch.core import train
    from bench_torch.core.cell import draw_weights

    cell = tiny.load(name)
    mod, cfg = cell.program, cell.config
    data = mod.make_data(cfg, cell.traffic, 3, tiny.CPU)
    prog = mod.train_program(cfg, data, tiny.CPU, draw_weights(
        mod.weight_spec(cfg, data), 3, tiny.CPU))
    prog.step()
    start = train._state(prog)
    loss_a, _ = prog.step()
    prog.step()
    train._restore(prog, start)
    again = train._state(prog)
    for k in start["params"]:
        assert torch.equal(start["params"][k], again["params"][k])
        for name_, v in start["opt"][k].items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(again["opt"][k][name_]))
    loss_b, _ = prog.step()
    assert float(loss_a) == float(loss_b)
