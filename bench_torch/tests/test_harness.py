"""The harness's own checks: it imports neither JAX nor the JAX package,
it prints no result without a card, and the trace reading gives a layer
its kernels by its ranges and its autograd nodes."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench_torch.core import counts
from bench_torch.core.trace import Trace, busy_us

ROOT = Path(__file__).resolve().parents[2]


def test_no_module_the_harness_loads_imports_jax():
    code = (
        "import sys; sys.path.insert(0, '.'); "
        "from bench_torch.core import cell, compare, rollout, train; "
        "import bench_torch.control; "
        "import bench_torch.tests.tiny; "
        "bench = cell.read_json(cell.ROOT / 'BENCHMARK.json'); "
        "[cell.load(w['name'], bench) for w in bench['workloads']]; "
        "[cell.load_module(cell.HERE / 'metrics' / (m['name'] + '.py')) "
        " for m in bench['per_layer']]; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'neuralgraphpde' or m.startswith('neuralgraphpde.')]; "
        "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    proc = subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload",
         "grand-grid.train", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def _ev(name, cat, tid, ts, dur, **args):
    return dict(name=name, cat=cat, tid=tid, ts=ts, dur=dur, ph="X",
                args=args)


def test_layer_time_follows_ranges_and_nodes_not_names():
    w = counts.Work(1.0, 0.0)
    # two calls: the first made nodes 11..12, the second none (no grad)
    calls = [(10, 12, w, w), (None, None, w, w)]
    ev = [
        _ev("bench.step", "user_annotation", 1, 0, 100),
        _ev("bench.conv", "user_annotation", 1, 10, 10),
        _ev("cudaLaunchKernel", "cuda_runtime", 1, 12, 1, correlation=1),
        _ev("bench.conv", "user_annotation", 1, 30, 10),
        _ev("cudaLaunchKernel", "cuda_runtime", 1, 31, 1, correlation=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 1, 50, 1, correlation=3),
        # backward of node 12 (the first call) and of node 13 (not a call)
        _ev("autograd::engine::evaluate_function: XBackward0", "cpu_op", 2,
            60, 5, **{"Sequence number": 12}),
        _ev("cudaLaunchKernel", "cuda_runtime", 2, 61, 1, correlation=4),
        _ev("autograd::engine::evaluate_function: YBackward0", "cpu_op", 2,
            70, 5, **{"Sequence number": 13}),
        _ev("cudaLaunchKernel", "cuda_runtime", 2, 71, 1, correlation=5),
    ] + [_ev(f"k{i}", "kernel", 7, 10 * i + 40, i, correlation=i)
         for i in range(1, 6)]
    tr = Trace(ev, reps=1)
    device_s, bound_s, n_calls, n_bwd = tr.layer_device_s(calls)
    assert device_s == pytest.approx((1 + 2 + 4) / 1e6)
    assert (n_calls, n_bwd) == (2, 1)
    assert bound_s == pytest.approx(3 / 67e12)
    assert tr.busy_s() == pytest.approx((1 + 2 + 3 + 4 + 5) / 1e6)


def test_idle_gaps_go_to_the_innermost_latest_host_op():
    ev = [
        _ev("bench.step", "user_annotation", 1, 0, 100),
        _ev("aten::item", "cpu_op", 1, 10, 20),
        _ev("evaluate_function: X", "cpu_op", 2, 50, 30),
        _ev("aten::mm", "cpu_op", 2, 55, 10),
        _ev("k", "kernel", 7, 0, 10, correlation=1),
        _ev("k", "kernel", 7, 30, 20, correlation=2),
    ]
    gaps = dict(Trace(ev, reps=2).idle_gaps())
    # gaps: 10-30 (aten::item), 50-100 (mid 75: evaluate_function)
    assert gaps == pytest.approx({"aten::item": 10e-6,
                                  "evaluate_function: X": 25e-6})


def test_busy_is_the_union_of_intervals():
    assert busy_us([(0, 10), (5, 10), (20, 5)]) == 20


def test_benchmark_file_names_what_the_harness_finds():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = ROOT / "bench_torch"
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
        assert (here / "configs" / f"{c['name']}.py").exists()
        assert (here / "reference" / f"{c['name']}.py").exists()
    for w in bench["workloads"]:
        assert (here / "traffic" / f"{w['traffic']}.json").exists()
        assert (here / "workloads" / f"{w['name']}.json").exists()
    for m in bench["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").exists()
