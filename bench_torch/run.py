"""Run one cell of the benchmark once and print its result line.

    python3 bench_torch/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (``BENCHMARK.json``) names its configuration and traffic mix; the
run makes the inputs and weights from ``--seed`` on the card, sets up the
port (counted in ``setup_s``, from process start), measures for
``--seconds``, and with ``--trace 1`` profiles a few more steps for the
per-layer metrics. Then it frees the port's state and checks what the
timed path produced against the plain reference. The last lines on
standard error and the ``compared`` key of the result give each number
compared beside its limit; the result is the last line of standard
output. Without a CUDA card, or with fewer cards than the cell asks for,
it prints no result and exits with 2.
"""
import time

_T0 = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
# Python's bytecode is a build cache too: kept at a fixed place in the
# checkout, so that only a checkout's first run compiles the modules
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "pycache")

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402


def _process_age() -> float:
    """Seconds since this process started, at ``_T0`` (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK")
                   - (time.monotonic() - _T0))
    except (OSError, ValueError, IndexError):
        return 0.0


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    age = _process_age()
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)

    import torch

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        print("this cell needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one process, few threads: steadier host time
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from bench_torch.core import cell, compare, rollout, train

    c = cell.load(args.workload, bench)
    runner = {"train": train, "rollout": rollout}[c.traffic["task"]]
    device = torch.device("cuda", 0)
    result = runner.run(c, args.seed, args.seconds, bool(args.trace),
                        device, lambda: age + time.monotonic() - _T0)
    ok, compared = compare.judge(result["numbers"], c.limits)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": entry["chips"],
           "memory_peak_bytes": result["memory_peak_bytes"]}
    line = {"correct": ok and result["failed"] == 0,
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": result["metrics"], "device": dev}
    if args.trace:
        dev.update(busy_s=result["busy_s"], window_s=result["window_s"])
        line["breakdown"] = result["breakdown"]
    line["diagnostics"] = result["diagnostics"]
    line["card"] = _power_limit()
    line["compared"] = compared
    for name, v in compared.items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
