"""What the variant sweeps in this directory share: a copy of the package
edited into a variant, and a ``main`` that runs each variant in a process
of its own and gathers what it prints.

A sweep script gives ``main`` its default variants, a function that makes
the directory holding a variant's package (usually ``copy_package`` and
``edit``) and a ``child`` function that measures the package on
``PYTHONPATH`` and returns a JSON-able dict. With ``parent=True`` the
variant ``parent`` runs the package of the checkout at ``--parent`` as it is
(for example the parent commit, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists); name it before and after the others to
compare in turns.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "neuralgraphpde_torch"


def edit(path: Path, pattern: str, text: str) -> None:
    """Replace the one match of ``pattern`` in ``path`` by ``text``."""
    src, count = re.subn(pattern, text, path.read_text())
    if count != 1:
        raise RuntimeError(f"{path}: {count} matches of {pattern!r}")
    path.write_text(src)


def copy_package(sweep: str, name: str) -> Path:
    """A fresh copy of the package under ``build/<sweep>/<name>/``; returns
    that directory (the one to put on ``PYTHONPATH``)."""
    root = ROOT / "build" / sweep / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, root / PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def main(script: str, defaults, variant, child, parent: bool = False,
         summary=None) -> int:
    """The command line of the sweep ``script``: ``--variants``, ``--out``
    and, with ``parent``, ``--parent``. Prints the card's name and power
    limit, then each variant's lines; ``summary(result)``, where given, may
    print and add to the results before they are written as JSON to
    ``--out``."""
    p = argparse.ArgumentParser()
    p.add_argument("--variants", nargs="+", default=list(defaults))
    if parent:
        p.add_argument("--parent",
                       help="a checkout whose package is 'parent'")
    p.add_argument("--out", help="write the times here as JSON")
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        print(json.dumps(child(args.child)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = dict(card=card, variants=[])
    for name in args.variants:
        if parent and name == "parent":
            if args.parent is None:
                raise SystemExit("variant 'parent' needs --parent DIR")
            root = Path(args.parent).resolve()
        else:
            root = variant(name)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), "--child", name],
            cwd=root, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": str(root)})
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed:\n{proc.stderr}")
        result["variants"].append(json.loads(proc.stdout.splitlines()[-1]))
    if summary is not None:
        summary(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0
