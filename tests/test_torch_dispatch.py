"""Where the port's dispatch decisions live: the one kernel gate
(``ops.spmm.takes_kernels``) and the layering that keeps ``nn`` off the
kernel modules (the conv layers ask ``ops``)."""
import ast
import pathlib
import types

import pytest

torch = pytest.importorskip("torch")

import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.ops.spmm import takes_kernels  # noqa: E402

NN = pathlib.Path(P.__file__).resolve().parent / "nn"


def _imports(path: pathlib.Path) -> list:
    """``(module, names)`` of every import in ``path``, relative imports
    resolved against the ``nn`` package."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                base = ["neuralgraphpde_torch", "nn"][: 3 - node.level]
                mod = ".".join(base + ([mod] if mod else []))
            out.append((mod, tuple(a.name for a in node.names)))
        elif isinstance(node, ast.Import):
            out += [(a.name, ()) for a in node.names]
    return out


@pytest.mark.parametrize("name,allowed", [
    ("conv.py", ()),
    ("graphed.py", ("add_launch_counts", "launch_counts"))])
def test_nn_layers_reach_no_kernel_module(name, allowed):
    """``nn/conv.py`` imports nothing of ``kernels``; ``nn/graphed.py`` only
    the launch counters' snapshot and add."""
    for mod, names in _imports(NN / name):
        if mod.startswith("neuralgraphpde_torch.kernels"):
            assert mod == "neuralgraphpde_torch.kernels", mod
            assert set(names) <= set(allowed), names


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("mode", ["auto", "xla", "dense", "pallas", "bsr"])
def test_takes_kernels_truth_table(mode, device):
    """A forced mode takes kernels anywhere, ``auto`` on the card only, the
    library modes never; the GCN right-hand side also forces them in
    ``bsr``. Only ``x.is_cuda`` is read, so a stand-in plays the card."""
    x = types.SimpleNamespace(is_cuda=device == "cuda")
    P.set_spmm_mode(mode)
    try:
        got = (takes_kernels(x), takes_kernels(x, forced=("pallas", "bsr")))
    finally:
        P.set_spmm_mode("auto")
    on_card = mode == "auto" and device == "cuda"
    assert got == (mode == "pallas" or on_card,
                   mode in ("pallas", "bsr") or on_card)
