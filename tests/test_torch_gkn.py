"""The graph kernel network at its published shape (``GKNModel``: one
``GNOConv`` and its kernel network shared by every iteration) on the CPU,
at a small size, against the plain reference of the benchmark's
``gno-darcy`` configuration (``bench_torch/reference/gno-darcy.py``), on
the Darcy traffic generator's inputs and seeded random weights.

Tolerances and why:

- forward and losses: max|port − reference| ≤ 1e-5 of the largest value
  (float32 sums over each receiver's edges taken in another order: the
  segment reduce or K5's plain version against ``index_add_``);
- gradients: each leaf within 1e-4 of its largest entry (sums over every
  edge, and over the iterations in another order);
- three Adam steps: each step's loss within 1e-5 (relative), and each
  leaf's change within 1e-3 of its largest entry (Adam's first update is
  about ``lr · sign(g)`` where ``|g| ≫ ε``, so an entry whose gradient is
  within rounding of zero may move ±lr in opposite directions);
- the kernel network once a forward against once an iteration: the same
  output bits (the same operations on the same inputs), and φ's gradient
  within 1e-5 of its largest entry (autograd sums the iterations'
  cotangents of φ's output before its backward instead of after);
- K5's plain version at K 1,024, IN = OUT = 64 against the reference's
  per-edge matrices: 1e-5 forward, 1e-4 for the gradients (as above).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.kernels import gno_kernels as K5  # noqa: E402
from neuralgraphpde_torch.kernels.segment_kernels import \
    build_segment_csr  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench_torch.core import cell as cells  # noqa: E402
from bench_torch.core import compare, gno_counts  # noqa: E402
from bench_torch.core import train as bench_train  # noqa: E402
from bench_torch.core.cell import draw_weights  # noqa: E402
from bench_torch.core.counts import Work  # noqa: E402
from bench_torch.traffic import darcy  # noqa: E402

CPU = torch.device("cpu")
PROG = cells.load_module(cells.HERE / "configs" / "gno-darcy.py")
REF = cells.load_module(cells.HERE / "reference" / "gno-darcy.py")
# the published configuration at small widths
CFG = {**cells.read_json(cells.HERE / "configs" / "gno-darcy.json"),
       "width": 8, "ker_width": 32, "depth": 3}
# 7 × 7 points (spacing 1/6), a ball of two lattice steps: 13 neighbours
TRAFFIC = {"task": "train", "samples": 4, "episode_steps": 3,
           "weights_seed": 0,
           "darcy": {"points": 7, "sub": 2, "fine": 13, "radius": 1 / 3,
                     "alpha": 2.0, "tau": 3.0, "a_high": 12.0, "a_low": 3.0,
                     "smooth": 0.05, "cg_tol": 1e-10}}
MODES = ("auto", "pallas")  # the per-edge path; K5's plain version


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.fixture
def mode(request):
    P.set_spmm_mode(request.param)
    yield request.param
    P.set_spmm_mode("auto")


def _inputs(seed=3):
    data = PROG.make_data(CFG, TRAFFIC, seed, CPU)
    weights = draw_weights(PROG.weight_spec(CFG, data), seed, CPU)
    return data, weights


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_gkn_forward_and_gradients_match_reference(mode):
    """The port's forward, loss and every leaf's gradient on one sample
    against the plain reference, from the same inputs and weights."""
    data, weights = _inputs()
    prog = PROG.train_program(CFG, data, CPU, weights)
    out = prog.model(data["feats"][0], data["a"][0])
    s, r, deg = REF._graph(data, CPU)
    p = {k: v.clone().requires_grad_() for k, v in weights.items()}
    want = REF.forward(CFG, p, data["feats"][0], data["a"][0], data["pos"],
                       s, r, deg)
    assert _rel(out, want) <= 1e-5
    loss = P.mse(out, data["y"][0])
    ref_loss = REF.loss(CFG, data, p, 0, s, r, deg)
    lo, lr = float(loss.detach()), float(ref_loss.detach())
    assert abs(lo - lr) <= 1e-5 * abs(lr)
    names = list(prog.params)
    got = torch.autograd.grad(loss, [prog.params[k] for k in names])
    ref = torch.autograd.grad(ref_loss, [p[k] for k in names])
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-4, name


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_gkn_three_adam_steps_match_reference(mode):
    """Three Adam steps of ``make_train_step`` (one sample each) against the
    reference's plain Adam: each step's loss, the first gradient as Adam
    holds it, and each leaf's change."""
    data, weights = _inputs(seed=4)
    prog = PROG.train_program(CFG, data, CPU, weights)
    got = bench_train.first_steps(prog)
    ref = REF.train(CFG, data, weights, 3, CPU)
    for a, b in zip(got["losses"], ref["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert len(set(got["losses"])) == 3  # three samples, three losses
    for k in ref["grads"]:
        assert _rel(got["grads"][k], ref["grads"][k]) <= 1e-4, k
        assert _rel(got["change"][k], ref["change"][k]) <= 1e-3, k
    numbers = compare.training(got, ref)
    assert numbers["change_gap"] <= 1e-3 and numbers["grad_gap"] <= 1e-4


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_kernel_net_once_equals_once_an_iteration(mode):
    """φ's prefix made once a forward and handed to every iteration gives
    the output of the conv evaluating φ at every call, and φ's gradient is
    the sum over the iterations that the per-call form accumulates."""
    data, weights = _inputs(seed=5)
    prog = PROG.train_program(CFG, data, CPU, weights)
    model, conv = prog.model, prog.model.conv
    u, a = data["feats"][1], data["a"][1]
    gy = torch.randn(u.shape[0], 1, generator=torch.Generator().manual_seed(0))
    once = model(u, a)
    phi = list(conv.phi.parameters())
    g_once = torch.autograd.grad((once * gy).sum(), phi)

    own = conv.graph
    conv.graph = model.graph.copy(ndata={"a": a, "x": model.graph.ndata["x"]})
    try:
        h = model.lift(u)
        for _ in range(model.depth):
            h = conv(h)
        each = model.proj(h)
    finally:
        conv.graph = own
    assert torch.equal(once, each)
    g_each = torch.autograd.grad((each * gy).sum(), phi)
    for x, y in zip(g_once, g_each):
        assert _rel(x, y) <= 1e-5


def test_phi_prefix_needs_a_linear_last_layer():
    """``GNOConv.forward(x, ph)`` and ``phi_prefix`` refuse a ϕ whose last
    layer is not a linear Dense."""
    gen = torch.Generator().manual_seed(0)
    conv = P.GNOConv(2, 2, P.MLP((6, 4, 4), "relu", final_activation="relu",
                                 generator=gen), generator=gen)
    with pytest.raises(ValueError, match="linear Dense"):
        conv.phi_prefix(torch.zeros(3, 2))
    with pytest.raises(ValueError, match="linear Dense"):
        conv(torch.zeros(3, 2), torch.zeros(5, 4))


def test_k5_plain_at_gkn_widths_matches_reference_matrices():
    """K5's plain version at the published widths (K 1,024, IN = OUT = 64)
    against the reference's per-edge kernel matrices ``reshape(ph W + b,
    64 × 64)`` and its mean of messages, forward and gradients."""
    rng = np.random.default_rng(7)
    n, e, k, w = 30, 200, 1024, 64
    r = np.sort(rng.integers(0, n - 1, e))  # node n − 1 receives nothing
    s = rng.integers(0, n, e).astype(np.int32)
    csr = build_segment_csr(np.arange(e), r, n, num_cols=e)
    senders = torch.from_numpy(s)

    def put(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).requires_grad_()

    ph, h = put(e, k), put(n, w)
    wt, b = put(k, w * w, scale=k ** -0.5), put(1, w * w, scale=0.1)
    deg = torch.from_numpy(np.bincount(r, minlength=n).astype(np.float32))
    got = K5.fused_gno_aggregate(ph, h, *K5.pack_last_layer(wt, b, w, w),
                                 csr, senders) / deg.clamp_min(1)[:, None]
    want = REF.mean_messages((ph @ wt + b).reshape(e, w, w), h,
                             torch.from_numpy(s).long(),
                             torch.from_numpy(r).long(), deg.clamp_min(1))
    assert _rel(got, want) <= 1e-5
    assert not got[n - 1].any()
    gy = torch.randn(n, w, generator=torch.Generator().manual_seed(1))
    leaves = (ph, h, wt, b)
    for a, c in zip(torch.autograd.grad(got, leaves, gy),
                    torch.autograd.grad(want, leaves, gy)):
        assert _rel(a, c) <= 1e-4


def test_kernel_net_span_and_k5_counters_under_profiler():
    """Under ``torch.profiler`` a ``GKNModel`` step opens one
    ``ngpde.gno.kernel_net`` span a forward, and the conv's span once an
    iteration; on CPU tensors K5's plain version runs, so its launch and
    pass counters stay where they were."""
    data, weights = _inputs(seed=6)
    prog = PROG.train_program(CFG, data, CPU, weights)
    before = (K5.fused_gno_fwd.launches, K5.fused_gno_bwd.launches,
              K5.fused_gno_fwd.reduce_passes, K5.fused_gno_bwd.reduce_passes)
    P.set_spmm_mode("pallas")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            prog.step()
            prog.step()
    finally:
        P.set_spmm_mode("auto")
    names = [ev.name for ev in prof.events()]
    assert names.count("ngpde.gno.kernel_net") == 2
    assert names.count("ngpde.conv.GNOConv") == 2 * CFG["depth"]
    assert names.count("ngpde.dispatch.k5") == 2 * CFG["depth"]
    assert names.count("ngpde.train.backward") == 2
    after = (K5.fused_gno_fwd.launches, K5.fused_gno_bwd.launches,
             K5.fused_gno_fwd.reduce_passes, K5.fused_gno_bwd.reduce_passes)
    assert after == before


@pytest.mark.cuda
def test_gkn_k5_counters_cuda():
    """On the card a ``GKNModel`` step launches K5 once an iteration
    forward and once backward, each launch counting its reduce's passes;
    at K 1,024, IN = OUT = 64 the reduce takes six passes and the per-edge
    backward four slices of 256 columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    plan = K5.gno_plan(1024, 64, 64, True)
    assert (plan["reduce_passes"], plan["edge_slices"],
            plan["edge_slice"]) == (6, 4, 256)
    assert K5.gno_plan(128, 64, 64, True)["reduce_passes"] == 1
    assert K5.gno_plan(128, 64, 64, True)["edge_slices"] == 1
    data = PROG.make_data(CFG, TRAFFIC, 3, dev)
    weights = draw_weights(PROG.weight_spec(CFG, data), 3, dev)
    prog = PROG.train_program(CFG, data, dev, weights)
    passes = K5.gno_plan(CFG["ker_width"], CFG["width"], CFG["width"],
                         True)["reduce_passes"]
    before = (K5.fused_gno_fwd.launches, K5.fused_gno_bwd.launches,
              K5.fused_gno_fwd.reduce_passes, K5.fused_gno_bwd.reduce_passes)
    prog.step()
    torch.cuda.synchronize()
    d = CFG["depth"]
    assert (K5.fused_gno_fwd.launches - before[0],
            K5.fused_gno_bwd.launches - before[1],
            K5.fused_gno_fwd.reduce_passes - before[2],
            K5.fused_gno_bwd.reduce_passes - before[3]) == (
        d, d, d * passes, d * passes)


# a 4-node graph for the counts: 0 ← 1, 0 ← 2, 1 ← 0, 2 ← 3, 3 ← 3, 5
# edges; IN 2, OUT 3, K 5 (KB 6 with the bias)
N, E, FIN, FOUT, KW = 4, 5, 2, 3, 5


def test_gno_conv_forward_count_by_hand():
    w = gno_counts.gno_conv_forward(N, E, FIN, FOUT, KW)
    reduce = 2 * E * FIN * 6  # S[n] += x[s_e] ⊗ [ph_e, 1]: 120
    contract = 2 * N * FIN * 6 * FOUT  # S · Wl': 288
    mean = N * FOUT  # 12
    root = 2 * N * FIN * FOUT + 3 * N * FOUT  # W x 48; add, b, ReLU 36
    assert w.ops == reduce + contract + mean + root == 504
    # ph 25, x 8, Wl' 36, W 6, b 3, y 12 floats; CSR 5 offsets, 5 ids, 5
    # weights; 5 senders; 4 degrees
    assert w.bytes == 4 * (25 + 8 + 36 + 6 + 3 + 12) + 4 * (15 + 5 + 4)


@pytest.mark.parametrize("input_grad", [True, False])
def test_gno_conv_backward_count_by_hand(input_grad):
    w = gno_counts.gno_conv_backward(N, E, FIN, FOUT, KW, input_grad)
    # ReLU' 24, db 12, dW 48, the mean's division 12, dS 288, dWl' 288,
    # dph 2·5·2·5 = 100
    ops = 24 + 12 + 48 + 12 + 288 + 288 + 100
    # gy 12, y 12, x 8, W 6, ph 25, Wl' 36; dW 6, db 3, dWl' 36, dph 25
    floats = 12 + 12 + 8 + 6 + 25 + 36 + 6 + 3 + 36 + 25
    if input_grad:
        # dx through W 48, per-edge dh 2·5·2·6 = 120, onto the senders 10,
        # the add 8; dx written, 8 floats
        ops += 48 + 120 + 10 + 8
        floats += 8
    assert w.ops == ops
    assert w.bytes == 4 * floats + 4 * (15 + 5 + 4)


def test_kernel_net_and_loss_counts_by_hand():
    dims = (6, 4, 5)  # edge features → hidden 4 → K 5, on E = 5 edges
    fwd = gno_counts.kernel_net_forward(E, dims)
    # products 2·5·6·4 = 240 and 2·5·4·5 = 200; bias + ReLU 2·5·4, 2·5·5
    assert fwd.ops == 240 + 200 + 40 + 50
    params = 6 * 4 + 4 + 4 * 5 + 5
    assert fwd.bytes == 4 * (5 * 6 + params + 5 * 5)
    bwd = gno_counts.kernel_net_backward(E, dims)
    # layer 1: ReLU' 40, db 20, dW 240 (no input gradient); layer 2:
    # ReLU' 50, db 25, dW 200, dx 200
    assert bwd.ops == 40 + 20 + 240 + 50 + 25 + 200 + 200
    assert bwd.bytes == 4 * (5 * 5 + 5 * (4 + 5) + 5 * 6 + 2 * params)
    assert gno_counts.mse(N) == Work(24, 48)


def test_darcy_traffic_graph_and_seeds():
    """The cell's ball graph (61 × 61 points, radius 0.1 by float64
    distance, self-loops: the 4 lattice offsets of length 6 kept where the
    coordinates round within 0.1), and the generator's seeding: the same seed gives
    the same inputs, another seed other fields on the same graph."""
    s, r = darcy.ball_edges(61, 0.1)
    deg = np.bincount(r, minlength=61 * 61)
    assert len(s) == 383_293 and deg.max() == 113 and deg.min() == 35
    assert int((s == r).sum()) == 61 * 61
    assert np.all(np.diff(r) >= 0)
    key = set(zip(s.tolist(), r.tolist()))
    assert all((b, a) in key for a, b in list(key)[:2000])
    a = darcy.darcy(TRAFFIC, 2 ** 31 + 7, CPU)
    b = darcy.darcy(TRAFFIC, 2 ** 31 + 7, CPU)
    c = darcy.darcy(TRAFFIC, 2 ** 31 + 8, CPU)
    for key_ in ("feats", "a", "y"):
        assert torch.equal(a[key_], b[key_])
    assert not torch.equal(a["a"], c["a"])
    assert (a["senders"] == c["senders"]).all()
    # normalized point by point over the samples: every point's mean is 0
    assert float(a["y"].mean(dim=0).abs().max()) < 1e-5
    # u = 0 on the boundary in every sample: its normalized value too
    assert float(a["y"][:, :7].abs().max()) == 0.0
