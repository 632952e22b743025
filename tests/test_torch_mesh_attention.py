"""K8, attention over mesh neighbourhoods (``kernels/attention_kernels.py``),
and what it is built from (``graph/sphere.py``: the mesh order, the k-hop
neighbourhoods; the tile layout), on the CPU at small sizes: the plain
version against dense softmax attention under the k-hop mask, forward and
every gradient, in float64 (the same sums in another order: within 1e-12
of the largest value); the neighbourhoods against a breadth-first search.
The ``cuda`` cases hold the kernels to the plain version on the card
(float32: forward within 1e-5 of the largest value, each gradient within
1e-4 of its largest entry, the sums of a softmax over a few hundred keys
taken in another order)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.graph import sphere  # noqa: E402
from neuralgraphpde_torch.kernels import attention_kernels as ak  # noqa: E402


def _mesh(splits, local=True):
    verts, faces = sphere.icosahedral_meshes(splits)[-1]
    if local:
        order = sphere.mesh_order(faces, len(verts))
        new_id = np.empty(len(verts), np.int64)
        new_id[order] = np.arange(len(verts))
        faces = new_id[faces]
    s, r = sphere.face_edges(faces)
    return s, r, len(verts)


def _bfs(s, r, n, hops):
    adj = [[] for _ in range(n)]
    for a, b in zip(s, r):
        adj[b].append(a)
    out = []
    for i in range(n):
        seen, front = {i}, [i]
        for _ in range(hops):
            nxt = []
            for x in front:
                for j in adj[x]:
                    if j not in seen:
                        seen.add(j)
                        nxt.append(j)
            front = nxt
        out.append(seen)
    return out


def _dense(q, k, v, mask, heads):
    n, width = q.shape
    d = width // heads
    qh, kh, vh = (t.view(n, heads, d) for t in (q, k, v))
    s = torch.einsum("qhd,khd->hqk", qh, kh) / math.sqrt(d)
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, vh).reshape(n, width)


def _mask(bits, n):
    return ak._bit_mask(bits[:n]).reshape(n, -1)[:, :n]


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_khop_bits_match_a_breadth_first_search(hops):
    s, r, n = _mesh(2)
    bits = sphere.khop_bits(s, r, n, hops)
    assert bits.shape == (3 * 64, 3)
    want = _bfs(s, r, n, hops)
    got = _mask(bits, n)
    for i in range(n):
        assert set(got[i].nonzero()[:, 0].tolist()) == want[i], i
    assert not bits[n:].any()


def test_mesh_order_is_a_local_permutation():
    verts, faces = sphere.icosahedral_meshes(3)[-1]
    order = sphere.mesh_order(faces, len(verts))
    assert np.array_equal(np.sort(order), np.arange(len(verts)))
    new_id = np.empty(len(verts), np.int64)
    new_id[order] = np.arange(len(verts))
    s, r = sphere.face_edges(faces)
    span = np.abs(s - r).mean()
    span_local = np.abs(new_id[s] - new_id[r]).mean()
    assert span_local < span / 3


def test_layout_tiles_are_symmetric_and_count_the_pairs():
    s, r, n = _mesh(3)
    bits = sphere.khop_bits(s, r, n, 4)
    lay = ak.build_attention_layout(bits, n)
    want = _bfs(s, r, n, 4)
    assert lay.pairs == sum(len(w) for w in want)
    assert lay.blocks == -(-n // 64)
    tiles = {}
    rp = lay.row_ptr.tolist()
    for i in range(lay.blocks):
        for t in range(rp[i], rp[i + 1]):
            tiles[(i, int(lay.cols[t]))] = ak._bit_mask(lay.masks[t])
    for (i, j), m in tiles.items():
        assert torch.equal(m, tiles[(j, i)].T)
        assert m.any()
    assert 0 < lay.fill <= 1
    assert lay.fill == lay.pairs / (lay.tiles * 64 * 64)


def test_twelve_vertices_have_five_neighbours():
    s, r, n = _mesh(2)
    deg = np.bincount(r, minlength=n)
    assert (deg == 5).sum() == 12 and (deg == 6).sum() == n - 12
    table = sphere.neighbour_table(s, r, n)
    five = np.nonzero(deg == 5)[0]
    assert (table[five, -1] == five).all()  # padded with the node itself


@pytest.mark.parametrize("hops,heads", [(1, 2), (2, 4), (16, 1)])
def test_plain_version_is_dense_masked_attention(hops, heads):
    """Forward and every gradient; at 16 hops every neighbourhood is the
    whole mesh (M2's diameter is under 16), so the softmax is dense; the
    12 degree-5 vertices' rows are among those compared."""
    s, r, n = _mesh(2)
    bits = sphere.khop_bits(s, r, n, hops)
    lay = ak.build_attention_layout(bits, n)
    mask = _mask(bits, n)
    if hops == 16:
        assert mask.all()
    gen = torch.Generator().manual_seed(hops)
    q, k, v = (torch.randn(n, heads * 8, generator=gen,
                           dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    got = ak.mesh_attention_plain(q, k, v, lay, heads)
    want = _dense(q, k, v, mask, heads)
    err = (got - want).abs().max() / want.abs().max()
    assert float(err.detach()) <= 1e-12
    cot = torch.randn(got.shape, generator=gen, dtype=torch.float64)
    g_got = torch.autograd.grad(got, (q, k, v), cot)
    g_want = torch.autograd.grad(want, (q, k, v), cot)
    for a, b in zip(g_got, g_want):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-12


def test_wrapper_takes_the_plain_version_on_the_cpu():
    s, r, n = _mesh(1)
    lay = ak.build_attention_layout(sphere.khop_bits(s, r, n, 1), n)
    q = torch.randn(n, 32)
    before = (ak.mesh_attention.launches, ak.mesh_attention.pairs)
    out = ak.mesh_attention(q, q, q, lay, 2)
    assert torch.equal(out, ak.mesh_attention_plain(q, q, q, lay, 2))
    assert (ak.mesh_attention.launches, ak.mesh_attention.pairs) == before


def test_mesh_attention_conv_spans_and_dispatch():
    from torch.profiler import ProfilerActivity, profile

    s, r, n = _mesh(1)
    g = P.GnnGraph.from_coo(s.astype(np.int32), r.astype(np.int32),
                            num_nodes=n)
    lay = ak.build_attention_layout(sphere.khop_bits(s, r, n, 2), n)
    conv = P.MeshAttention(2, g.copy(cache={"attention_layout": lay}))
    q = torch.randn(n, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = conv(q, q, q)
    names = [e.name for e in prof.events()]
    assert names.count("ngpde.conv.MeshAttention") == 1
    assert names.count("ngpde.dispatch.mesh_attention_plain") == 1
    assert torch.equal(out, ak.mesh_attention_plain(q, q, q, lay, 2))
    P.set_spmm_mode("pallas")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            conv(q, q, q)
    finally:
        P.set_spmm_mode("auto")
    names = [e.name for e in prof.events()]
    assert names.count("ngpde.dispatch.mesh_attention") == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("splits,hops,heads,d", [(2, 2, 4, 64),
                                                 (3, 4, 4, 128),
                                                 (3, 40, 2, 64)])
def test_kernel_matches_the_plain_version(card, splits, hops, heads, d):
    s, r, n = _mesh(splits)
    lay = ak.build_attention_layout(sphere.khop_bits(s, r, n, hops, card), n)
    gen = torch.Generator(device=card).manual_seed(splits + hops)
    q, k, v = (torch.randn(n, heads * d, generator=gen, device=card)
               .requires_grad_() for _ in range(3))
    cot = torch.randn(n, heads * d, generator=gen, device=card)
    before = (ak.mesh_attention.launches,
              ak.mesh_attention.backward_launches, ak.mesh_attention.pairs)
    got = ak.mesh_attention(q, k, v, lay, heads)
    g_got = torch.autograd.grad(got, (q, k, v), cot)
    torch.cuda.synchronize()
    after = (ak.mesh_attention.launches,
             ak.mesh_attention.backward_launches, ak.mesh_attention.pairs)
    assert [b - a for a, b in zip(before, after)] == [
        3, 2, 3 * lay.tiles * 64 * 64]
    want = ak.mesh_attention_plain(q, k, v, lay, heads)
    g_want = torch.autograd.grad(want, (q, k, v), cot)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    for a, b in zip(g_got, g_want):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    s, r, n = _mesh(1)
    lay = ak.build_attention_layout(sphere.khop_bits(s, r, n, 1, card), n)
    x = torch.randn(n, 24, device=card)
    with pytest.raises(ValueError):
        ak.mesh_attention(x, x, x, lay, 2)  # heads of 12
    x = torch.randn(n, 64, device=card)
    with pytest.raises(ValueError):
        ak.mesh_attention(x, x, x, lay, 2)  # heads of 32
    x = torch.randn(n + 1, 32, device=card)
    with pytest.raises(ValueError):
        ak.mesh_attention(x, x, x, lay, 2)
