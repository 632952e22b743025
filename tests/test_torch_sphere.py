"""GraphCast's graphs (``neuralgraphpde_torch.graph.sphere``) on the CPU:
the multimesh's counts, the Mesh2Grid triangles, the Grid2Mesh radius
query against a brute-force one, the benchmark generator's independent
builder giving the same edges and features, and the bipartite graphs'
receiver blocks and segment layouts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import neuralgraphpde_torch as P  # noqa: E402
from neuralgraphpde_torch.graph import sphere as S  # noqa: E402
from neuralgraphpde_torch.models import graphcast as gc  # noqa: E402

from bench_torch.traffic import graphcast as gen  # noqa: E402


@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_multimesh_counts(r):
    meshes = S.icosahedral_meshes(r)
    verts, faces = meshes[-1]
    s, rr = S.multimesh_edges(meshes)
    assert len(verts) == 10 * 4 ** r + 2
    assert len(faces) == 20 * 4 ** r
    assert len(s) == 2 * sum(30 * 4 ** k for k in range(r + 1))
    assert np.allclose(np.linalg.norm(verts, axis=1), 1.0)
    # both directions, no loops, no duplicates, sorted by receiver
    pairs = set(zip(s.tolist(), rr.tolist()))
    assert len(pairs) == len(s) and all(a != b for a, b in pairs)
    assert all((b, a) in pairs for a, b in pairs)
    assert np.all(np.diff(rr) >= 0)


def test_coarse_vertices_are_a_prefix():
    meshes = S.icosahedral_meshes(3)
    fine = meshes[-1][0]
    for verts, _ in meshes[:-1]:
        assert np.array_equal(fine[: len(verts)], verts)


def test_icosahedron_has_a_face_at_each_pole():
    verts, faces = S.icosahedron()
    centres = verts[faces].mean(axis=1)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    assert np.isclose(centres[:, 2].max(), 1.0)
    assert np.isclose(centres[:, 2].min(), -1.0)


@pytest.mark.parametrize("r,n_lat,n_lon", [(2, 19, 36), (3, 10, 20)])
def test_mesh2grid_three_edges_in_the_containing_face(r, n_lat, n_lon):
    verts, faces = S.icosahedral_meshes(r)[-1]
    grid = S.to_xyz(*S.lat_lon_grid(n_lat, n_lon))
    face, bary = S.containing_faces(grid, verts, faces)
    assert np.all(bary >= -1e-6) and np.allclose(bary.sum(axis=1), 1.0)
    # the barycentric coordinates rebuild the point's ray
    proj = np.einsum("ni,nij->nj", bary, verts[faces[face]])
    proj /= np.linalg.norm(proj, axis=1, keepdims=True)
    assert np.allclose(proj, grid, atol=1e-9)
    s, rr = S.mesh2grid_edges(grid, verts, faces)
    assert np.array_equal(np.bincount(rr, minlength=len(grid)),
                          np.full(len(grid), 3))
    for i in range(len(grid)):
        assert sorted(s[rr == i]) == sorted(faces[face[i]])


def test_grid2mesh_equals_a_brute_force_radius_query():
    verts, faces = S.icosahedral_meshes(2)[-1]
    grid = S.to_xyz(*S.lat_lon_grid(19, 36))
    radius = 0.6 * S.longest_side(verts, faces)
    s, r = S.grid2mesh_edges(grid, verts, radius)
    dist = np.linalg.norm(grid[:, None, :] - verts[None, :, :], axis=2)
    want_s, want_r = np.nonzero(dist <= radius)
    order = np.lexsort((want_s, want_r))
    assert np.array_equal(s, want_s[order])
    assert np.array_equal(r, want_r[order])


@pytest.mark.parametrize("r,n_lat,n_lon", [(2, 19, 36), (3, 19, 36)])
def test_generator_builds_the_same_graphs(r, n_lat, n_lon):
    """The benchmark's generator builds GraphCast's graphs with its own
    code: the same edges, node and edge features and loss weights, bit for
    bit."""
    port = S.graphcast_graphs(r, n_lat, n_lon, 0.6)
    mix = gen.build_graphs(dict(splits=r, n_lat=n_lat, n_lon=n_lon,
                                radius_fraction=0.6))
    for name, key in (("mesh", "mesh"), ("grid2mesh", "g2m"),
                      ("mesh2grid", "m2g")):
        g = getattr(port, name)
        s, rr, feats = mix[key]
        assert np.array_equal(g.host_coo[0], s)
        assert np.array_equal(g.host_coo[1], rr)
        assert np.array_equal(g.edata["e"].numpy(), feats)
    assert np.array_equal(port.mesh.ndata["x"].numpy(), mix["mesh_x"])
    assert np.array_equal(port.grid_lat, mix["grid_lat"])
    assert np.array_equal(port.grid_lon, mix["grid_lon"])
    assert np.array_equal(gc.area_weights(port.grid_lat),
                          gen.area_weights(mix["grid_lat"]))


def test_graphs_are_bipartite_where_they_join_grid_and_mesh():
    gr = S.graphcast_graphs(1, 7, 12)
    n_mesh, n_grid = 42, 84
    assert not gr.mesh.bipartite and gr.mesh.num_nodes == n_mesh
    assert (gr.grid2mesh.num_nodes, gr.grid2mesh.num_senders) == (n_mesh,
                                                                  n_grid)
    assert (gr.mesh2grid.num_nodes, gr.mesh2grid.num_senders) == (n_grid,
                                                                  n_mesh)
    assert gr.grid2mesh.receivers_sorted and gr.mesh2grid.receivers_sorted
    feats = gr.grid2mesh.edata["e"]
    assert feats.shape == (gr.grid2mesh.num_edges, 4)
    assert float(feats[:, 0].max()) == 1.0
    assert torch.allclose(feats[:, 0], feats[:, 1:].norm(dim=1), atol=1e-6)
    assert gr.grid_features.shape == (n_grid, 3)


def test_edge_features_in_the_receivers_frame():
    """A receiver at latitude 0, longitude 0 keeps the displacement as it
    is; one elsewhere sees it rotated, its length unchanged."""
    recv = np.array([[1.0, 0.0, 0.0], S.to_xyz(np.array([40.0]),
                                               np.array([75.0]))[0]])
    send = np.array([S.to_xyz(np.array([3.0]), np.array([4.0]))[0]])
    f = S.edge_features(send, recv, np.array([0, 0]), np.array([0, 1]))
    d = send[0] - recv[0]
    assert np.allclose(f[0, 1:] * np.linalg.norm(
        np.stack([send[0] - recv[0], send[0] - recv[1]]), axis=1).max(),
        d, atol=1e-6)
    assert np.allclose(np.linalg.norm(f[:, 1:], axis=1), f[:, 0], atol=1e-6)


def test_receiver_blocks_aggregate_as_the_whole():
    gr = S.graphcast_graphs(1, 7, 12)
    g = gr.mesh2grid
    blocks = P.receiver_blocks(g, 3, lambda b: P.precompute(b, dense=False))
    assert len(blocks) == 3 and blocks.rows[-1] == g.num_nodes
    assert blocks.edges[-1] == g.num_edges
    whole = P.precompute(g, dense=False)
    m = torch.randn(g.num_edges, 5)
    want = P.aggregate_neighbors(whole, "sum", m)
    P.set_spmm_mode("pallas")  # K1's plain version on the edge layout
    try:
        got = torch.cat([P.aggregate_neighbors(b, "sum", m[e0:e1])
                         for b, _, (e0, e1) in blocks])
        again = P.aggregate_neighbors(whole, "sum", m)
    finally:
        P.set_spmm_mode("auto")
    assert torch.allclose(got, want, atol=1e-6)
    assert torch.allclose(again, want, atol=1e-6)
    for b, (r0, r1), _ in blocks:
        assert b.bipartite and b.num_senders == g.num_senders
        assert b.num_nodes == r1 - r0
        assert b.cache["tcsr_edges"].num_rows == r1 - r0


def test_bipartite_precompute_layouts():
    """The segment layouts of a bipartite graph read the sender set and
    sum onto the receiver set; a bipartite graph takes no loops or
    dense adjacency."""
    g = S.graphcast_graphs(1, 7, 12).grid2mesh
    pg = P.precompute(g, dense=False)
    assert "adj" not in pg.cache
    assert pg.cache["tcsr"].num_cols == g.num_senders
    assert pg.cache["tcsr"].num_rows == g.num_nodes
    assert pg.cache["tcsr_rev"].num_rows == g.num_senders
    x = torch.randn(g.num_senders, 4)
    s, r = (t.long() for t in (g.senders, g.receivers))
    want = torch.zeros(g.num_nodes, 4).index_add_(0, r, x[s])
    P.set_spmm_mode("pallas")
    try:
        got = P.spmm(pg, x)
    finally:
        P.set_spmm_mode("auto")
    assert torch.allclose(got, want, atol=1e-6)
    with pytest.raises(ValueError):
        P.precompute(g, add_self_loops=True)
