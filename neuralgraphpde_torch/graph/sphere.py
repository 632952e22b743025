"""Graphs on the sphere for GraphCast (Lam et al., arXiv:2212.12794): the
icosahedral multimesh, the latitude–longitude grid, the bipartite
grid → mesh and mesh → grid edge sets, and their node and edge features.

Positions are points of the unit sphere in float64; a point at latitude
``φ`` and longitude ``λ`` is ``(cos φ cos λ, cos φ sin λ, sin φ)``.

- The icosahedral meshes ``M0 … Mr``: ``M0`` is the regular icosahedron
  (12 vertices, 20 faces, a face towards each pole); ``M(k+1)`` splits every face of ``Mk`` into
  four at its edges' midpoints, projected onto the sphere. The vertices of
  ``Mk`` are the first ``10·4^k + 2`` vertices of every finer mesh, new
  midpoints appended in the order their edges are first met.
- The multimesh: the vertices of ``Mr`` and the union of every level's
  edges, both directions: ``2·Σ_{k≤r} 30·4^k`` directed edges (no edge of
  one level joins two vertices adjacent at another).
- The grid: ``n_lat`` latitudes from −90° to 90° and ``n_lon`` longitudes
  from 0° in steps of ``360° / n_lon``, numbered latitude by latitude.
- Grid → mesh: every grid point within ``radius`` (the chord in 3-D) of a
  mesh vertex sends to that vertex.
- Mesh → grid: each grid point receives from the three vertices of the
  face of ``Mr`` that contains it (the face its ray from the centre
  crosses; on a shared side or corner, the face in which its smallest
  barycentric coordinate is largest, the first such among the candidates
  in ``cKDTree`` order).
- Node features ``[cos φ, sin λ, cos λ]``; edge features ``[|d|, d_x, d_y,
  d_z] / max|d|``: the sender's displacement from the receiver in the
  receiver's local frame (rotated by ``−λ`` about z, then by ``φ`` about
  y, so that the receiver sits at ``(1, 0, 0)``), over the longest
  displacement of the edge set.

Edge lists are sorted by receiver, then sender. A bipartite edge set's
senders and receivers index different node sets: ``GnnGraph`` holds the
receivers' count as ``num_nodes`` and the senders' as ``num_senders``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .gnngraph import GnnGraph

_BLOCK = 1 << 17  # points a block of the containing-face search


def icosahedron() -> Tuple[np.ndarray, np.ndarray]:
    """The regular icosahedron on the unit sphere as GraphCast's code
    builds it: vertices ``(12, 3)`` float64 and faces ``(20, 3)`` int64 in
    its order, turned about y so that a face, not a vertex, points at each
    pole (at 0.25° this orientation gives 1,618,824 grid → mesh edges, the
    paper 1,618,746)."""
    p = (1.0 + np.sqrt(5.0)) / 2.0
    v = []
    for c1 in (1.0, -1.0):
        for c2 in (p, -p):
            v += [(c1, c2, 0.0), (0.0, c1, c2), (c2, 0.0, c1)]
    v = np.array(v, dtype=np.float64) / np.linalg.norm([1.0, p])
    f = np.array([[0, 1, 2], [0, 6, 1], [8, 0, 2], [8, 4, 0], [3, 8, 2],
                  [3, 2, 7], [7, 2, 1], [0, 4, 6], [4, 11, 6], [6, 11, 5],
                  [1, 5, 7], [4, 10, 11], [4, 8, 10], [10, 8, 3], [10, 3, 9],
                  [11, 10, 9], [11, 9, 5], [5, 9, 7], [9, 3, 7], [1, 6, 5]],
                 dtype=np.int64)
    turn = (np.pi - 2.0 * np.arcsin(p / np.sqrt(3.0))) / 2.0
    c, s = np.cos(turn), np.sin(turn)
    return v @ np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]), f


def refine(vertices: np.ndarray, faces: np.ndarray):
    """One split of every face into four: ``(vertices, faces)`` with the
    old vertices first and each edge's midpoint (on the sphere) appended in
    the order of the edges' first appearance in ``faces``."""
    a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
    sides = np.stack([np.stack([a, b], 1), np.stack([b, c], 1),
                      np.stack([c, a], 1)], 1).reshape(-1, 2)
    key = np.sort(sides, axis=1)
    uniq, first, inverse = np.unique(key, axis=0, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")  # first appearance
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    mid_id = len(vertices) + rank[inverse.reshape(-1)].reshape(-1, 3)
    pair = uniq[order]
    mids = vertices[pair[:, 0]] + vertices[pair[:, 1]]
    mids /= np.linalg.norm(mids, axis=1, keepdims=True)
    ab, bc, ca = mid_id[:, 0], mid_id[:, 1], mid_id[:, 2]
    new = np.stack([np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
                    np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1)], 1)
    return np.concatenate([vertices, mids]), new.reshape(-1, 3)


def icosahedral_meshes(splits: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``[(vertices, faces)]`` of ``M0 … M_splits``."""
    meshes = [icosahedron()]
    for _ in range(splits):
        meshes.append(refine(*meshes[-1]))
    return meshes


def face_edges(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The sides of ``faces``, both directions, each once."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    e = np.unique(np.concatenate([e, e[:, ::-1]]), axis=0)
    return e[:, 0], e[:, 1]


def _by_receiver(s: np.ndarray, r: np.ndarray):
    order = np.lexsort((s, r))
    return s[order].astype(np.int64), r[order].astype(np.int64)


def multimesh_edges(meshes) -> Tuple[np.ndarray, np.ndarray]:
    """The union of every level's sides, both directions, over the finest
    mesh's vertices: ``(senders, receivers)`` sorted by receiver."""
    s, r = zip(*(face_edges(f) for _, f in meshes))
    e = np.unique(np.stack([np.concatenate(s), np.concatenate(r)], 1),
                  axis=0)
    return _by_receiver(e[:, 0], e[:, 1])


def lat_lon_grid(n_lat: int, n_lon: int) -> Tuple[np.ndarray, np.ndarray]:
    """Latitude and longitude in degrees of every grid point, ``(n_lat ·
    n_lon,)`` each, latitude by latitude."""
    lat = np.linspace(-90.0, 90.0, n_lat)
    lon = np.arange(n_lon) * (360.0 / n_lon)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    return la.reshape(-1), lo.reshape(-1)


def to_xyz(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    phi, lam = np.deg2rad(lat), np.deg2rad(lon)
    return np.stack([np.cos(phi) * np.cos(lam), np.cos(phi) * np.sin(lam),
                     np.sin(phi)], axis=1)


def to_lat_lon(xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lat = np.rad2deg(np.arcsin(np.clip(xyz[:, 2], -1.0, 1.0)))
    lon = np.rad2deg(np.arctan2(xyz[:, 1], xyz[:, 0])) % 360.0
    return lat, lon


def longest_side(vertices: np.ndarray, faces: np.ndarray) -> float:
    s, r = face_edges(faces)
    return float(np.linalg.norm(vertices[s] - vertices[r], axis=1).max())


def grid2mesh_edges(grid_xyz: np.ndarray, mesh_xyz: np.ndarray,
                    radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """``(senders, receivers)``: grid point → mesh vertex for every pair
    within ``radius``, sorted by receiver (the mesh vertex)."""
    from scipy.spatial import cKDTree

    hits = cKDTree(grid_xyz).query_ball_point(mesh_xyz, r=radius)
    counts = np.fromiter((len(h) for h in hits), np.int64, len(hits))
    s = np.fromiter((i for h in hits for i in h), np.int64, counts.sum())
    r = np.repeat(np.arange(len(mesh_xyz), dtype=np.int64), counts)
    return _by_receiver(s, r)


def containing_faces(points: np.ndarray, vertices: np.ndarray,
                     faces: np.ndarray, candidates: int = 8):
    """``(face, barycentric)``: for each point, the face whose cone from the
    centre holds it and the point's barycentric coordinates in it (those of
    the point's projection along its ray onto the face's plane)."""
    from scipy.spatial import cKDTree

    tri = vertices[faces]  # (F, 3 vertices, 3)
    inv = np.linalg.inv(np.transpose(tri, (0, 2, 1)))  # columns: vertices
    centres = tri.mean(axis=1)
    tree = cKDTree(centres / np.linalg.norm(centres, axis=1, keepdims=True))
    face = np.full(len(points), -1, np.int64)
    bary = np.zeros((len(points), 3))
    todo = np.arange(len(points))
    k = candidates
    while len(todo):
        missed = []
        for blk in np.array_split(todo, -(-len(todo) // _BLOCK)):
            _, cand = tree.query(points[blk], k=min(k, len(faces)))
            cand = cand.reshape(len(blk), -1)
            lam = np.einsum("nkij,nj->nki", inv[cand], points[blk])
            lam = lam / lam.sum(axis=2, keepdims=True)
            worst = lam.min(axis=2)
            best = worst.argmax(axis=1)
            rows = np.arange(len(blk))
            found = worst[rows, best] >= -1e-9
            face[blk[found]] = cand[rows, best][found]
            bary[blk[found]] = lam[rows, best][found]
            missed.append(blk[~found])
        todo = np.concatenate(missed)
        if k >= len(faces) and len(todo):
            raise RuntimeError("containing_faces: points outside every face")
        k *= 4
    return face, bary


def mesh2grid_edges(grid_xyz: np.ndarray, vertices: np.ndarray,
                    faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(senders, receivers)``: the three vertices of each grid point's
    containing face → that grid point, sorted by receiver."""
    face, _ = containing_faces(grid_xyz, vertices, faces)
    s = faces[face].reshape(-1)
    r = np.repeat(np.arange(len(grid_xyz), dtype=np.int64), 3)
    return _by_receiver(s, r)


def node_features(xyz: np.ndarray) -> np.ndarray:
    """``[cos φ, sin λ, cos λ]`` of every point, float32."""
    lat, lon = to_lat_lon(xyz)
    phi, lam = np.deg2rad(lat), np.deg2rad(lon)
    return np.stack([np.cos(phi), np.sin(lam), np.cos(lam)],
                    axis=1).astype(np.float32)


def edge_features(sender_xyz: np.ndarray, receiver_xyz: np.ndarray,
                  senders: np.ndarray, receivers: np.ndarray) -> np.ndarray:
    """``[|d|, d_x, d_y, d_z] / max|d|`` of every edge, ``d`` the sender's
    displacement from the receiver in the receiver's local frame;
    float32."""
    p_s, p_r = sender_xyz[senders], receiver_xyz[receivers]
    lat, lon = to_lat_lon(p_r)
    phi, lam = np.deg2rad(lat), np.deg2rad(lon)
    d = p_s - p_r
    x1 = np.cos(lam) * d[:, 0] + np.sin(lam) * d[:, 1]
    y1 = -np.sin(lam) * d[:, 0] + np.cos(lam) * d[:, 1]
    x2 = np.cos(phi) * x1 + np.sin(phi) * d[:, 2]
    z2 = -np.sin(phi) * x1 + np.cos(phi) * d[:, 2]
    local = np.stack([x2, y1, z2], axis=1)
    length = np.linalg.norm(local, axis=1, keepdims=True)
    scale = length.max()
    return (np.concatenate([length, local], axis=1) / scale).astype(
        np.float32)


@dataclasses.dataclass(frozen=True)
class GraphCastGraphs:
    """GraphCast's three graphs, sorted by receiver, on the host: the
    multimesh (``mesh``: mesh → mesh, node features ``ndata['x']``) and the
    bipartite ``grid2mesh`` (grid → mesh) and ``mesh2grid`` (mesh → grid);
    every graph's edge features in ``edata['e']``. ``grid_lat`` /
    ``grid_lon``: the grid's latitudes and longitudes in degrees;
    ``grid_features``: its ``[cos φ, sin λ, cos λ]``."""

    mesh: GnnGraph
    grid2mesh: GnnGraph
    mesh2grid: GnnGraph
    grid_lat: np.ndarray
    grid_lon: np.ndarray
    grid_features: np.ndarray


def graphcast_graphs(splits: int = 6, n_lat: int = 721, n_lon: int = 1440,
                     radius_fraction: float = 0.6) -> GraphCastGraphs:
    """GraphCast's graphs: the multimesh ``M0 … M_splits``, the ``n_lat ×
    n_lon`` grid, grid → mesh within ``radius_fraction`` of the finest
    mesh's longest side, mesh → grid from each grid point's containing
    face. The defaults are the published 0.25° model's (40,962 mesh
    vertices, 327,660 mesh edges, 1,038,240 grid points)."""
    meshes = icosahedral_meshes(splits)
    verts, faces = meshes[-1]
    lat, lon = lat_lon_grid(n_lat, n_lon)
    grid = to_xyz(lat, lon)
    n_mesh, n_grid = len(verts), len(grid)

    def graph(s, r, n_recv, n_send, s_xyz, r_xyz, ndata=None):
        return GnnGraph.from_coo(
            s.astype(np.int32), r.astype(np.int32), num_nodes=n_recv,
            num_senders=n_send, ndata=ndata,
            edata={"e": edge_features(s_xyz, r_xyz, s, r)})

    s, r = multimesh_edges(meshes)
    mesh = graph(s, r, n_mesh, None, verts, verts,
                 ndata={"x": node_features(verts)})
    s, r = grid2mesh_edges(grid, verts,
                           radius_fraction * longest_side(verts, faces))
    g2m = graph(s, r, n_mesh, n_grid, grid, verts)
    s, r = mesh2grid_edges(grid, verts, faces)
    m2g = graph(s, r, n_grid, n_mesh, verts, grid)
    return GraphCastGraphs(mesh=mesh, grid2mesh=g2m, mesh2grid=m2g,
                           grid_lat=lat, grid_lon=lon,
                           grid_features=node_features(grid))


def mesh_order(faces: np.ndarray, num_vertices: int) -> np.ndarray:
    """A local order of a refined icosahedral mesh's vertices: by the
    first face that holds each vertex, in ``refine``'s face order, which
    is depth first (a face's four children follow each other, so
    consecutive faces touch and a run of them covers a patch); ``order
    [new] = old``. ``refine``'s own vertex order is level by level, so
    neighbours there lie far apart."""
    first = np.full(num_vertices, len(faces), np.int64)
    np.minimum.at(first, faces.reshape(-1),
                  np.repeat(np.arange(len(faces), dtype=np.int64), 3))
    return np.argsort(first, kind="stable")


def neighbour_table(senders: np.ndarray, receivers: np.ndarray,
                    num_nodes: int) -> np.ndarray:
    """``(nodes, largest degree)`` int64: each node's senders, padded with
    the node itself."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    order = np.lexsort((s, r))
    s, r = s[order], r[order]
    deg = np.bincount(r, minlength=num_nodes)
    table = np.repeat(np.arange(num_nodes, dtype=np.int64)[:, None],
                      max(1, int(deg.max(initial=0))), axis=1)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    table[r, np.arange(len(r)) - start[r]] = s
    return table


def khop_bits(senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
              hops: int, device=None):
    """Every node's ``hops``-hop neighbourhood (itself included) as packed
    bits, built on ``device`` by ``hops`` rounds of OR-ing each node's row
    with its neighbours' rows: ``(64·blocks, blocks)`` int64 torch tensor,
    ``blocks = ⌈nodes / 64⌉``, row ``i``'s word ``w`` bit ``c`` set where
    node ``64·w + c`` lies within ``hops`` edges of node ``i``."""
    import torch

    blocks = -(-num_nodes // 64)
    table = torch.as_tensor(neighbour_table(senders, receivers, num_nodes),
                            device=device)
    bits = torch.zeros((blocks * 64, blocks), dtype=torch.int64,
                       device=device)
    i = torch.arange(num_nodes, device=device)
    bits[i, i // 64] = torch.ones_like(i) << (i % 64)
    live = bits[:num_nodes]
    for _ in range(hops):
        grown = live.clone()
        for col in table.T:
            grown |= live[col]
        live.copy_(grown)
    return bits


@dataclasses.dataclass(frozen=True)
class GenCastGraphs:
    """GenCast's graphs, sorted by receiver, on the host: the finest mesh
    alone (``mesh``: its sides both ways, node features ``ndata['x']``, no
    edge features), its vertices in ``mesh_order``, and GraphCast's
    bipartite ``grid2mesh`` and ``mesh2grid`` to and from it (edge
    features in ``edata['e']``); the grid as in ``GraphCastGraphs``."""

    mesh: GnnGraph
    grid2mesh: GnnGraph
    mesh2grid: GnnGraph
    grid_lat: np.ndarray
    grid_lon: np.ndarray
    grid_features: np.ndarray


def gencast_graphs(splits: int = 6, n_lat: int = 721, n_lon: int = 1440,
                   radius_fraction: float = 0.6) -> GenCastGraphs:
    """GenCast's graphs: the mesh ``M_splits`` alone (the published 0.25°
    model's M6: 40,962 vertices, 245,760 directed edges), renumbered by
    ``mesh_order`` (so that the attention's tiles are full); the ``n_lat ×
    n_lon`` grid; grid → mesh within ``radius_fraction`` of the mesh's
    longest side and mesh → grid from each grid point's containing face,
    as GraphCast's."""
    verts, faces = icosahedral_meshes(splits)[-1]
    order = mesh_order(faces, len(verts))
    new_id = np.empty(len(verts), np.int64)
    new_id[order] = np.arange(len(verts))
    verts, faces = verts[order], new_id[faces]
    lat, lon = lat_lon_grid(n_lat, n_lon)
    grid = to_xyz(lat, lon)
    n_mesh, n_grid = len(verts), len(grid)

    def graph(s, r, n_recv, n_send, s_xyz, r_xyz):
        return GnnGraph.from_coo(
            s.astype(np.int32), r.astype(np.int32), num_nodes=n_recv,
            num_senders=n_send,
            edata={"e": edge_features(s_xyz, r_xyz, s, r)})

    s, r = _by_receiver(*face_edges(faces))
    mesh = GnnGraph.from_coo(s.astype(np.int32), r.astype(np.int32),
                             num_nodes=n_mesh,
                             ndata={"x": node_features(verts)})
    s, r = grid2mesh_edges(grid, verts,
                           radius_fraction * longest_side(verts, faces))
    g2m = graph(s, r, n_mesh, n_grid, grid, verts)
    s, r = mesh2grid_edges(grid, verts, faces)
    m2g = graph(s, r, n_grid, n_mesh, verts, grid)
    return GenCastGraphs(mesh=mesh, grid2mesh=g2m, mesh2grid=m2g,
                         grid_lat=lat, grid_lon=lon,
                         grid_features=node_features(grid))
