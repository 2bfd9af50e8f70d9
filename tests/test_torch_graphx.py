"""The port's lattice graph against the JAX package's: bonds, rings
(``find_cycles``), ring clusters (``find_cycle_clusters``) and the largest
subgraph (``filter_subgraphs``) on graphene honeycombs built here with
vacancies from a numpy seed, and on the JAX suite's hexagon; the native
ring search against its plain version; the ball and pair queries against
cKDTree and the JAX package's wrappers.

Tolerances: rings, clusters, subgraphs, bonds and the neighbour queries
are exact. One stated difference: networkx, which the JAX package's
``find_cycle_clusters`` runs, lists the atoms of a small component in its
hash-set order; the port lists them in ascending atom id. The clusters
are compared as sets of rows (each row once), in the same cluster order.
"""

import os

import numpy as np
import pytest
import torch

from atomai_tpu.native import neighbors as jneighbors
from atomai_tpu.utils import graphx as jgraphx
from atomai_tpu_torch import native
from atomai_tpu_torch.native import neighbors, rings
from atomai_tpu_torch.utils import graphx

torch.set_num_threads(1)

CC_BOND_ANG = 1.42   # graphene's C-C bond
PX2ANG = 0.104       # the graph-analysis notebook's pixel size
CARBON = {0: "C"}


def honeycomb(nx_cells, ny_cells):
    """Honeycomb coordinates (angstrom), 2 atoms a cell."""
    a1 = np.array([3 / 2, np.sqrt(3) / 2]) * CC_BOND_ANG
    a2 = np.array([3 / 2, -np.sqrt(3) / 2]) * CC_BOND_ANG
    basis = [np.zeros(2), np.array([CC_BOND_ANG, 0.0])]
    return np.asarray([i * a1 + j * a2 + b for i in range(nx_cells)
                       for j in range(-ny_cells, ny_cells) for b in basis])


def lattice(nx_cells=14, ny_cells=9, vacancies=6, seed=0):
    """Pixel coordinates [row, col, class] of a honeycomb with
    ``vacancies`` atoms removed at random."""
    xy = honeycomb(nx_cells, ny_cells)
    rng = np.random.RandomState(seed)
    xy = np.delete(xy, rng.choice(len(xy), vacancies, replace=False), 0)
    return np.concatenate([xy / PX2ANG, np.zeros((len(xy), 1))], 1)


def hexagon(a=1.42):
    ang = np.pi / 3 * np.arange(6)
    return np.stack([a * np.cos(ang), a * np.sin(ang), np.zeros(6)], -1)


LATTICES = {
    "pristine": lambda: lattice(vacancies=0),
    "vacancies_seed0": lambda: lattice(seed=0),
    "vacancies_seed1": lambda: lattice(seed=1),
    "dense_defects": lambda: lattice(10, 6, vacancies=14, seed=2),
}
CYCLES = [6, [6, 12], list(range(7, 14)), [5, 6, 7, 8]]


@pytest.fixture(scope="module", params=sorted(LATTICES))
def coords(request):
    return LATTICES[request.param]()


@pytest.mark.parametrize("cycles", CYCLES, ids=str)
def test_find_cycles_matches_jax(coords, cycles):
    try:
        want = jgraphx.find_cycles(coords, cycles, CARBON, PX2ANG)
    except ValueError:          # no ring of those sizes: both raise
        with pytest.raises(ValueError, match="concatenate"):
            graphx.find_cycles(coords, cycles, CARBON, PX2ANG)
        return
    assert np.array_equal(
        graphx.find_cycles(coords, cycles, CARBON, PX2ANG), want)


def _same_clusters(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(np.unique(g, axis=0), np.unique(w, axis=0))


@pytest.mark.parametrize("cycles", [12, list(range(7, 14)), [6, 12]],
                         ids=str)
def test_find_cycle_clusters_matches_jax(coords, cycles):
    got = graphx.find_cycle_clusters(coords, cycles, CARBON, PX2ANG)
    _same_clusters(got, jgraphx.find_cycle_clusters(coords, cycles, CARBON,
                                                    PX2ANG))
    for c in got:       # atoms in ascending id order: rows of ``coords``
        ids = native.knn_reference(coords[:, :2], c, 1)[1][:, 0]
        assert np.abs(coords[ids, :2] - c).max() < 1e-9
        assert (np.diff(ids) > 0).all()


def test_each_vacancy_is_one_twelve_ring_and_one_cluster():
    """Vacancies far apart and from the edges: each leaves one 12-member
    ring and one cluster centred on it."""
    xy = honeycomb(16, 10)
    centre = xy.mean(0)
    picks = [np.argmin(np.linalg.norm(xy - (centre + off), axis=1))
             for off in ([-9, -9], [9, 9], [-9, 9])]
    vac_xy = xy[picks]
    xy = np.delete(xy, picks, 0)
    coords = np.concatenate([xy / PX2ANG, np.zeros((len(xy), 1))], 1)
    twelve = graphx.find_cycles(coords, 12, CARBON, PX2ANG)
    assert twelve.shape == (3 * 12, 3)
    clusters = graphx.find_cycle_clusters(coords, list(range(7, 14)),
                                          CARBON, PX2ANG)
    assert len(clusters) == 3
    centres = np.array([c.mean(0) * PX2ANG for c in clusters])
    d = np.linalg.norm(centres[:, None] - vac_xy[None], axis=-1)
    assert np.allclose(np.sort(d.min(1)), 0, atol=1e-9)


def test_hexagon_matches_jax():
    cc = hexagon()
    assert np.array_equal(graphx.find_cycles(cc, 6, {0.0: "C"}, 1.0),
                          jgraphx.find_cycles(cc, 6, {0.0: "C"}, 1.0))
    got = graphx.find_cycle_clusters(cc, 6, {0.0: "C"}, 1.0)
    _same_clusters(got, jgraphx.find_cycle_clusters(cc, 6, {0.0: "C"}, 1.0))
    assert got[0].shape == (6, 2)
    cc2 = np.concatenate([cc, [[100.0, 100.0, 0.0]]], axis=0)
    assert graphx.filter_subgraphs(cc2, {0.0: "C"}, 1.0)[0].shape == (6, 3)


def test_filter_subgraphs_matches_jax(coords):
    # an island of three bonded atoms and a lone atom beside the lattice
    far = coords[:, :2].max(0) + 100
    extra = np.array([[far[0], far[1], 0], [far[0] + 13.6, far[1], 0],
                      [far[0] + 27.3, far[1], 0], [0, far[1] + 200, 0]])
    c = np.concatenate([coords, extra])
    frames = {0: c, 1: coords[::-1].copy()}
    got = graphx.filter_subgraphs(frames, CARBON, PX2ANG)
    want = jgraphx.filter_subgraphs(frames, CARBON, PX2ANG)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k])
    assert len(got[0]) == len(coords)


def test_graph_bonds_match_jax(coords):
    """Same bonds (each atom's bonded ids as a set), the port's lists in
    ascending order; the node views agree."""
    c = coords.copy()
    c[:, :2] *= PX2ANG
    g, jg = graphx.Graph(c, CARBON), jgraphx.Graph(c, CARBON)
    g.find_neighbors(expand=1.2)
    jg.find_neighbors(expand=1.2)
    assert [sorted(a) for a in jg.adjacency] == g.adjacency
    assert all(len(v.neighbors) == len(g.adjacency[v.id])
               for v in g.vertices)
    assert [v.pos for v in g.vertices] == [v.pos for v in jg.vertices]


def test_two_species_and_3d_coordinates_match_jax():
    """Bonds between species use each pair's covalent cutoff; (n, 4)
    [x, y, z, class] coordinates keep their z."""
    rng = np.random.RandomState(3)
    xyz = np.concatenate([rng.uniform(0, 25, (120, 2)),
                          rng.uniform(0, 1.5, (120, 1)),
                          rng.randint(0, 2, (120, 1))], 1)
    species = {0: "Mo", 1: "S"}
    g, jg = graphx.Graph(xyz, species), jgraphx.Graph(xyz, species)
    g.find_neighbors(expand=1.1)
    jg.find_neighbors(expand=1.1)
    assert [sorted(a) for a in jg.adjacency] == g.adjacency
    assert sum(map(len, g.adjacency)) > 0
    g.polycount_native(max_depth=6)
    jg.polycount_native(max_depth=6)
    assert sorted(tuple(sorted(v.id for v in r)) for r in g.rings) == \
        sorted(tuple(sorted(v.id for v in r)) for r in jg.rings)


def _adjacency(coords):
    c = coords.copy()
    c[:, :2] *= PX2ANG
    g = graphx.Graph(c, CARBON)
    g.find_neighbors()
    return g


def _random_graph(n, degree, seed):
    """A random graph with ascending adjacency lists (not a lattice:
    triangles, squares and chords of every kind)."""
    rng = np.random.RandomState(seed)
    pairs = {tuple(sorted(p)) for p in rng.randint(0, n, (n * degree, 2))
             if p[0] != p[1]}
    adj = [[] for _ in range(n)]
    for a, b in sorted(pairs):
        adj[a].append(b)
        adj[b].append(a)
    return [sorted(a) for a in adj]


GRAPHS = {
    "honeycomb": lambda: _adjacency(lattice(seed=0)).adjacency,
    "random_sparse": lambda: _random_graph(60, 2, 0),
    "random_dense": lambda: _random_graph(30, 3, 1),
}


@pytest.mark.parametrize("filled", [True, False])
@pytest.mark.parametrize("depth", [3, 6, 8])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_find_rings_native_matches_reference(graph, depth, filled):
    adj = GRAPHS[graph]()
    got = native.find_rings_native(adj, depth, filled)
    assert got == native.find_rings_reference(adj, depth, filled)


def test_ring_search_matches_jax_at_depth_12():
    g = _adjacency(lattice(seed=1))
    rings_ = native.find_rings_native(g.adjacency, 12)
    jg = jgraphx.Graph(g.coordinates, CARBON)
    jg.find_neighbors()
    jg.polycount_native(12)
    assert sorted(map(sorted, rings_)) == \
        sorted(sorted(v.id for v in r) for r in jg.rings)
    # the plain search through the Graph's own methods
    g.polycount(12)
    g.remove_filled_polygons()
    assert [[v.id for v in r] for r in g.rings] == rings_


def test_find_rings_through_a_vertex():
    g = _adjacency(lattice(vacancies=0))
    xy = g.coordinates[:, :2]
    v = g.vertices[int(np.argmin(np.linalg.norm(xy - xy.mean(0), axis=1)))]
    through = g.find_rings(v, 6)
    assert len(through) == 3 and all(v in r for r in through)


def test_rings_to_nx_graph_and_nx_graph_match_jax():
    c = lattice(seed=0)
    c[:, :2] *= PX2ANG
    g, jg = graphx.Graph(c, CARBON), jgraphx.Graph(c, CARBON)
    for G in (g, jg):
        G.find_neighbors()
        G.polycount_native(12)
    a, b = g.rings_to_nx_graph(list(range(7, 14))), \
        jg.rings_to_nx_graph(list(range(7, 14)))
    assert sorted(a.nodes) == sorted(b.nodes)
    assert sorted(map(sorted, a.edges)) == sorted(map(sorted, b.edges))
    nodes, edges = g.ring_nodes_edges(list(range(7, 14)))
    assert nodes.tolist() == sorted(a.nodes)
    assert sorted(map(tuple, edges.tolist())) == \
        sorted(map(tuple, map(sorted, a.edges)))
    assert sorted(map(sorted, g.nx_graph().edges)) == \
        sorted(map(sorted, jg.nx_graph().edges))


def test_interatomic_r():
    for atoms, expand in ((["C", "C"], None), (["C", "C"], 1.2),
                          (("Mo", "S"), 1.1)):
        assert graphx.get_interatomic_r(atoms, expand) == \
            jgraphx.get_interatomic_r(atoms, expand)


def test_plot_graph_writes_its_file(tmp_path):
    c = lattice(6, 4, vacancies=1)
    c[:, :2] *= PX2ANG
    g = graphx.Graph(c, CARBON)
    g.find_neighbors()
    path = str(tmp_path / "graph.png")
    graphx.plot_graph(g, np.zeros((8, 8)), show_labels=True,
                      show_elements=True, savefig=path)
    assert os.path.getsize(path) > 0


def test_rings_need_gxx(monkeypatch):
    monkeypatch.setattr(rings, "_lib", None)
    monkeypatch.setattr(rings.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.find_rings_native([[1], [0]], 6)


# ball and pair queries ---------------------------------------------------

def _points(kind):
    rng = np.random.RandomState(7)
    if kind == "lattice":
        return lattice(seed=3)[:, :2]
    if kind == "uniform3d":
        return rng.uniform(0, 20, (400, 3))
    return rng.uniform(0, 50, (500, 2))     # "uniform2d"


@pytest.mark.parametrize("r", [0.5, 13.7, 30.0])
@pytest.mark.parametrize("kind", ["lattice", "uniform2d", "uniform3d"])
def test_ball_query_matches_ckdtree_and_jax(kind, r):
    pts = _points(kind)
    q = pts[::7] + 0.3
    got = native.ball_query(pts, q, r)
    for want in (native.ball_query_reference(pts, q, r),
                 jneighbors.ball_query(pts, q, r)):
        assert len(got) == len(want)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(a.dtype == np.int64 for a in got)


@pytest.mark.parametrize("r", [0.5, 13.7, 30.0])
@pytest.mark.parametrize("kind", ["lattice", "uniform2d", "uniform3d"])
def test_query_pairs_matches_ckdtree_and_jax(kind, r):
    pts = _points(kind)
    got = native.query_pairs(pts, r)
    assert np.array_equal(got, native.query_pairs_reference(pts, r))
    want = jneighbors.query_pairs(pts, r)
    assert np.array_equal(got, want[np.lexsort((want[:, 1], want[:, 0]))])
    assert got.dtype == np.int64 and (got[:, 0] < got[:, 1]).all()


def test_queries_on_no_points():
    assert [len(b) for b in native.ball_query(np.empty((0, 2)),
                                              np.zeros((3, 2)), 1.0)] == \
        [0, 0, 0]
    assert native.query_pairs(np.empty((0, 2)), 1.0).shape == (0, 2)
    assert native.query_pairs(np.zeros((1, 2)), 1.0).shape == (0, 2)
    with pytest.raises(ValueError, match="points"):
        neighbors.query_pairs(np.zeros((3, 4)), 1.0)
