"""Lattice graphs of atomic coordinates: bonds from covalent radii, rings,
ring clusters and the largest connected subgraph (counterpart of
`atomai_tpu/utils/graphx.py`).

- Bonds: one sweep of :func:`native.query_pairs` at the largest
  species-pair cutoff, then a filter against each pair's cutoff. The pairs
  come sorted, so every adjacency list is in ascending order.
- Rings: :func:`native.find_rings_native` (C++), always; its plain version
  :func:`native.find_rings_reference` is what ``Graph.polycount`` and
  ``remove_filled_polygons`` run. A missing ``g++`` raises: there is no
  fallback to the Python search.
- Clusters and subgraphs: connected components by
  ``scipy.sparse.csgraph``, ordered by their smallest atom id, each with
  its atoms in ascending id order. (networkx, which the JAX package uses
  there, lists the atoms of a small component in its hash-set order.)
  networkx stays for the functions that return or draw networkx objects
  (``rings_to_nx_graph``, ``nx_graph``, ``plot_graph``), imported when
  they run.
"""

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..native import find_rings_native, query_pairs
from ..native.rings import enumerate_cycles, is_chordless

# covalent radii in picometers (Cordero et al., Dalton Trans. 2008)
COVALENT_RADII_PM = {
    "H": 31, "He": 28, "Li": 128, "Be": 96, "B": 84, "C": 76, "N": 71,
    "O": 66, "F": 57, "Ne": 58, "Na": 166, "Mg": 141, "Al": 121,
    "Si": 111, "P": 107, "S": 105, "Cl": 102, "Ar": 106, "K": 203,
    "Ca": 176, "Sc": 170, "Ti": 160, "V": 153, "Cr": 139, "Mn": 139,
    "Fe": 132, "Co": 126, "Ni": 124, "Cu": 132, "Zn": 122, "Ga": 122,
    "Ge": 120, "As": 119, "Se": 120, "Br": 120, "Kr": 116, "Rb": 220,
    "Sr": 195, "Y": 190, "Zr": 175, "Nb": 164, "Mo": 154, "Tc": 147,
    "Ru": 146, "Rh": 142, "Pd": 139, "Ag": 145, "Cd": 144, "In": 142,
    "Sn": 139, "Sb": 139, "Te": 138, "I": 139, "Xe": 140, "Cs": 244,
    "Ba": 215, "La": 207, "Ce": 204, "Pr": 203, "Nd": 201, "Pm": 199,
    "Sm": 198, "Eu": 198, "Gd": 196, "Tb": 194, "Dy": 192, "Ho": 192,
    "Er": 189, "Tm": 190, "Yb": 187, "Lu": 187, "Hf": 175, "Ta": 170,
    "W": 162, "Re": 151, "Os": 144, "Ir": 141, "Pt": 136, "Au": 136,
    "Hg": 132, "Tl": 145, "Pb": 146, "Bi": 148, "Po": 140, "At": 150,
    "Rn": 150, "Mo2": 154,
}


class Node:
    """One atom of a :class:`Graph`: its id, position, element and bonded
    nodes (``neighbors``)."""

    def __init__(self, idx: int = 0, pos: Optional[List[float]] = None,
                 atom: str = "C") -> None:
        self.neighbors: List["Node"] = []
        self.id = idx
        self.pos = [] if pos is None else pos
        self.atom = atom


def _bond_pairs(coordinates: np.ndarray, species: np.ndarray,
                map_dict: Dict[float, str], expand: float) -> np.ndarray:
    """Bonded index pairs (k, 2), sorted: the pairs within the largest
    species-pair cutoff, kept where within their own pair's cutoff."""
    classes = np.unique(species)
    radii = np.array([COVALENT_RADII_PM[map_dict[c]] for c in classes],
                     float) / 100.0
    cutoff = expand * (radii[:, None] + radii[None, :])  # (c, c) angstrom
    class_idx = np.searchsorted(classes, species)
    pairs = query_pairs(coordinates, float(cutoff.max()))
    if pairs.size == 0:
        return pairs.reshape(0, 2)
    d = np.linalg.norm(coordinates[pairs[:, 0]] - coordinates[pairs[:, 1]],
                       axis=1)
    keep = d <= cutoff[class_idx[pairs[:, 0]], class_idx[pairs[:, 1]]]
    return pairs[keep]


def _components(n: int, edges: np.ndarray, nodes: np.ndarray
                ) -> List[np.ndarray]:
    """Connected components of the graph on ``nodes`` (ascending ids below
    n) with undirected ``edges`` (k, 2) among them: ordered by their
    smallest id, each in ascending id order."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    if len(nodes) == 0:
        return []
    adj = coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                     shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    labels = labels[nodes]
    # components numbered by their first (smallest) node
    _, first, inv = np.unique(labels, return_index=True,
                              return_inverse=True)
    rank = np.argsort(np.argsort(first))[inv]
    order = np.argsort(rank, kind="stable")
    bounds = np.flatnonzero(np.diff(rank[order])) + 1
    return np.split(nodes[order], bounds)


class Graph:
    """The bond graph of atomic coordinates (n, 3) [x, y, class] or (n, 4)
    [x, y, z, class] in angstrom; ``map_dict`` maps a class to its
    element. ``adjacency`` holds each atom's bonded ids in ascending
    order, ``vertices`` a :class:`Node` per atom and ``rings`` the rings
    found, as lists of nodes."""

    def __init__(self, coordinates: np.ndarray,
                 map_dict: Dict[float, str]) -> None:
        coordinates = np.asarray(coordinates, float)
        if coordinates.shape[-1] == 3:
            coordinates = np.concatenate(
                (coordinates[:, :2],
                 np.zeros_like(coordinates)[:, 0:1],
                 coordinates[:, 2:3]), axis=-1)
        self.coordinates = coordinates
        self.map_dict = map_dict
        self.size = len(coordinates)
        self.vertices: List[Node] = [
            Node(i, coordinates[i, :-1].tolist(),
                 map_dict[coordinates[i, -1]])
            for i in range(self.size)]
        self.adjacency: List[List[int]] = [[] for _ in range(self.size)]
        self.rings: List[List[Node]] = []

    def find_neighbors(self, **kwargs: float) -> None:
        """Bonds atoms closer than ``expand`` (default 1.2) times the sum
        of their covalent radii."""
        pairs = _bond_pairs(self.coordinates[:, :3],
                            self.coordinates[:, -1], self.map_dict,
                            kwargs.get("expand", 1.2))
        self.adjacency = [[] for _ in range(self.size)]
        for a, b in pairs.tolist():
            self.adjacency[a].append(b)
            self.adjacency[b].append(a)
        for v in self.vertices:
            v.neighbors = [self.vertices[i] for i in self.adjacency[v.id]]

    def _nodes(self, rings_ids: List[List[int]]) -> List[List[Node]]:
        return [[self.vertices[i] for i in ring] for ring in rings_ids]

    def find_rings(self, v: Node, max_depth: int) -> List[List[Node]]:
        """The simple cycles through ``v`` of up to ``max_depth`` members,
        each once."""
        return self._nodes([ring for ring in
                            enumerate_cycles(self.adjacency, max_depth)
                            if v.id in ring])

    def polycount(self, max_depth: int) -> None:
        """Every simple cycle of up to ``max_depth`` members, each once
        (the plain Python search)."""
        self.rings = self._nodes(enumerate_cycles(self.adjacency, max_depth))

    def polycount_native(self, max_depth: int,
                         filter_filled: bool = True) -> bool:
        """The rings of :meth:`polycount` (then
        :meth:`remove_filled_polygons` with ``filter_filled``) by the C++
        search; returns True, or raises where it cannot be built."""
        self.rings = self._nodes(find_rings_native(
            self.adjacency, max_depth, filter_filled))
        return True

    def remove_filled_polygons(self) -> None:
        """Keeps the chordless rings (no two members closer through the
        graph than along the ring)."""
        self.rings = [r for r in self.rings
                      if is_chordless(self.adjacency, [v.id for v in r])]

    def ring_nodes_edges(self, ring_size: Union[int, Sequence[int]]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """(nodes, edges) of the graph of the rings of the given size(s):
        their members bonded to their neighbours, then the nodes of fewer
        than two bonds dropped (once), as :meth:`rings_to_nx_graph` builds
        it. Nodes ascending, edges (k, 2) among them."""
        sizes = {ring_size} if isinstance(ring_size, int) else set(ring_size)
        members = sorted({v.id for ring in self.rings if len(ring) in sizes
                          for v in ring})
        edges = np.array([(min(i, w), max(i, w)) for i in members
                          for w in self.adjacency[i]], np.int64)
        if not len(edges):
            return np.empty(0, np.int64), np.empty((0, 2), np.int64)
        edges = np.unique(edges, axis=0)
        degree = np.bincount(edges.ravel(), minlength=self.size)
        kept = degree >= 2
        nodes = np.flatnonzero(kept)
        return nodes, edges[kept[edges[:, 0]] & kept[edges[:, 1]]]

    def _nx_nodes(self, ids, planar: bool):
        for i in ids:
            v = self.vertices[i]
            pos = tuple(v.pos[:2]) if planar else tuple(v.pos)
            yield v.id, {"pos": pos, "atom": v.atom}

    def rings_to_nx_graph(self, ring_size: Union[int, List[int]]):
        """The rings of the given size(s) as a networkx graph: their
        members and bonded neighbours, nodes of degree < 2 removed (the
        JAX package's graph; networkx is imported here)."""
        import networkx as nx
        sizes = {ring_size} if isinstance(ring_size, int) else set(ring_size)
        members = {v.id for ring in self.rings if len(ring) in sizes
                   for v in ring}
        closure = members | {w for i in members for w in self.adjacency[i]}
        g_nx = nx.Graph()
        g_nx.add_nodes_from(self._nx_nodes(sorted(closure), planar=False))
        g_nx.add_edges_from((i, w) for i in members
                            for w in self.adjacency[i])
        g_nx.remove_nodes_from(
            [node for node, degree in g_nx.degree() if degree < 2])
        return g_nx

    def nx_graph(self):
        """The whole graph as a networkx graph (2D positions when the
        lattice is planar; networkx is imported here)."""
        import networkx as nx
        planar = bool(np.all(
            self.coordinates[0, 2] == self.coordinates[:, 2]))
        g_nx = nx.Graph()
        g_nx.add_nodes_from(self._nx_nodes(range(self.size), planar))
        g_nx.add_edges_from((i, w) for i in range(self.size)
                            for w in self.adjacency[i])
        return g_nx


def get_interatomic_r(atoms: Union[Tuple[str, str], List[str]],
                      expand: Optional[float] = None) -> float:
    """Bond length (angstrom) of two elements: the sum of their covalent
    radii, times ``expand`` when given."""
    atom1, atom2 = atoms
    r12 = (COVALENT_RADII_PM[atom1] + COVALENT_RADII_PM[atom2]) / 100
    if expand:
        r12 = expand * r12
    return r12


def _graph_with_rings(coordinate_data: np.ndarray, cycles: List[int],
                map_dict: Dict[float, str], px2ang: float,
                expand: float) -> Tuple[np.ndarray, Graph]:
    """(coordinates in angstrom, the graph with its chordless rings of up
    to ``max(cycles)`` members)."""
    coordinates = np.array(coordinate_data, float)
    coordinates[:, :-1] = coordinates[:, :-1] * px2ang
    G = Graph(coordinates, map_dict)
    G.find_neighbors(expand=expand)
    G.polycount_native(max_depth=max(cycles))
    return coordinates, G


def find_cycles(coordinate_data: np.ndarray,
                cycles: Union[int, List[int]],
                map_dict: Dict[float, str], px2ang: float,
                **kwargs: float) -> np.ndarray:
    """The coordinates (pixels, [x, y, class]) of the atoms of every
    chordless ring of ``cycles`` members, ring after ring: rings by size,
    then by their three smallest ids."""
    if isinstance(cycles, int):
        cycles = [cycles]
    coordinates, G = _graph_with_rings(coordinate_data, cycles, map_dict, px2ang,
                                 kwargs.get("expand", 1.2))
    rl = [sorted(int(v.id) for v in r) for r in G.rings]
    rl = sorted(rl, key=lambda x: (len(x), x[0], x[1], x[2]))
    coordinates_ = np.concatenate([coordinates[r] for r in rl
                                   if len(r) in cycles])
    coordinates_[:, :-1] = coordinates_[:, :-1] * (1 / px2ang)
    return coordinates_


def find_cycle_clusters(coordinate_data: np.ndarray,
                        cycles: Union[int, List[int]],
                        map_dict: Dict[float, str], px2ang: float,
                        **kwargs: float) -> List[np.ndarray]:
    """Clusters of the rings of ``cycles`` members: the connected
    components of :meth:`Graph.ring_nodes_edges`, each as its atoms' (m, 2)
    pixel coordinates."""
    if isinstance(cycles, int):
        cycles = [cycles]
    coordinates, G = _graph_with_rings(coordinate_data, cycles, map_dict, px2ang,
                                 kwargs.get("expand", 1.2))
    nodes, edges = G.ring_nodes_edges(cycles)
    return [coordinates[c][:, :-1] * (1 / px2ang)
            for c in _components(G.size, edges, nodes)]


def plot_graph(G, img: Optional[np.ndarray] = None,
               fsize: Union[int, Tuple[int, int]] = 8,
               show_labels: bool = False, **kwargs) -> None:
    """Draws a :class:`Graph` (or a networkx graph) over ``img`` (``cmap``,
    ``node_size``, ``node_color``, ``edge_color``, ``alpha``,
    ``label_size``, ``label_color``, ``show_elements``; ``savefig``: a
    file to write). matplotlib and networkx are imported here."""
    import networkx as nx
    from .viz import _plt
    plt = _plt()
    fsize = fsize if isinstance(fsize, tuple) else (fsize, fsize)
    fig, ax = plt.subplots(1, 1, figsize=fsize)
    if isinstance(G, Graph):
        G = G.nx_graph()
    for k, v in nx.get_node_attributes(G, "pos").items():
        G.nodes[k]["pos"] = v[::-1]
    pos = nx.get_node_attributes(G, "pos")
    if img is not None:
        ax.imshow(img, origin="lower", cmap=kwargs.get("cmap", "gray"))
    nx.draw_networkx_nodes(
        G, pos=pos, nodelist=G.nodes(), ax=ax,
        node_size=kwargs.get("node_size", 30),
        node_color=kwargs.get("node_color", "#1f78b4"),
        alpha=kwargs.get("alpha"))
    nx.draw_networkx_edges(
        G, pos, width=1, ax=ax,
        edge_color=kwargs.get("edge_color", "orange"),
        alpha=kwargs.get("alpha"))
    if show_labels:
        atomic_labels = nx.get_node_attributes(G, "atom") \
            if kwargs.get("show_elements") else None
        nx.draw_networkx_labels(
            G, pos, labels=atomic_labels, ax=ax,
            font_size=kwargs.get("label_size", 7),
            font_color=kwargs.get("label_color", "black"))
    if kwargs.get("savefig"):
        fig.savefig(kwargs["savefig"])
    plt.close(fig)


def filter_subgraphs_(coordinate_arr: np.ndarray,
                      map_dict: Dict[float, str], px2ang: float,
                      **kwargs: float) -> np.ndarray:
    """The rows of ``coordinate_arr`` (pixels) whose atoms form the
    largest connected subgraph of the bond graph (the first of equal
    size, by smallest id), in ascending order."""
    coordinates = np.asarray(coordinate_arr, float).copy()
    scaled = coordinates.copy()
    scaled[:, :-1] *= px2ang
    G = Graph(scaled, map_dict)
    pairs = _bond_pairs(G.coordinates[:, :3], G.coordinates[:, -1],
                        map_dict, kwargs.get("expand", 1.2))
    comps = _components(G.size, pairs, np.arange(G.size))
    main = max(comps, key=len)      # max keeps the first of equal length
    return coordinates[main]


def filter_subgraphs(coordinates: Union[Dict[int, np.ndarray], np.ndarray],
                     map_dict: Dict[float, str], px2ang: float,
                     **kwargs: float) -> Dict[int, np.ndarray]:
    """:func:`filter_subgraphs_` of each frame of {frame: (n, 3)} (or of
    one array, as frame 0)."""
    if isinstance(coordinates, np.ndarray):
        coordinates = {0: coordinates}
    return {k: filter_subgraphs_(coord, map_dict, px2ang, **kwargs)
            for k, coord in coordinates.items()}
