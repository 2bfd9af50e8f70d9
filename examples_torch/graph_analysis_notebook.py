"""Graph analysis of an atomic lattice, on the card: a graphene frame with
one vacancy rendered as a mask -> its atoms by ``find_com`` (the
connected-component labeller) -> the bond graph from covalent radii ->
rings, and the cluster of defect rings around the vacancy -> a POSCAR
file of the structure.

The PyTorch counterpart of ``examples/graph_analysis_notebook.py`` (after
the original atomai's GraphAnalysis notebook; its pretrained model and
STEM image are not in the repository, so the frame is drawn here).

    python examples_torch/graph_analysis_notebook.py [--device cpu]
        [--smoke] [--plot] [--out DIR]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _cli import parse  # noqa: E402

import atomai_tpu_torch as aoi  # noqa: E402

CC_BOND_ANG = 1.42   # graphene's C-C bond
PX2ANG = 0.104       # the notebook's pixel size


def honeycomb(nx_cells, ny_cells):
    """Honeycomb coordinates (angstrom), two atoms a cell."""
    a1 = np.array([3 / 2, np.sqrt(3) / 2]) * CC_BOND_ANG
    a2 = np.array([3 / 2, -np.sqrt(3) / 2]) * CC_BOND_ANG
    return np.asarray([i * a1 + j * a2 + b
                       for i in range(nx_cells)
                       for j in range(-ny_cells, ny_cells)
                       for b in (np.zeros(2), np.array([CC_BOND_ANG, 0.0]))])


def main(argv=None):
    args = parse(__doc__, argv)
    cells = (7, 5) if args.smoke else (14, 10)
    xy = honeycomb(*cells)
    center = xy.mean(0)
    vacancy = np.argmin(np.linalg.norm(xy - center, axis=1))
    xy = np.delete(xy, vacancy, axis=0)
    print("atoms: %d, one removed to make a vacancy" % len(xy))

    # 1-2. the frame as a mask, its atoms located by the labeller
    px = xy / PX2ANG
    px = px - px.min(0) + 12
    size = int(px.max()) + 13
    mask = aoi.utils.create_lattice_mask(np.zeros((size, size), np.float32),
                                         px)
    com = aoi.utils.find_com(mask, device=args.device)
    print("atoms found in the %d x %d mask: %d" % (size, size, len(com)))
    coord = np.concatenate([com, np.zeros((len(com), 1))], axis=1)
    map_dict = {0: "C"}

    # 3. rings: the vacancy merges three hexagons into one 12-member ring
    rings6 = aoi.utils.find_cycles(coord, 6, map_dict, PX2ANG)
    print("6-ring atoms found:", len(rings6))
    clusters = aoi.utils.find_cycle_clusters(coord, 12, map_dict, PX2ANG)
    print("defect clusters:", len(clusters))
    if not clusters:
        raise RuntimeError("the vacancy's 12-member ring was not found")
    off = np.linalg.norm(clusters[0][:, :2].mean(0) -
                         ((center / PX2ANG) - (xy / PX2ANG).min(0) + 12))
    print("defect ring centred %.2f A from the vacancy" % (off * PX2ANG))

    # 4. the overlay (a file, in place of the notebook's display)
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 8))
        ax.imshow(mask, cmap="gray")
        for i, cl in enumerate(clusters):
            ax.scatter(cl[:, 1], cl[:, 0], s=16, color="red")
            ax.annotate(str(i + 1), (cl[:, 1].mean(), cl[:, 0].mean()),
                        size=10, color="yellow")
        fig.savefig(os.path.join(args.out, "graph_defects.png"), dpi=120)
        plt.close(fig)
        print("figure written:",
              os.path.join(args.out, "graph_defects.png"))

    # the structure for ab initio tools
    frame = {0: np.concatenate([coord[:, :2], np.zeros((len(coord), 1)),
                                coord[:, 2:]], axis=1)}
    path = os.path.join(args.out, "graphene_vacancy.POSCAR")
    aoi.utils.ase_obj_basic(frame, 0, "graphene", map_dict, filepath=path,
                            px2ang=PX2ANG)
    print("POSCAR written:", os.path.exists(path))


if __name__ == "__main__":
    main()
