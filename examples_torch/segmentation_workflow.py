"""Atom finding end to end on the card: a synthetic lattice ->
``Segmentor("Unet").fit`` with augmentation and SWA (``--remat``:
recompute each block's activations in the backward) -> ``predict`` (the
connected-component labeller) -> atomic coordinates -> refinement ->
local-descriptor statistics.

The PyTorch counterpart of ``examples/segmentation_workflow.py``.

    python examples_torch/segmentation_workflow.py [--device cpu] [--smoke]
        [--remat] [--plot] [--out DIR]
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _cli import parse  # noqa: E402

import atomai_tpu_torch as aoi  # noqa: E402


def main(argv=None):
    args = parse(__doc__, argv, flags={
        "remat": "recompute each block's activations in the backward"})
    n_images, size, cycles = (8, 64, 40) if args.smoke else (16, 96, 80)
    net_kw = dict(nb_filters=8, layers=[1, 1, 1, 1]) if args.smoke else {}

    # synthetic training data: graphene-like lattices and their masks
    images, masks, true_coords = aoi.utils.make_lattice_stack(
        n_images=n_images, size=size, spacing=12, seed=0)

    # a Unet with SWA and rotation / noise augmentation on the device
    model = aoi.models.Segmentor("Unet", nb_classes=1, device=args.device,
                                 **net_kw)
    with tempfile.TemporaryDirectory() as tmp:
        model.fit(images, masks, training_cycles=cycles, batch_size=8,
                  swa=True, compute_accuracy=True, print_loss=cycles // 2,
                  rotation=True, gauss_noise=[10, 40], remat=args.remat,
                  filename=os.path.join(tmp, "seg"))

    # predict and locate atoms on new data
    nn_output, coordinates = model.predict(images[:4], verbose=False)
    print("NN output:", nn_output.shape)
    print("atoms in frame 0:", len(coordinates[0]))

    # position accuracy against the truth
    from scipy.spatial import cKDTree
    d, _ = cKDTree(true_coords[0]).query(coordinates[0][:, :2])
    print("median position error: %.2f px" % np.median(d))

    # batched 2D-Gaussian refinement of the positions
    refined = aoi.utils.peak_refinement(images[0], coordinates[0], d=6,
                                        device=args.device)
    print("refined coordinates:", refined.shape)

    # local-descriptor statistics around the located atoms
    imstack = aoi.stat.imlocal(nn_output, coordinates, window_size=16,
                               coord_class=0, device=args.device)
    components, projections, centers = imstack.pca(3)
    print("PCA components:", components.shape)

    if args.plot:
        aoi.utils.plot_coord(images[0], coordinates[0],
                             savefig=os.path.join(args.out, "atoms.png"))
        print("figure written:", os.path.join(args.out, "atoms.png"))


if __name__ == "__main__":
    main()
