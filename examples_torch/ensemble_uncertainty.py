"""Deep-ensemble uncertainty on the card: N segmentation Unets trained
one after another from distinct weights, the per-pixel mean and variance
of their predictions, and each atom's position spread over the members
(``ensemble_locate``: one labeller launch for every member's maps).

The PyTorch counterpart of ``examples/ensemble_uncertainty.py`` (whose
members train together under ``vmap``; the port's train in a loop).

    python examples_torch/ensemble_uncertainty.py [--device cpu] [--smoke]
        [--out DIR]
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _cli import parse  # noqa: E402

import atomai_tpu_torch as aoi  # noqa: E402


def main(argv=None):
    args = parse(__doc__, argv, plot=False)
    size, cycles, n_models = (32, 10, 2) if args.smoke else (48, 120, 4)
    net_kw = dict(nb_filters=8, layers=[1, 1, 1, 1]) if args.smoke else {}

    images, masks, _ = aoi.utils.make_lattice_stack(
        n_images=16, size=size, spacing=12, seed=0)

    etrainer = aoi.trainers.EnsembleTrainer("Unet", nb_classes=1,
                                            device=args.device, **net_kw)
    with tempfile.TemporaryDirectory() as tmp:
        etrainer.compile_ensemble_trainer(
            training_cycles=cycles, batch_size=8, swa=True,
            filename=os.path.join(tmp, "ens"))
        smodel, ensemble = etrainer.train_ensemble_from_scratch(
            images, masks, n_models=n_models,
            augment_fn=aoi.transforms.seg_augmentor(1, rotation=True,
                                                    gauss_noise=[10, 40]))

    # every member's prediction; mean and variance reduced on the device
    predictor = aoi.predictors.EnsemblePredictor(
        smodel, ensemble, nb_classes=1, verbose=0)
    mean, var = predictor.predict(images[:4])
    print("prediction mean:", mean.shape, "variance:", var.shape)
    print("mean pixel uncertainty: %.4f" % float(var.mean()))

    # each atom's position over the members, clustered (DBSCAN)
    member_preds = predictor.ensemble_forward(
        predictor.preprocess(images[:1]))
    coord_mean, coord_var = aoi.predictors.ensemble_locate(
        member_preds, threshold=0.5, eps=1.5,
        min_samples=min(n_models, 10), device=args.device)
    print("frame-0 atoms:", len(coord_mean[0]),
          "mean position spread: %.3f px" % float(np.mean(coord_var[0])))


if __name__ == "__main__":
    main()
