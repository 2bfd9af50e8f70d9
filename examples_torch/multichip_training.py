"""Multi-device training and prediction: one process a device.

The PyTorch counterpart of ``examples/multichip_training.py``. JAX drives
every chip from one process; the port starts one rank a device
(``atomai_tpu_torch.parallel.launch``) and every rank makes the same calls.
In a world of several ranks the port splits the work by default: each
batch over the ranks of a data mesh (gradients, BatchNorm and the losses
over the global batch), ensemble members and independent GP outputs over
a model mesh, and a prediction's frames over the data mesh. ``mesh=False``
opts out, a ``core.mesh.get_mesh(...)`` mesh is used as given.

    python examples_torch/multichip_training.py [--ranks 2] [--device cpu]
        [--backend gloo] [--smoke] [--out DIR]

On the card each rank takes a card of its own (NCCL); ``--backend gloo``
puts several ranks on one card.
"""

import contextlib
import io
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _cli import parse  # noqa: E402

import atomai_tpu_torch as aoi  # noqa: E402


def train(rank, device, smoke, out):
    """The workflow, in every rank; rank 0 reports."""
    def report(*args):
        if rank == 0:
            print(*args, flush=True)

    n_images, cycles = (8, 3) if smoke else (24, 10)
    imgs, masks, _ = aoi.utils.make_lattice_stack(n_images, 64, 12, seed=1)
    quiet = contextlib.redirect_stdout(io.StringIO())

    # 1. data parallelism is the default: each rank takes its block of
    # every batch (8 frames: 4 a rank at two ranks)
    model = aoi.models.Segmentor("Unet", 1, nb_filters=4,
                                 layers=[1, 1, 1, 1], device=device)
    with quiet:
        model.fit(imgs, masks, training_cycles=cycles, batch_size=8,
                  print_loss=cycles, filename=os.path.join(out, "seg"))
    report("segmentor data mesh:", tuple(model.mesh.shape),
           "final loss:", round(model.loss_acc["train_loss"][-1], 4))

    # 2. the VAE engine splits its minibatches the same way
    rvae = aoi.models.rVAE((16, 16), latent_dim=2, numlayers_encoder=1,
                           numhidden_encoder=32, numlayers_decoder=1,
                           numhidden_decoder=32, device=device)
    patches = np.random.RandomState(0).rand(64, 16, 16).astype(np.float32)
    rvae.fit(patches, training_cycles=2 if smoke else 3, batch_size=16,
             filename=os.path.join(out, "rvae"), verbose=False)
    report("rVAE data mesh:", tuple(rvae.mesh.shape))

    # 3. ensemble members spread over the ranks; every rank gets them all
    et = aoi.trainers.EnsembleTrainer("Unet", nb_classes=1, nb_filters=4,
                                      layers=[1, 1, 1, 1], device=device)
    et.compile_ensemble_trainer(training_cycles=2 if smoke else 4,
                                batch_size=4,
                                filename=os.path.join(out, "ens"))
    with quiet:
        net, ensemble = et.train_ensemble_from_scratch(imgs, masks,
                                                       n_models=4)
    report("ensemble members on every rank:", len(ensemble),
           "member mesh:", tuple(et._resolve_mesh(4).shape))

    # 4. independent-output DKL: the outputs spread over the ranks
    rng = np.random.RandomState(0)
    X = rng.randn(48, 8).astype(np.float32)
    y = rng.randn(4, 48).astype(np.float32)       # 4 outputs -> 4 GPs
    gp = aoi.models.dklGPR(8, embedim=2, shared_embedding_space=False,
                           device=device)
    with quiet:
        gp.fit(X, y, training_cycles=2 if smoke else 3, print_loss=3)
    report("DKL model mesh:", tuple(gp.model_mesh.shape))

    # 5. prediction splits the frames and gathers the maps on every rank
    maps = model.predict(imgs, compute_coords=False, verbose=False)
    report("tiled predict output:", maps.shape)
    return maps.shape


def main(argv=None):
    args = parse(__doc__, argv, plot=False, options={
        "ranks": (int, 2, "processes, one a device (default 2)"),
        "backend": (str, None, '"nccl" (the card\'s default) or "gloo"')})
    shapes = aoi.parallel.launch(
        train, args.ranks, args.device,
        args=(args.device, args.smoke, args.out), backend=args.backend)
    print(f"{args.ranks} ranks ended with maps of one shape:",
          all(s == shapes[0] for s in shapes))


if __name__ == "__main__":
    main()
