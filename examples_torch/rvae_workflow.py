"""A rotationally invariant VAE on atom-centred patches, on the card: a
synthetic lattice movie -> patches around the atoms -> ``rVAE.fit`` (its
decoder on the fused spatial-MLP kernels) -> latent encoding -> the
learned manifold.

The PyTorch counterpart of ``examples/rvae_workflow.py``.

    python examples_torch/rvae_workflow.py [--device cpu] [--smoke]
        [--plot] [--out DIR]
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _cli import parse  # noqa: E402

import atomai_tpu_torch as aoi  # noqa: E402


def main(argv=None):
    args = parse(__doc__, argv)
    n_frames, cycles = (2, 3) if args.smoke else (4, 30)
    net_kw = dict(numlayers_encoder=1, numhidden_encoder=64,
                  numlayers_decoder=1, numhidden_decoder=64) \
        if args.smoke else {}

    # patches around the atoms of a synthetic lattice movie
    images, _, coords = aoi.utils.make_lattice_stack(
        n_images=n_frames, size=128, spacing=14, seed=1)
    coord_dict = {i: np.concatenate([c, np.zeros((len(c), 1))], -1)
                  for i, c in enumerate(coords)}
    patches, _, _ = aoi.utils.extract_subimages(images[..., None],
                                                coord_dict, window_size=24)
    patches = patches[..., 0]
    print("patches:", patches.shape)

    rvae = aoi.models.rVAE((24, 24), latent_dim=2, device=args.device,
                           **net_kw)
    with tempfile.TemporaryDirectory() as tmp:
        rvae.fit(patches, training_cycles=cycles, batch_size=64,
                 rotation_prior=np.pi / 4, filename=os.path.join(tmp, "rvae"))

    # latents: the angle, two translations, then the content
    z_mean, z_sd = rvae.encode(patches)
    print("latent mean:", z_mean.shape, "(angle + dx,dy + content)")

    # the manifold over the two content latents
    manifold = rvae.manifold2d(d=6, savefig=args.plot, savedir=args.out)
    print("manifold image:", manifold.shape)


if __name__ == "__main__":
    main()
