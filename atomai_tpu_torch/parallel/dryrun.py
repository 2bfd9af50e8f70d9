"""Drives the production multi-device paths on n ranks.

Counterpart of `__graft_entry__.dryrun_multichip` (`:119-202`), at its
shapes, in every rank of a world of n (``parallel.launch``):

(a) ``Segmentor.fit`` on an (n, 1) data mesh, the one the automatic
    resolution gives its batch of 2n (batches split over the data axis,
    BatchNorm and the loss over the global batch, gradients averaged);
(b) ``EnsembleTrainer`` members over the model axis of a (1, n) mesh;
(c) the rVAE's data parallelism on the (n, 1) data mesh;
(d) the independent-output DKL, the outputs over the (1, n) mesh.

The meshes are explicit, so ``AOI_AUTO_MESH`` does not change what runs.

Every rank must end with the same model, so each path's losses are held
equal across the ranks; :func:`paths` with ``mesh=False`` gives one
process's numbers at the same shapes. Run it with

    python -m atomai_tpu_torch.parallel.dryrun 2 --device cpu

(``--device cuda`` runs a rank a card; ``--backend gloo`` puts several
ranks on one card, which NCCL refuses).
"""

import argparse
import contextlib
import io
import os
import tempfile
from typing import Optional

import numpy as np


def paths(n: int, device: str, mesh: bool = True) -> dict:
    """The four paths at the shapes of a world of ``n``, in this process:
    on their meshes (``mesh=True``: an (n, 1) data mesh and a (1, n)
    model mesh, which need a process group of n ranks) or with
    ``mesh=False`` everywhere (one process's numbers, to hold the meshes'
    against). Their meshes' shapes and losses."""
    from .. import models
    from ..core.mesh import get_mesh
    from ..trainers import EnsembleTrainer
    data_mesh = get_mesh(n_data=n, n_model=1) if mesh else False
    model_mesh = get_mesh(n_data=1, n_model=n) if mesh else False
    rng = np.random.RandomState(0)
    H = W = 16
    out = {}
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        # (a) supervised fit on the data mesh
        Xs = rng.rand(n * 4, H, W).astype(np.float32)
        ys = (rng.rand(n * 4, H, W) > .5).astype(np.float32)
        seg = models.Segmentor("Unet", nb_classes=1, nb_filters=4,
                               layers=[1, 1, 1, 1], seed=1, device=device)
        seg.fit(Xs, ys, training_cycles=2, batch_size=n * 2, print_loss=2,
                filename=os.path.join(tmp, "seg"), mesh=data_mesh)
        out["seg_mesh"] = _shape(seg.mesh)
        out["seg_loss"] = list(seg.loss_acc["train_loss"])

        # (b) ensemble members over the model axis
        n_members = max(n, 2)
        et = EnsembleTrainer("Unet", nb_classes=1, nb_filters=4,
                             layers=[1, 1, 1, 1], device=device)
        et.compile_ensemble_trainer(
            training_cycles=2, batch_size=max(n // 2, 2),
            filename=os.path.join(tmp, "ens"),
            mesh=model_mesh)
        _, ensemble = et.train_ensemble_from_scratch(Xs, ys,
                                                     n_models=n_members)
        _check(len(ensemble) == n_members, "ensemble members missing")
        out["ens_mesh"] = _shape(et._resolve_mesh(n_members))
        out["ens_loss"] = list(et.loss_acc["train_loss"])

        # (c) the VAE engine's data parallelism
        rvae = models.rVAE((8, 8), latent_dim=2, seed=1,
                           numlayers_encoder=1, numhidden_encoder=16,
                           numlayers_decoder=1, numhidden_decoder=16,
                           device=device)
        Xv = rng.rand(n * 4, 8, 8).astype(np.float32)
        rvae.fit(Xv, training_cycles=2, batch_size=n * 2,
                 filename=os.path.join(tmp, "rvae"), mesh=data_mesh)
        out["rvae_mesh"] = _shape(rvae.mesh)
        out["rvae_loss"] = list(rvae.loss_history["train_loss"])

        # (d) independent-output DKL, the outputs over the model axis
        Xg = rng.randn(24, 8).astype(np.float32)
        yg = rng.randn(n, 24).astype(np.float32)
        gp = models.dklGPR(8, embedim=2, shared_embedding_space=False,
                           seed=1, device=device)
        gp.fit(Xg, yg, training_cycles=2, print_loss=2, mesh=model_mesh)
        out["dkl_mesh"] = _shape(gp.model_mesh)
        out["dkl_loss"] = list(gp.train_loss)
    for k, v in out.items():
        if k.endswith("_loss"):
            _check(v and np.isfinite(v).all(), f"non-finite {k}: {v}")
    if mesh:
        _check(out["seg_mesh"] == out["rvae_mesh"] == (n, 1) and
               out["ens_mesh"] == out["dkl_mesh"] == (1, n),
               f"the paths' meshes: {out}")
    return out


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _shape(mesh):
    return None if mesh is None else tuple(mesh.shape)


def _dryrun_rank(rank: int, n: int, device: str) -> dict:
    return paths(n, device)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: Optional[str] = None,
                     deadline: Optional[float] = None) -> dict:
    """Runs the four paths in ``n_devices`` ranks on ``device`` ("cpu" or
    "cuda"; ``deadline``: seconds until the launch fails), checks that
    every rank ended with the same losses, prints a summary line and
    returns rank 0's results."""
    from . import dryrun
    from .launch import launch
    results = launch(dryrun._dryrun_rank, n_devices, device,
                     args=(n_devices, device), backend=backend,
                     deadline=deadline)
    for r, res in enumerate(results[1:], 1):
        for k, v in res.items():
            _check(v == results[0][k], f"rank {r}'s {k} differs: {v} "
                   f"against rank 0's {results[0][k]}")
    res = results[0]
    print(f"dryrun_multichip OK: seg_mesh={res['seg_mesh']} "
          f"ens_mesh={res['ens_mesh']} members={max(n_devices, 2)} "
          f"rvae_mesh={res['rvae_mesh']} dkl_mesh={res['dkl_mesh']}")
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, help="ranks (devices)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    a = p.parse_args(argv)
    dryrun_multichip(a.n, a.device, a.backend)


if __name__ == "__main__":
    main()
