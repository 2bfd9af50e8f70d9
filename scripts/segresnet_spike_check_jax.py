"""The JAX package's SegResNet on the protocol of
``scripts/segresnet_spike_check.py`` (chip_smoke.py phase 20's data and
schedule: config A's 64 frames of 256², 300 Adam(1e-3) cycles of batch 32,
held-out IoU on 8 frames against the 0.90 gate), on the CPU in float32.

XLA on the CPU is deterministic, so a run repeated with one seed repeats
its losses; run ``r`` takes ``seed = first_seed + r`` (weights and batch
order). Runs start until ``--minutes`` have passed. One JSON line a run:
the seed, the held-out IoU, the last train loss and the largest train loss
after cycle 100 with its cycle (a loss spike: a jump from ≈ 0.02 to
0.5-0.9 within two cycles on the card); ``--out FILE`` also writes every
run with its per-cycle losses to FILE.

    JAX_PLATFORMS=cpu python3 scripts/segresnet_spike_check_jax.py \
        [--minutes 30] [--first-seed 1] [--out FILE]
"""
import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402  (numpy-only at import)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--minutes", type=float, default=30.0)
    parser.add_argument("--first-seed", type=int, default=1)
    parser.add_argument("--out")
    args = parser.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import atomai_tpu as aoi
    from atomai_tpu.utils import make_lattice_stack
    imgs, masks, _ = make_lattice_stack(**cs.MAIN)
    h_imgs, h_masks, _ = make_lattice_stack(**cs.HELD_OUT)
    t_end = time.time() + 60 * args.minutes
    out, run = [], 0
    while time.time() < t_end:
        seed = args.first_seed + run
        t0 = time.time()
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(io.StringIO()):
            m = aoi.models.Segmentor("SegResNet", 1, seed=seed)
            m.fit(imgs, masks, training_cycles=cs.SEG_CYCLES,
                  batch_size=cs.SEG_BATCH, print_loss=cs.SEG_CYCLES,
                  filename=tmp + "/seg")
        hist = [float(v) for v in m.loss_acc["train_loss"]]
        p = m.predict(h_imgs, compute_coords=False, verbose=False)
        p = np.asarray(p)[..., 0]
        r = {"run": run, "seed": seed, "iou": cs.mean_jaccard(p, h_masks),
             "gate": cs.TOL_IOU, "loss_first": hist[0],
             "loss_last": hist[-1],
             "argmax_loss_after_100": int(np.argmax(hist[100:]) + 100),
             "max_loss_after_100": max(hist[100:]),
             "min_loss_before_max": min(hist[100:int(np.argmax(
                 hist[100:]) + 101)]),
             "fit_s": time.time() - t0, "hist": hist}
        out.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "hist"}),
              flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f)
        run += 1


if __name__ == "__main__":
    main()
