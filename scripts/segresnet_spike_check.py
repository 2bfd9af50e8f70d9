"""SegResNet on chip_smoke.py phase 20's data and schedule (config A's
64 frames of 256², 300 Adam(1e-3) cycles of batch 32, the mixed policy),
ten runs on one CUDA card: each run's held-out IoU (phase 20's gate is
0.90), its last train loss, and the largest train loss after cycle 100
with its cycle (a loss spike); for a run below the gate, the IoU with the
BatchNorm statistics re-estimated over the training frames and each
BatchNorm's running statistics against that estimate. One JSON line a
run; ``--out FILE`` also writes every run with its per-cycle losses to
FILE. ``--f32`` trains in float32 with TF32 off instead of the card's
mixed policy.

    python3 scripts/segresnet_spike_check.py [--f32] [--out FILE]
"""
import argparse
import contextlib
import copy
import io
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import chip_smoke as cs
from atomai_tpu_torch import models
from atomai_tpu_torch.core import Precision
from atomai_tpu_torch.utils import make_lattice_stack

def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--f32", action="store_true")
    parser.add_argument("--out")
    args = parser.parse_args()
    d = torch.device("cuda", 0)
    torch.cuda.set_device(d)
    cs.phase_device(d)
    imgs, masks, _ = make_lattice_stack(**cs.MAIN)
    h_imgs, h_masks, h_xy = make_lattice_stack(**cs.HELD_OUT)
    out = []
    for run in range(10):
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(io.StringIO()):
            m = models.Segmentor("SegResNet", 1, seed=1, device=d)
            if args.f32:
                m.precision = Precision.full()
            m.fit(imgs, masks, training_cycles=cs.SEG_CYCLES,
                  batch_size=cs.SEG_BATCH, print_loss=cs.SEG_CYCLES,
                  filename=tmp + "/seg")
        hist = [float(v) for v in m.loss_acc["train_loss"]]
        p = m.predict(h_imgs, compute_coords=False, verbose=False)[..., 0]
        r = {"run": run, "iou": cs.mean_jaccard(p, h_masks),
             "loss_last": hist[-1], "argmax_loss_after_100":
             int(np.argmax(hist[100:]) + 100), "max_loss_after_100":
             max(hist[100:]), "hist": hist}
        if r["iou"] < cs.TOL_IOU:
            net = m.net
            stats = {n: (b.running_mean.clone(), b.running_var.clone())
                     for n, b in net.named_modules()
                     if isinstance(b, torch.nn.BatchNorm2d)}
            saved = copy.deepcopy(net.state_dict())
            for b in net.modules():
                if isinstance(b, torch.nn.BatchNorm2d):
                    b.reset_running_stats()
                    b.momentum = None
            net.train()
            with torch.no_grad(), m.precision.scope(d):
                xt = torch.from_numpy(imgs).float()
                for i in range(0, 64, 32):
                    net(xt[i:i + 32, None].to(d))
            fresh = {n: (b.running_mean.clone(), b.running_var.clone())
                     for n, b in net.named_modules()
                     if isinstance(b, torch.nn.BatchNorm2d)}
            p2 = m.predict(h_imgs, compute_coords=False, verbose=False)[..., 0]
            r["iou_bn_reestimated"] = cs.mean_jaccard(p2, h_masks)
            r["bn_stats_vs_fresh"] = {
                n: [float((stats[n][0] - fresh[n][0]).abs().max()),
                    float((stats[n][1] / fresh[n][1]).max()),
                    float((stats[n][1] / fresh[n][1]).min())] for n in stats}
            net.load_state_dict(saved)
        out.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "hist"}),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
