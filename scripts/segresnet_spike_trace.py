"""SegResNet's loss spike, traced cycle by cycle on one CUDA card.

The same fit as ``scripts/segresnet_spike_check.py`` (chip_smoke.py phase
20: config A's 64 frames of 256², 300 Adam(1e-3) cycles of batch 32,
``Segmentor("SegResNet", 1, seed=1)``, the card's mixed policy or, with
``--f32``, float32 with TF32 off), with a record of every training cycle:

- the train loss and the global gradient norm;
- for each parameter, the norm of its Adam update and the smallest value
  of its second moment ``exp_avg_sq``;
- for each BatchNorm, the smallest batch variance over its channels (of
  the layer's input, in float32, biased), that channel's index and mean,
  beside ``eps`` = 1e-5.

It runs the fit up to ``--runs`` times (10) and stops at the first run
whose train loss, after cycle 100, rises above ``SPIKE`` times its running
minimum. For that run it names the series that left their own level
first: for each series, the first cycle in the ``LEAD`` cycles before the
spike at which it lies more than ``MOVE`` times above its largest value,
or below its smallest, over the ``BASE`` cycles before those, ranked by
that cycle (printed beside the series' median over those cycles). It also
saves the net's and the optimizer's states ``LEAD`` cycles before the
spike, with the cycle and the batch schedule, to ``<out>/snapshot.pt``.

Every cycle's record goes to ``<out>/run<k>.tsv`` (one text line a cycle,
a header naming the columns); standard output gets one JSON line a run
and, for the spiking run, the lines around the spike and the first
movers.

    python3 scripts/segresnet_spike_trace.py [--f32] [--runs N]
        [--out chiprun_out/segresnet_spike_trace]
"""
import argparse
import collections
import contextlib
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

SPIKE = 5.0       # a loss above 5x its running minimum after cycle 100
LEAD = 20         # cycles before the spike searched for a first mover
BASE = 60         # cycles before those that set each series' level
MOVE = 3.0        # a move: 3x beyond the series' range over those
EPS = 1e-5


def traced_fit(device, f32, imgs, masks, cycles, batch):
    """One fit with every cycle recorded: (columns, (cycles, n) array,
    the Segmentor, the states (net, optimizer) after cycle spike - LEAD
    or None). The last LEAD + 1 states stay on the card while it runs."""
    m = models.Segmentor("SegResNet", 1, seed=1, device=device)
    if f32:
        m.precision = Precision.full()
    params = list(m.net.named_parameters())
    bns = [(n, b) for n, b in m.net.named_modules()
           if isinstance(b, torch.nn.BatchNorm2d)]
    seen = {}

    def hook(name):
        def pre(mod, inp):
            if mod.training and torch.is_grad_enabled():
                x = inp[0].detach().float()
                var = x.var((0, 2, 3), unbiased=False)
                c = var.argmin()
                seen[name] = torch.stack(
                    [var[c], c.float(), x.mean((0, 2, 3))[c]])
        return pre
    handles = [b.register_forward_pre_hook(hook(n)) for n, b in bns]
    rows = []
    snapshots = collections.deque(maxlen=LEAD + 1)
    frozen = []
    plain_step = m._train_batch

    def step(X, y):
        before = [p.detach().clone() for _, p in params]
        loss, acc = plain_step(X, y)
        grads = [p.grad for _, p in params]
        gnorm = torch.stack([g.float().norm() for g in grads
                             if g is not None]).norm()
        upd = torch.stack([(p.detach() - b).norm()
                           for (_, p), b in zip(params, before)])
        vmin = torch.stack([m.optimizer.state[p]["exp_avg_sq"].min()
                            for _, p in params])
        bn = torch.cat([seen[n] for n, _ in bns])
        rows.append(torch.cat([loss.float()[None], gnorm[None], upd, vmin,
                               bn]).cpu())
        snapshots.append(({k: v.detach().clone() for k, v in
                           m.net.state_dict().items()},
                          {"state": {i: {k: v.detach().clone() if
                                         torch.is_tensor(v) else v
                                         for k, v in st.items()}
                                     for i, st in enumerate(
                                         m.optimizer.state.values())}}))
        if not frozen and len(snapshots) == snapshots.maxlen and \
                spike_cycle(np.array([float(r[0]) for r in rows])) \
                == len(rows) - 1:
            frozen.append(snapshots[0])
        return loss, acc
    m._train_batch = step
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(io.StringIO()):
            m.fit(imgs, masks, training_cycles=cycles, batch_size=batch,
                  print_loss=cycles, filename=tmp + "/seg")
    finally:
        for h in handles:
            h.remove()
    cols = (["loss", "grad_norm"] + [f"upd:{n}" for n, _ in params]
            + [f"vmin:{n}" for n, _ in params]
            + [f"{k}:{n}" for n, _ in bns
               for k in ("bnvar", "bnchan", "bnmean")])
    return (cols, torch.stack(rows).numpy().astype(np.float64), m,
            frozen[0] if frozen else None)


def spike_cycle(loss):
    """The first cycle after 100 whose loss exceeds SPIKE x the running
    minimum, or None."""
    run_min = np.minimum.accumulate(loss)
    for c in range(100, len(loss)):
        if loss[c] > SPIKE * run_min[c - 1]:
            return c
    return None


def first_movers(cols, rec, spike):
    """[(first cycle, column, level, value there)] of every series that
    moved MOVE x off its level in the LEAD cycles before the spike."""
    lo, hi = max(spike - LEAD - BASE, 0), spike - LEAD
    out = []
    for j, name in enumerate(cols):
        if name.startswith("bnchan") or name.startswith("bnmean"):
            continue
        s = np.abs(rec[:, j])
        top, bottom = float(s[lo:hi].max()), float(s[lo:hi].min())
        if top <= 0:
            continue
        for c in range(spike - LEAD, spike + 1):
            if s[c] > MOVE * top or s[c] < bottom / MOVE:
                out.append((c, name, float(np.median(s[lo:hi])),
                            float(s[c])))
                break
    return sorted(out)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--f32", action="store_true")
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--out", default="chiprun_out/segresnet_spike_trace")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--smoke", action="store_true",
                        help="a few cycles on 8 frames of 64² (a rehearsal "
                             "of the script's path, e.g. on the CPU)")
    args = parser.parse_args()
    d = torch.device(args.device)
    if d.type == "cuda":
        d = torch.device("cuda", 0)
        torch.cuda.set_device(d)
        cs.phase_device(d)
    main_data, cycles, batch = cs.MAIN, cs.SEG_CYCLES, cs.SEG_BATCH
    if args.smoke:
        main_data = dict(main_data, n_images=8, size=64)
        cycles, batch = 120, 4
    imgs, masks, _ = make_lattice_stack(**main_data)
    os.makedirs(args.out, exist_ok=True)
    for run in range(args.runs):
        cols, rec, m, snap = traced_fit(d, args.f32, imgs, masks, cycles,
                                        batch)
        with open(os.path.join(args.out, f"run{run}.tsv"), "w") as f:
            f.write("cycle\t" + "\t".join(cols) + "\n")
            for c, row in enumerate(rec):
                f.write(f"{c}\t" + "\t".join(f"{v:.6g}" for v in row)
                        + "\n")
        loss = rec[:, 0]
        spike = spike_cycle(loss)
        bn_var = rec[:, [j for j, n in enumerate(cols)
                         if n.startswith("bnvar")]]
        print(json.dumps({
            "run": run, "spike_cycle": spike, "loss_last": loss[-1],
            "loss_min": float(loss.min()),
            "max_loss_after_100": float(loss[100:].max()),
            "smallest_bn_var": float(bn_var.min()), "eps": EPS}),
            flush=True)
        if spike is None:
            continue
        print(f"spike at cycle {spike} (loss {loss[spike - 1]:.4g} -> "
              f"{loss[spike]:.4g}); cycles {spike - 8}..{spike + 2}:")
        show = ["loss", "grad_norm"]
        upd = [j for j, n in enumerate(cols) if n.startswith("upd:")]
        for c in range(max(spike - 8, 0), min(spike + 3, len(rec))):
            big = max(upd, key=lambda j: rec[c, j])
            low = int(np.argmin(bn_var[c]))
            bn_cols = [n for n in cols if n.startswith("bnvar")]
            j_low = cols.index(bn_cols[low])
            print(f"  {c}: " + " ".join(
                f"{n}={rec[c, cols.index(n)]:.4g}" for n in show)
                + f" largest_update={cols[big]}:{rec[c, big]:.3g}"
                + f" smallest_bn_var={bn_cols[low]}:{rec[c, j_low]:.3g}"
                + f"(chan {int(rec[c, j_low + 1])},"
                + f" mean {rec[c, j_low + 2]:.3g})")
        movers = first_movers(cols, rec, spike)
        print("first movers (cycle, series, level, value):")
        for c, name, level, value in movers[:15]:
            print(f"  {c} {name} level={level:.4g} value={value:.4g}")
        if snap is not None:
            torch.save({"cycle": spike - LEAD, "spike": spike,
                        "net": {k: v.cpu() for k, v in snap[0].items()},
                        "adam": {i: {k: v.cpu() if torch.is_tensor(v)
                                     else v for k, v in st.items()}
                                 for i, st in snap[1]["state"].items()},
                        "schedule": np.asarray(m.batch_idx_train),
                        "f32": args.f32},
                       os.path.join(args.out, "snapshot.pt"))
        print(json.dumps({"first_mover": movers[0][1] if movers else None,
                          "spike_run": run, "spike_cycle": spike}))
        break


if __name__ == "__main__":
    main()
