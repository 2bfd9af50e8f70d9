"""Profiles the port's config B and config D paths on one CUDA card, under
the card's bf16 policy: where a cycle's time goes, and whether the host or
the card holds it.

- config B (`bench.py:340-355`): ``ImSpec((64, 64), (16,), latent_dim=2)``
  on 512 images of 64^2, one train batch of 32 and one test batch a cycle;
- config D (`bench.py:357-394`): one ensemble member's cycle, an augmented
  batch of 8 frames of 512^2 (the full augmentation) and a train step of
  the default Unet; the augmentation alone;
- config D's predictor: ``EnsemblePredictor`` of 4 Unets on 32 frames of
  512^2, each member layout ("map", "vmap");
- ``ensemble_locate`` on those 4 x 32 maps: the one Locator run against
  the per-frame DBSCAN clustering (host clock);
- config E (`bench.py:409-429`): one training cycle of ``dklGPR(64,
  embedim=2)`` on 10,000 x 64 inputs (the exact Cholesky GP), and
  ``predict`` of the 10,000 training inputs; their device time split by
  the op that launched it (the Cholesky factorisation, its backward, the
  triangular solves and theirs, the rest).

For each step: the host clock and CUDA-event milliseconds a call (after a
warm-up), and from a ``torch.profiler`` trace the kernel time and the
kernel launches a call and the largest kernels. Prints the card's name and
power limit, then one JSON line a step. Needs a card:

    python3 scripts/profile_port_paths.py [B] [D] [E]

(all three configurations when none is named).
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from atomai_tpu_torch.models import ImSpec  # noqa: E402
from atomai_tpu_torch.predictors import (EnsemblePredictor,  # noqa: E402
                                         Locator, ensemble_locate)
from atomai_tpu_torch.trainers import EnsembleTrainer  # noqa: E402
from atomai_tpu_torch.transforms import seg_augmentor  # noqa: E402
from atomai_tpu_torch.utils import cluster_coord  # noqa: E402
from atomai_tpu_torch.utils import make_lattice_stack  # noqa: E402

AUG = dict(rotation=True, zoom=True, gauss_noise=[10, 30],
           poisson_noise=[30, 45], salt_and_pepper=True, blur=True,
           contrast=True, background=True)
TOP = 12


def device_us(event) -> float:
    """Self device time of a profiler entry (the attribute's name changed
    across torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    return 0.0


# config E's device time by the op that launched it: the profiler's CPU
# events of these names, with the device time of every kernel under them
E_OPS = {
    "cholesky": "aten::linalg_cholesky_ex",
    "cholesky_backward": "LinalgCholeskyExBackward0",
    "triangular_solve": "aten::linalg_solve_triangular",
    "triangular_solve_backward": "LinalgSolveTriangularBackward0",
}


def device_us_total(event) -> float:
    """Device time of a profiler entry with its children's."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    return 0.0


def op_split(prof, traced, ops):
    """Device ms a call under each of ``ops``' CPU events, outermost calls
    only (a solve inside a backward counts for the backward)."""
    def label(e):
        return next((k for k, n in ops.items() if e.name.endswith(n)), None)

    out = dict.fromkeys(ops, 0.0)
    for e in prof.events():
        if label(e) is None:
            continue
        p = e.cpu_parent
        while p is not None and label(p) is None:
            p = p.cpu_parent
        if p is None:
            out[label(e)] += device_us_total(e) / 1e3 / traced
    return out


def measure(name, step, timed, traced, ops=None):
    """Times ``step(i)`` on the host clock and by CUDA events, traces it,
    and prints one JSON line; with ``ops``, the device time under each of
    those ops too."""
    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(timed):
        step(i)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / timed * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(traced):
            step(i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    rows = sorted(((device_us(e) / 1e3 / traced, e.count / traced, e.key)
                   for e in kernels), reverse=True)
    kernel_ms = sum(r[0] for r in rows)
    events_ms = start.elapsed_time(end) / timed
    line = {
        "step": name, "ms_host": host_ms, "ms_events": events_ms,
        "kernel_ms": kernel_ms, "launches": sum(r[1] for r in rows),
        "device_busy_share": kernel_ms / events_ms,
        "top": [[round(ms, 4), round(n, 1), key[:70]]
                for ms, n, key in rows[:TOP]]}
    if ops:
        line["by_op_ms"] = op_split(prof, traced, ops)
        line["by_op_ms"]["rest"] = kernel_ms - sum(
            line["by_op_ms"].values())
    print(json.dumps(line), flush=True)


def config_b():
    rng = np.random.RandomState(0)
    Xb = rng.rand(512, 64, 64).astype(np.float32)
    yb = rng.rand(512, 16).astype(np.float32)
    m = ImSpec((64, 64), (16,), latent_dim=2, device="cuda")
    with contextlib.redirect_stdout(io.StringIO()), \
            tempfile.TemporaryDirectory() as tmp:
        m.fit(Xb, yb, Xb[:64], yb[:64], training_cycles=30, batch_size=32,
              print_loss=30, filename=os.path.join(tmp, "b"))
    g = m.keys.next(device=m.device)
    measure("B_cycle", lambda e: m._cycle(e % 30, g, None, 1 << 30), 50, 20)
    measure("B_train_step",
            lambda e: m._train_batch(m.Xb_train[0], m.yb_train[0]), 50, 20)
    measure("B_eval_step",
            lambda e: m._eval_batch(m.Xb_test[0], m.yb_test[0]), 50, 20)


def config_d():
    imgs, masks, _ = make_lattice_stack(n_images=32, size=512, spacing=16,
                                        seed=0)
    aug = seg_augmentor(1, **AUG)
    et = EnsembleTrainer("Unet", 1, device="cuda")
    with contextlib.redirect_stdout(io.StringIO()), \
            tempfile.TemporaryDirectory() as tmp:
        et.compile_ensemble_trainer(training_cycles=30, batch_size=8,
                                    swa=True, filename=os.path.join(tmp, "d"))
        _, ens = et.train_ensemble_from_scratch(imgs, masks, n_models=4,
                                                augment_fn=aug)
    et.compile_trainer((imgs, masks), training_cycles=1, batch_size=8,
                       loss="ce")
    g = et.keys.next(device=et.device)
    X, y = et.Xb_train[0], et.yb_train[0]
    measure("D_member_cycle",
            lambda e: et._train_batch(*aug(g, X, y)), 30, 10)
    measure("D_augment", lambda e: aug(g, X, y), 30, 10)
    measure("D_train_step", lambda e: et._train_batch(X, y), 30, 10)

    preds = {layout: EnsemblePredictor(et.net, ens, nb_classes=1,
                                       member_layout=layout, verbose=0)
             for layout in ("map", "vmap")}
    x = preds["map"].preprocess(imgs)
    maps = torch.from_numpy(preds["map"].ensemble_forward(
        x, num_batches=32)).cuda()
    flat = maps.reshape((-1,) + tuple(maps.shape[2:]))
    measure("D_locator_128_frames", lambda e: Locator(0.5).run(flat), 5, 3)
    coords = Locator(0.5).run(flat)
    t0 = time.perf_counter()
    for i in range(32):
        cluster_coord({m: coords[m * 32 + i] for m in range(4)}, 1.0, 3)
    cluster_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ensemble_locate(maps, eps=1.0, min_samples=3)
    total_s = time.perf_counter() - t0
    print(json.dumps({"step": "D_ensemble_locate", "total_ms": total_s * 1e3,
                      "cluster_coord_ms_32_frames": cluster_s * 1e3,
                      "points_per_frame": int(np.mean([
                          sum(len(coords[m * 32 + i]) for m in range(4))
                          for i in range(32)]))}), flush=True)
    for layout, p in preds.items():
        p.predict(imgs)
        measure(f"D_predictor_{layout}",
                lambda e, p=p: p.ensemble_batch_predict(x), 5, 3)


def config_e():
    from atomai_tpu_torch.models import dklGPR
    rng = np.random.RandomState(0)
    Xg = rng.randn(10000, 64).astype(np.float32)
    yg = (Xg[:, 0] + 0.1 * rng.randn(10000)).astype(np.float32)
    gp = dklGPR(64, embedim=2, device="cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        gp.fit(Xg, yg, training_cycles=5, print_loss=5)
    measure("E_cycle", lambda e: gp._step(), 10, 3, E_OPS)
    gp._compute_scale_stats()
    gp._post_cache = None
    measure("E_predict_10k", lambda e: gp.predict(Xg), 5, 2, E_OPS)


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_port_paths: torch sees no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    configs = {"B": config_b, "D": config_d, "E": config_e}
    for name in sys.argv[1:] or list(configs):
        configs[name]()


if __name__ == "__main__":
    main()
