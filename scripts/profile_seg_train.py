"""Profiles bench config A's training cycle on one CUDA card: the
full-width Unet under the card's bf16 policy, 64 x 256^2 frames, one
train batch of 32 and one test batch of 10 a cycle.

Prints the card's name and power limit, then one JSON line: the host
clock and CUDA-event milliseconds of a cycle, of a train step alone and
of an eval step alone (after a 60-cycle ``fit`` warm-up), and from a
``torch.profiler`` trace of 20 cycles the kernel time and kernel launches
a cycle; then every kernel's milliseconds and launches a cycle, largest
first. Needs a card:

    python3 scripts/profile_seg_train.py
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from atomai_tpu_torch.models import Segmentor  # noqa: E402
from atomai_tpu_torch.utils import make_lattice_stack  # noqa: E402

WARM_CYCLES = 60
TIMED = 50
TRACED = 20


def device_us(event) -> float:
    """Self device time of a profiler entry (the attribute's name changed
    across torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    return 0.0


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_seg_train: torch sees no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    imgs, masks, _ = make_lattice_stack(n_images=64, size=256, spacing=16,
                                        seed=0)
    m = Segmentor("Unet", 1, seed=1, device="cuda")
    with contextlib.redirect_stdout(io.StringIO()), \
            tempfile.TemporaryDirectory() as tmp:
        m.fit(imgs, masks, training_cycles=WARM_CYCLES, batch_size=32,
              print_loss=WARM_CYCLES, filename=os.path.join(tmp, "prof"))
    g = m.keys.next(device=m.device)
    steps = {
        "cycle": lambda e: m._cycle(e % WARM_CYCLES, g, None, 1 << 30),
        "train_step": lambda e: m._train_batch(m.Xb_train[0], m.yb_train[0]),
        "eval_step": lambda e: m._eval_batch(m.Xb_test[0], m.yb_test[0]),
    }
    out = {}
    for name, step in steps.items():
        for e in range(5):
            step(e)
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for e in range(TIMED):
                step(e)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) / TIMED * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for e in range(TIMED):
            step(e)
        end.record()
        torch.cuda.synchronize()
        out[name + "_ms_host"] = host
        out[name + "_ms_events"] = start.elapsed_time(end) / TIMED

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for e in range(TRACED):
            steps["cycle"](e)
        torch.cuda.synchronize()
    # device-side entries only, without the GPU user annotations (the
    # optimizer's "Optimizer.step#Adam.step"), which span kernels that are
    # counted on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    rows = sorted(((device_us(e) / 1e3 / TRACED, e.count / TRACED, e.key)
                   for e in kernels), reverse=True)
    out["kernel_ms_per_cycle"] = sum(r[0] for r in rows)
    out["kernel_launches_per_cycle"] = sum(r[1] for r in rows)
    print(json.dumps(out), flush=True)
    for ms, n, key in rows:
        print(f"{ms:.4f} ms  {n:.1f}/cycle  {key[:100]}")


if __name__ == "__main__":
    main()
