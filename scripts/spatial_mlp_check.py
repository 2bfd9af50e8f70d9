"""Builds the spatial-MLP kernels on the card and checks them quickly.

    python3 scripts/spatial_mlp_check.py

Prints the card's name and power limit, each kernel's registers and spills
from ``-Xptxas -v``, the kernels' error against their plain versions (as a
share of the plain output's scale) at ``chip_smoke.MLP_SHAPES`` and at a
few more widths and depths, whether two backward runs agree bit for bit,
and the forward and backward times at config C's shapes by device time
(``chip_smoke.device_ms``), twice. Shorter than ``chip_smoke.py``: for a
first call after a change to ``csrc/spatial_mlp.cu``.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

EXTRA_SHAPES = [(4, 200, 16, 1), (3, 130, 64, 4), (2, 100, 192, 1),
                (2, 100, 256, 1)]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("spatial_mlp_check: torch sees no CUDA device")
    import chip_smoke as cs
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.ops import spatial_mlp as sm
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    sm.build()
    print("build s", time.perf_counter() - t0, cs.ptxas_report(), flush=True)
    dev = torch.device("cuda", 0)
    with Precision.full().scope(dev):
        for i, (B, n, H, L) in enumerate(cs.MLP_SHAPES + EXTRA_SHAPES):
            args, gy = cs.mlp_inputs(B, n, H, L, i, dev)
            y = sm.spatial_mlp_forward_cuda(*args)
            grads = sm.spatial_mlp_backward_cuda(*args, gy)
            again = sm.spatial_mlp_backward_cuda(*args, gy)
            torch.cuda.synchronize(dev)
            errs = {"y": cs.scaled_err(y, sm.spatial_mlp_reference(*args))}
            errs.update({name: cs.scaled_err(a, b) for name, a, b in zip(
                cs.MLP_NAMES, grads,
                sm.spatial_mlp_backward_reference(*args, gy)) if b.numel()})
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            print((B, n, H, L), "bit-identical", same,
                  {k: round(v, 5) for k, v in errs.items()}, flush=True)
        args, gy = cs.mlp_inputs(128, 1024, 128, 2, 0, dev)
        for _ in range(2):
            fwd = cs.device_ms(lambda: sm.spatial_mlp_forward_cuda(*args), 50,
                               dev)
            bwd = cs.device_ms(
                lambda: sm.spatial_mlp_backward_cuda(*args, gy), 50, dev)
            print("config C forward ms", fwd, "backward ms", bwd, flush=True)


if __name__ == "__main__":
    main()
