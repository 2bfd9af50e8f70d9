"""A deep-kernel-learning GP for autonomous experiments, on the card:
fit -> Thompson sampling over the unmeasured candidates -> measure ->
refit.

The PyTorch counterpart of ``examples/dkl_active_learning.py``.

    python examples_torch/dkl_active_learning.py [--device cpu] [--smoke]
        [--out DIR]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _cli import parse  # noqa: E402

import atomai_tpu_torch as aoi  # noqa: E402


def measure(x_row):
    """A stand-in for a real measurement (a spectroscopy acquisition)."""
    return float(x_row @ np.sin(np.arange(x_row.shape[-1])))


def main(argv=None):
    args = parse(__doc__, argv, plot=False)
    rounds, cycles = (2, 5) if args.smoke else (5, 50)
    rng = np.random.RandomState(0)
    X_all = rng.randn(500, 16).astype(np.float32)       # candidate pool
    seen = list(rng.choice(500, 20, replace=False))     # first measurements
    y_seen = [measure(X_all[i]) for i in seen]

    for step in range(rounds):
        dklgp = aoi.models.dklGPR(16, embedim=2, device=args.device)
        dklgp.fit(X_all[seen], np.asarray(y_seen, np.float32),
                  training_cycles=cycles, print_loss=cycles)
        candidates = [i for i in range(500) if i not in seen]
        _, next_i = dklgp.thompson(X_all[candidates])
        pick = candidates[int(np.ravel(next_i)[0])]
        seen.append(pick)
        y_seen.append(measure(X_all[pick]))
        print(f"step {step}: measured candidate {pick}, "
              f"value {y_seen[-1]:.3f}")

    mean, var = dklgp.predict(X_all[:50])
    print("posterior mean/var:", mean.shape, var.shape)


if __name__ == "__main__":
    main()
