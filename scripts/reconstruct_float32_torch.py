"""Why the port's ``Reconstructor`` computes its GP in float64: in float32
the fit of a sparse image of a few thousand measured pixels goes NaN once
the noise reaches its 1e-4 floor, in the port and in the JAX package.

On a card (the default): the port's ``Reconstructor`` on chip_smoke's
sin-cos test images (192 x 192 at 10% measured pixels, 256 x 256 at 10%
on the exact path and at 30% on the inducing grid), 100 cycles from the
same start in float32 and in float64. One JSON line a run: every 10th
cycle's loss, lengthscales, outputscale and noise, the first cycle whose
loss is NaN, and the reconstruction's mean absolute error.

With ``--jax``: the JAX package's ``Reconstructor`` on the CPU on the
192 x 192 image (about four minutes on 4 threads), the same line.

    python3 scripts/reconstruct_float32_torch.py
    python3 scripts/reconstruct_float32_torch.py --jax
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

CYCLES = 100
CASES = ((192, 0.1), (256, 0.1), (256, 0.3))


def summary(losses, out, true, **fields):
    losses = np.asarray(losses, np.float64)
    bad = ~np.isfinite(losses)
    return dict(fields, first_nan_cycle=int(np.argmax(bad)) if bad.any()
                else None, loss_every_10=losses[::10].tolist(),
                mae=float(np.abs(out - true).mean()))


def port_run(size, share, dtype):
    import torch
    from atomai_tpu_torch.models import Reconstructor
    from atomai_tpu_torch.trainers.gptrainer import _hyp
    from atomai_tpu_torch.utils import (get_lengthscale_constraints,
                                        prepare_gp_input)
    img, true = chip_smoke.sparse_test_image(size, share)
    X, y, X_full = prepare_gp_input(img)
    rec = Reconstructor(device="cuda")
    rec.dtype = dtype
    kernel_type = ("exact" if len(X) <= rec.MAX_EXACT_POINTS
                   else "kissgp")
    rec.compile_trainer(X.astype(np.float32), y, CYCLES,
                        kernel_type=kernel_type,
                        lengthscale_constraints=get_lengthscale_constraints(
                            X_full))
    hyper = []
    for c in range(CYCLES):
        rec._run_chunk(1)
        if c % 10 == 9:
            ls, os_, noise, _ = _hyp(
                {k: v.detach() for k, v in rec.gp_params.items()},
                rec.lengthscale_constraints)
            hyper.append([c, ls.tolist(), float(os_), float(noise)])
    with contextlib.redirect_stdout(io.StringIO()):
        out = rec.predict(X_full.astype(np.float32), batch_size=4096)
    return summary(rec.train_loss, out.reshape(img.shape), true,
                   package="port", dtype=str(dtype), size=size,
                   share=share, points=len(X), kernel_type=kernel_type,
                   cycle_lengthscale_outputscale_noise=hyper)


def jax_run(size=192, share=0.1):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from atomai_tpu.models import Reconstructor
    img, true = chip_smoke.sparse_test_image(size, share)
    rec = Reconstructor()
    with contextlib.redirect_stdout(io.StringIO()):
        out = rec.reconstruct(img, training_cycles=CYCLES,
                              print_loss=CYCLES)
    return summary(rec.train_loss, out, true, package="atomai_tpu (JAX)",
                   dtype="float32", size=size, share=share,
                   points=int(np.count_nonzero(img)),
                   kernel_type=rec.kernel_type)


def main():
    if "--jax" in sys.argv[1:]:
        print(json.dumps(jax_run()), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("reconstruct_float32_torch: torch sees no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for size, share in CASES:
        for dtype in (torch.float32, torch.float64):
            print(json.dumps(port_run(size, share, dtype)), flush=True)


if __name__ == "__main__":
    main()
