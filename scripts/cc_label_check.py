"""Builds the connected-component labeller on the card and checks it quickly.

    python3 scripts/cc_label_check.py

Prints the card's name and power limit, each kernel's registers, shared
memory and spills from ``-Xptxas -v``, then checks the kernel's labels
(alone and with the blob sums fused in) against scipy and the plain
labeller, and its fused sums and blob order against the plain sums, exactly,
on every case of ``chip_smoke.py``'s kernel phase. Then device times
(``chip_smoke.device_ms``) of the fused kernel and of the kernel without the
sums on config A's tiled stack (64 frames of 256^2): all foreground (one
component a frame, the random-weight Unet's mask) and the lattice's
ground-truth masks (what a trained net marks), twice, and their split by
kernel (``chip_smoke.device_split``). Shorter than
``chip_smoke.py``: for a first call after a change to ``csrc/cc_label.cu``.
"""

import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("cc_label_check: torch sees no CUDA device")
    import chip_smoke as cs
    from atomai_tpu_torch.ops import _build, cc_kernel, roofline, tile_frames
    from atomai_tpu_torch.utils import make_lattice_stack
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    cc_kernel.build()
    print("build s", time.perf_counter() - t0, flush=True)
    for line in _build.BUILD_LOG.get("cc_label.cu", "").splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print(line.strip(), flush=True)
    dev = torch.device("cuda", 0)
    lattice = make_lattice_stack(**cs.LATTICE)[1]
    for name, mask, band, with_plain in cs.kernel_cases(dev, lattice):
        t = time.perf_counter()
        k = cs.check_kernel_case(dev, name, mask, band, with_plain)
        print(f"{name}: exact, {k} components, band {band}, "
              f"{time.perf_counter() - t:.2f} s", flush=True)
    n, size = cs.MAIN["n_images"], cs.MAIN["size"]
    ones = tile_frames(torch.ones((n, size, size), dtype=torch.bool,
                                  device=dev))
    gt = make_lattice_stack(**cs.MAIN)[1]
    gt = tile_frames(torch.from_numpy(gt > 0).to(dev))
    for _ in range(2):
        for label, mask in (("all foreground", ones), ("lattice masks", gt)):
            fused = cs.device_ms(lambda: cc_kernel.launch(mask, size + 1),
                                 20, dev)
            alone = cs.device_ms(lambda: cc_kernel.label_components_cuda(
                mask), 20, dev)
            blobs = len(cc_kernel.blob_sums_cuda(mask, size + 1)[0])
            bound = roofline.bound_ms(0, cc_kernel.cc_label_bytes(
                *mask.shape, blobs))
            print(f"{label} {tuple(mask.shape)}: fused {fused:.4f} ms, "
                  f"labels only {alone:.4f} ms, {blobs} components, bound "
                  f"{bound:.5f} ms ({100 * bound / fused:.2f}%)", flush=True)
    for label, mask in (("all foreground", ones), ("lattice masks", gt)):
        print(label, "device us a call by kernel:", cs.device_split(
            lambda: cc_kernel.launch(mask, size + 1), dev, 20), flush=True)


if __name__ == "__main__":
    main()
