"""Drives the PyTorch port's segmentation serving path once on one CUDA card
and checks every step of it.

    python3 chip_smoke.py

Phases, one JSON line each (all before the last line):
 0. device: the card, the CUDA version, and ``nvidia-smi``'s name and power
    limit (also printed raw on a line of their own);
 1. build: compiles the CUDA kernels of ``atomai_tpu_torch/csrc`` and times it;
 2. kernel: the connected-component labeller against its plain torch version
    and a scipy oracle, exact int32 equality, on random masks, empty and full
    masks, a one-pixel-wide spiral and a tiled stack of lattice masks;
 3. locator: the port's lattice generator and Locator against the numbers the
    JAX package left in ``tests/fixtures/``, and the Locator's error against
    the true atom positions of 64 512x512 frames;
 4. unet: the full-width Unet forward against a JAX fixture, in float32 (TF32
    off) and in the card's default mixed bf16 policy;
 5. main_path: ``Segmentor("Unet").predict`` on bench config A's shapes
    (64 x 256 x 256) with seeded random weights: output checks, kernel launch
    count, coordinates equal to those of the plain labeller, and times taken
    with CUDA events after warm-up.
Then one JSON line on the kernels, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It imports neither JAX nor ``atomai_tpu``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

# stated tolerances
TOL_LATTICE = 1e-6       # generator vs its pinned fixture (float32 images)
TOL_LOCATOR = 1e-4       # px, Locator vs its pinned fixture
TOL_MEDIAN_PX = 1.0      # median distance of found to true atoms
# create_lattice_mask pastes its 5-px disc at rows/cols x-3 .. x+1, so a
# ground-truth blob's centre sits one pixel up and left of its atom (in the
# JAX package's generator too); measured mean offset (-1.005, -0.985)
MASK_OFFSET = np.array([-1.0, -1.0])
TOL_UNET_F32 = 1e-4      # abs, float32 cuDNN vs XLA:CPU (output |y| <= 0.11)
TOL_UNET_BF16 = 2e-2     # abs, bf16 convs (8-bit mantissa) vs float32

# shapes: the main path runs bench config A's stack
MAIN = dict(n_images=64, size=256, spacing=16, seed=0)
LATTICE = dict(n_images=64, size=512, spacing=16, seed=0)
RANDOM_SHAPES = [(512, 512), (509, 331), (2048, 2048)]
FULL_SHAPES = [(2048, 2048), (509, 331)]
SPIRAL = 1024


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def scipy_labels(mask):
    """scipy.ndimage.label converted to the port's contract: the minimal
    flat index of each component, H*W for background."""
    from scipy import ndimage
    H, W = mask.shape
    lab, _ = ndimage.label(mask)
    flat = lab.ravel()
    values, first = np.unique(flat, return_index=True)
    root = np.full(values.max() + 1, H * W, np.int64)
    root[values] = first  # label order is raster order of first pixels
    root[0] = H * W
    return root[flat].reshape(H, W).astype(np.int32)


def spiral_mask(n):
    """One single-pixel-wide square spiral with one-pixel gaps."""
    m = np.zeros((n, n), bool)
    r = c = 0
    dr, dc = 0, 1
    lengths = [n - 1, n - 1, n - 1]
    k = n - 3
    while k > 0:
        lengths += [k, k]
        k -= 2
    m[0, 0] = True
    for length in lengths:
        for _ in range(length):
            r, c = r + dr, c + dc
            m[r, c] = True
        dr, dc = dc, -dr
    return m


def unflatten(arrays, prefix):
    tree = {}
    for key, v in arrays.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return tree


def cuda_ms(fn, reps, device):
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up
    run, by CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def phase_device(device):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[device.index or 0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(device),
         cuda=torch.version.cuda, torch=torch.__version__,
         nvidia_smi=smi, count=torch.cuda.device_count())
    return smi


def phase_build():
    from atomai_tpu_torch.ops import cc_kernel
    t0 = time.perf_counter()
    cc_kernel.build()
    emit("build", seconds=time.perf_counter() - t0)


def phase_kernel(device, lattice_masks):
    import torch
    from atomai_tpu_torch.ops import (label_components_cuda,
                                      label_components_reference,
                                      tile_frames)
    cases = []
    seed = 0
    for shape in RANDOM_SHAPES:
        for density in [0.1, 0.5, 0.59, 0.9]:
            rng = np.random.RandomState(seed)
            seed += 1
            cases.append((f"random{shape}@{density}",
                          rng.rand(*shape) < density, True))
    for shape in FULL_SHAPES:
        cases += [(f"zeros{shape}", np.zeros(shape, bool), True),
                  (f"ones{shape}", np.ones(shape, bool), True)]
    # min-propagation needs ~H*W/2 sweeps on a spiral: scipy only
    cases.append((f"spiral({SPIRAL},{SPIRAL})", spiral_mask(SPIRAL), False))
    tiled = tile_frames(torch.from_numpy(lattice_masks > 0).to(device))
    cases.append((f"lattice_tiled{tuple(tiled.shape)}", tiled.cpu().numpy(),
                  True))
    results = []
    for name, mask, with_plain in cases:
        m = torch.from_numpy(mask).to(device)
        got = label_components_cuda(m)
        torch.cuda.synchronize(device)
        got = got.cpu().numpy()
        check(np.array_equal(got, scipy_labels(mask)),
              f"kernel != scipy oracle on {name}")
        if with_plain:
            ref = label_components_reference(m)
            torch.cuda.synchronize(device)
            check(np.array_equal(got, ref.cpu().numpy()),
                  f"kernel != plain labeller on {name}")
        results.append(name)
    emit("kernel", cases=len(results), names=results, exact=True)


def phase_locator(device, lattice):
    import torch
    from scipy.spatial import cKDTree
    from atomai_tpu_torch.predictors import Locator
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, masks, _ = make_lattice_stack(n_images=2, size=64, spacing=12,
                                        seed=7)
    expected = np.load(os.path.join(FIXTURES, "lattice_images.npy"))
    err_img = float(np.abs(imgs - expected).max())
    check(err_img <= TOL_LATTICE, f"lattice images off by {err_img}")
    got = Locator(0.5).run(torch.from_numpy(masks[..., None]).to(device))[0]
    ref = np.load(os.path.join(FIXTURES, "locator_coords_frame0.npy"))
    check(got.shape == ref.shape, f"locator shape {got.shape} != "
          f"{ref.shape}")
    a = got[np.lexsort(got[:, :2].T)]
    b = ref[np.lexsort(ref[:, :2].T)]
    err_loc = float(np.abs(a - b).max())
    check(err_loc <= TOL_LOCATOR, f"locator coordinates off by {err_loc}")
    _, big_masks, true_xy = lattice
    coords = Locator(0.5).run(
        torch.from_numpy(big_masks[..., None]).to(device))
    dists = np.concatenate([
        cKDTree(true_xy[i] + MASK_OFFSET).query(coords[i][:, :2])[0]
        for i in range(len(true_xy))])
    median = float(np.median(dists))
    check(median < TOL_MEDIAN_PX, f"median atom error {median} px")
    emit("locator", lattice_max_err=err_img, fixture_max_err_px=err_loc,
         fixture_atoms=int(len(got)), frames=len(coords),
         atoms=int(len(dists)), median_err_px=median,
         tolerances={"lattice": TOL_LATTICE, "fixture_px": TOL_LOCATOR,
                     "median_px": TOL_MEDIAN_PX})


def phase_unet(device):
    import torch
    from atomai_tpu_torch.core import Precision, default_precision
    from atomai_tpu_torch.models import unet_from_jax
    from atomai_tpu_torch.nets import Unet
    fx = dict(np.load(os.path.join(FIXTURES, "torch_port_unet_fwd.npz")))
    net = Unet(nb_classes=1, nb_filters=16, layers=(1, 2, 2, 3))
    net.load_state_dict(unet_from_jax(unflatten(fx, "params"),
                                      unflatten(fx, "batch_stats")))
    net.to(device).eval()
    x = torch.from_numpy(fx["x"]).permute(0, 3, 1, 2).to(device)
    errs = {}
    for label, policy, tol in [("f32", Precision.full(), TOL_UNET_F32),
                               ("mixed", default_precision(device),
                                TOL_UNET_BF16)]:
        with torch.inference_mode(), policy.scope(device):
            y = net(x)
        y = y.float().permute(0, 2, 3, 1).cpu().numpy()
        errs[label] = float(np.abs(y - fx["y"]).max())
        check(errs[label] <= tol, f"Unet {label} off by {errs[label]} "
              f"(tolerance {tol})")
    check(default_precision(device).compute_dtype == torch.bfloat16,
          "the card's default policy is not bf16")
    emit("unet", max_abs_err_f32=errs["f32"], max_abs_err_mixed=errs["mixed"],
         ref_max_abs=float(np.abs(fx["y"]).max()),
         tolerances={"f32": TOL_UNET_F32, "mixed": TOL_UNET_BF16})


def phase_main_path(device):
    import torch
    from atomai_tpu_torch import models, ops
    from atomai_tpu_torch.ops import cc_kernel, cc_label
    from atomai_tpu_torch.predictors import Locator, SegPredictor
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, gt_masks, _ = make_lattice_stack(**MAIN)
    n, size = MAIN["n_images"], MAIN["size"]
    m = models.Segmentor("Unet", nb_classes=1, seed=1, device=device)
    m.predict(imgs, verbose=False)  # warm-up: cuDNN plans, allocator

    cc_kernel.LAUNCHES = 0
    nn_output, coords = m.predict(imgs, verbose=False)
    torch.cuda.synchronize(device)
    launches = cc_kernel.LAUNCHES

    check(nn_output.shape == (n, size, size, 1),
          f"maps shape {nn_output.shape}")
    check(bool(np.isfinite(nn_output).all()), "non-finite maps")
    check(nn_output.min() >= 0 and nn_output.max() <= 1, "maps out of [0, 1]")
    check(len(coords) == n, f"{len(coords)} coordinate frames")
    check(launches > 0, "the main path never launched the cc_label kernel")

    # the same device maps, labelled by the kernel and by the plain version
    pred = SegPredictor(m.net, nb_classes=1, verbose=False)
    maps = pred.predict_device(imgs)
    repeat_diff = float(np.abs(maps.cpu().numpy() - nn_output).max())
    tiled = ops.tile_frames(maps[..., 0] > 0.5)
    lab_k = ops.label_components_cuda(tiled)
    lab_r = ops.label_components_reference(tiled)
    max_abs_err = int((lab_k.long() - lab_r.long()).abs().max())
    check(max_abs_err == 0, f"kernel labels off by {max_abs_err}")
    locator = Locator(0.5)
    coords_kernel = locator.run(maps)
    kernel_labeller = cc_label.label_components
    cc_label.label_components = ops.label_components_reference
    try:
        coords_plain = locator.run(maps)
        plain_locate_ms = cuda_ms(lambda: locator.run(maps), 3, device)
    finally:
        cc_label.label_components = kernel_labeller
    check(coords_plain.keys() == coords_kernel.keys(), "frames differ")
    for i in coords_kernel:
        check(np.array_equal(coords_kernel[i], coords_plain[i]),
              f"frame {i}: coordinates differ from the plain labeller's")

    kernel_ms = cuda_ms(lambda: ops.label_components_cuda(tiled), 20,
                        device)
    plain_ms = cuda_ms(lambda: ops.label_components_reference(tiled), 3,
                       device)
    # random weights mark nearly every pixel: one component per frame. The
    # ground-truth masks of the same stack are what a trained net marks.
    gt = ops.tile_frames(torch.from_numpy(gt_masks > 0).to(device))
    gt_kernel_ms = cuda_ms(lambda: ops.label_components_cuda(gt), 20, device)
    gt_plain_ms = cuda_ms(lambda: ops.label_components_reference(gt), 3,
                          device)
    locate_ms = cuda_ms(lambda: locator.run(maps), 5, device)
    forward_ms = cuda_ms(lambda: pred.predict_device(imgs), 5, device)
    predict_ms = cuda_ms(lambda: m.predict(imgs, verbose=False), 5, device)
    emit("main_path", maps=list(nn_output.shape), frames=len(coords),
         atoms=int(sum(len(c) for c in coords.values())),
         launches=launches, tiled_mask=list(tiled.shape),
         foreground_share=float(tiled.float().mean()),
         maps_repeat_max_diff=repeat_diff,
         predict_ms=predict_ms, forward_ms=forward_ms, locate_ms=locate_ms,
         locate_plain_ms=plain_locate_ms, kernel_ms=kernel_ms,
         kernel_plain_ms=plain_ms, gt_mask_kernel_ms=gt_kernel_ms,
         gt_mask_kernel_plain_ms=gt_plain_ms)
    return {"name": "cc_label", "route": "cuda",
            "source": "atomai_tpu_torch/csrc/cc_label.cu",
            "replaces": "atomai_tpu/ops/pallas_cc.py:27",
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": kernel_ms, "plain_ms": plain_ms}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device")
    sys.path.insert(0, ROOT)
    from atomai_tpu_torch.utils import make_lattice_stack
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_device(device)
    phase_build()
    lattice = make_lattice_stack(**LATTICE)
    phase_kernel(device, lattice[1])
    phase_locator(device, lattice)
    phase_unet(device)
    kernel = phase_main_path(device)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
