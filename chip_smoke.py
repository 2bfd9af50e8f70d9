"""Drives the PyTorch port's paths once on one CUDA card (segmentation
serving, segmentation training with augmentation and peak refinement, and
rVAE training) and checks every step of them.

    python3 chip_smoke.py

Phases, one JSON line each (all before the last line):
 0. device: the card, the CUDA version, and ``nvidia-smi``'s name and power
    limit (also printed raw on a line of their own);
 1. build: compiles the CUDA sources of ``atomai_tpu_torch/csrc``, one nvcc
    for each, all started together, times them, and reports each kernel's
    registers and spills from ``-Xptxas -v``;
 2. kernel: the connected-component labeller against its plain torch version
    and a scipy oracle, exact int32 equality, and its fused blob sums
    (counts, row and column sums, blob order) against the plain sums of the
    same labels, exactly, on random masks, empty and full masks, ragged and
    narrow shapes, a one-pixel-wide spiral, a tiled stack of lattice masks
    and a random tiled stack;
 3. locator: the port's lattice generator and Locator against the numbers the
    JAX package left in ``tests/fixtures/``, and the Locator's error against
    the true atom positions of 64 512x512 frames;
 4. unet: the full-width Unet forward against a JAX fixture, in float32 (TF32
    off) and in the card's default mixed bf16 policy;
 5. main_path: ``Segmentor("Unet").predict`` on bench config A's shapes
    (64 x 256 x 256) with seeded random weights: output checks, kernel launch
    count, labels, fused sums and coordinates equal to those of the plain
    version, and times taken with CUDA events after warm-up: predict,
    forward, locate on each route, the fused kernel beside its plain
    version and its bound, the kernel without the sums;
 6. spatial_mlp: the rVAE decoder's forward and backward kernels against
    their plain versions on the same CUDA tensors, at config C's shapes
    (B 128, n 1024, H 128, L 2), at n 784 and 2560, at H 256 and 512 and at
    a few odd shapes; the backward run twice must agree bit for bit;
 7. rvae_fixture: one config C step (ELBO, every gradient, one Adam step)
    against the numbers the JAX package left in ``tests/fixtures/``;
 8. rvae_path: ``rVAE((32, 32), latent_dim=2).fit`` on bench config C's 1024
    patches for 20 epochs of batch 128 with per-epoch async checkpoints, then
    ``manifold2d``: launch counts of both kernels, a finite and rising ELBO;
    then, with CUDA events after warm-up, steps/s of the loop on the kernels
    and on the decoder's stock per-layer route (cuBLAS bf16 GEMMs and
    elementwise tanh, ``fused()`` false; the port never takes it on this
    path), in turns; each kernel's time beside its plain version, its bound
    (``ops.roofline`` on the counts of ``ops.spatial_mlp``) and the stock
    route's time, at the path's shapes;
 9. seg_train_fixture: five cycles of ``Segmentor.fit`` at config A's width
    in float32 (TF32 off) against the JAX run in ``tests/fixtures/``;
10. seg_path: bench config A whole: ``Segmentor("Unet").fit`` for 300
    cycles of batch 32 on 64 x 256 x 256 frames, then ``predict``: launch
    count, the main path's labeller checks and times on the trained masks,
    held-out IoU and atom error, ``refine=True``; times of the first fit,
    of a warm 300-cycle run, and of predict;
11. iou_protocol: the port arm of the IoU-parity protocol v2
    (`scripts/measure_iou_parity.py`), seeds 1-3, beside the JAX arm's;
12. augment: ``fit`` with config D's augmentation on 32 x 512 x 512
    frames, and each op's apply half on the card against the same op on
    the CPU with the same draws;
13. refine_fixture: ``peak_refinement`` on the card against the JAX
    package's golden fixture.
Then one JSON line on the kernels, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It imports neither JAX nor ``atomai_tpu``.
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
# spatial MLP kernels (bf16 operands, f32 accumulation) against their
# float32 plain versions: abs error / the plain output's max |value|
TOL_MLP_SCALED = 5e-2
# config C step against the JAX fixture, the decoder on the kernels
TOL_ELBO_REL = 1e-3
TOL_GRAD_SCALED = 5e-2
# Adam's first step moves every weight by lr * g / (|g| + eps); a gradient
# whose sign differs from the fixture's (tiny ones, under bf16 noise) moves
# it the other way: 2 * lr bounds any difference
LR = 1e-4
TOL_ADAM_ABS = 2 * LR + 1e-6

# shapes: the main path runs bench config A's stack
MAIN = dict(n_images=64, size=256, spacing=16, seed=0)
LATTICE = dict(n_images=64, size=512, spacing=16, seed=0)
RANDOM_SHAPES = [(512, 512), (509, 331), (2048, 2048)]
FULL_SHAPES = [(2048, 2048), (509, 331)]
RAGGED_SHAPES = [(33, 1), (1, 2048), (257, 33), (4099, 2)]
RANDOM_STACK = (8, 255, 2048)   # tiled to (2048, 2048)
SPIRAL = 1024
# (B, n, H, L) of the spatial MLP phase; the first is config C's
MLP_SHAPES = [(128, 1024, 128, 2), (128, 784, 128, 2), (32, 2560, 128, 2),
              (32, 1024, 256, 2), (16, 1024, 512, 2), (6, 300, 48, 0),
              (5, 333, 64, 3), (300, 64, 32, 1)]
RVAE_EPOCHS = 20
RVAE_BATCH = 128
MLP_NAMES = ["dx", "dzb", "dWc", "dbc", "dWs", "dbs", "dWo", "dbo"]

# seg_train_fixture: five Adam(1e-3) cycles against the JAX run. The c1
# conv bias sits before a BatchNorm, so its gradient cancels to rounding
# noise and Adam moves it by lr * sign(g) a step in a direction rounding
# picks; the eval-mode test loss follows through the lagging running mean.
# On the CPU: losses within 6.4e-5 (train) and 4.8e-4 (test) relative.
SEG_FX_CYCLES = 5
TOL_SEG_LOSS_REL = 1e-3
TOL_SEG_ADAM = 2 * 1e-3 * SEG_FX_CYCLES   # 2 * lr * steps
TOL_SEG_HEAD = 1e-4       # the px head's well-determined gradient
# bench config A's training (`bench.py:198-207`), its held-out check, the
# IoU protocol v2 (`scripts/measure_iou_parity.py:1-63`), config D's
# augmentation (`bench.py:366-368`) and the refinement fixture
SEG_CYCLES = 300
SEG_BATCH = 32
HELD_OUT = dict(n_images=8, size=256, spacing=16, seed=1)
TOL_IOU = 0.90
REFINE_D = 4              # a quarter of the 16 px spacing
IOU_DATA = dict(n_images=16, size=128, spacing=16, seed=7)
IOU_TRAIN, IOU_CYCLES, IOU_BATCH, IOU_SEEDS = 12, 100, 4, (1, 2, 3)
JAX_IOU_MEDIAN, JAX_IOU_MIN = 0.9745, 0.9449   # the JAX arm (BENCH_r05)
AUG = dict(rotation=True, zoom=True, gauss_noise=[10, 30],
           poisson_noise=[30, 45], salt_and_pepper=True, blur=True,
           contrast=True, background=True)
AUG_DATA = dict(n_images=32, size=512, spacing=16, seed=0)
AUG_CYCLES, AUG_BATCH = 30, 8
TOL_AUG = 1e-5            # float32 on both; sums of a few terms
TOL_REFINE_PX = 1e-3


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


def device_ms(fn, reps, device):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up run, by CUDA events. The runs are queued behind a sleep kernel
    that outlasts their enqueueing, so the host's time between launches
    (Python, ctypes, autograd) does not count: for kernels that take less
    time on the card than their launch takes on the host."""
    import torch
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))   # cycles, at <= 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def device_split(fn, device, reps=5):
    """Device microseconds a call of ``fn`` spends in each kernel (CUDA
    kernels, copies and fills by name), from a ``torch.profiler`` trace of
    ``reps`` calls after a warm-up."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = evt.cuda_time_total
        if us:
            name = re.sub(r"^.*?(cc_\w+|Memcpy \w+|Memset|\w+_kernel\w*)"
                          r".*$", r"\1", evt.key)[:60]
            split[name] = split.get(name, 0) + us / reps
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


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
    from concurrent.futures import ThreadPoolExecutor
    from atomai_tpu_torch.ops import cc_kernel, spatial_mlp

    def timed(build):
        t = time.perf_counter()
        build()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futures = {name: pool.submit(timed, mod.build) for name, mod in
                   (("cc_label", cc_kernel), ("spatial_mlp", spatial_mlp))}
        seconds = {name: f.result() for name, f in futures.items()}
    emit("build", seconds=time.perf_counter() - t0, per_source=seconds,
         ptxas=ptxas_report())


def ptxas_report():
    """Registers and spill bytes of each kernel, from the ``-Xptxas -v``
    output of this run's builds."""
    import re
    from atomai_tpu_torch.ops import _build
    report = {}
    for log in _build.BUILD_LOG.values():
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                # the kernel's name and template argument, out of the mangling
                k = re.search(r"\d+([a-z_]+(?:kernel|wgmma))(?:ILi(\d+)E)?",
                              m.group(1))
                k = k or re.search(r"_Z\d+([a-z_]+)()", m.group(1))
                name = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
                        if k else m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and name:
                report.setdefault(name, {})["spill_bytes"] = int(m.group(1)) \
                    + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                report.setdefault(name, {})["registers"] = int(m.group(1))
    return report


def kernel_cases(device, lattice_masks):
    """(name, mask as numpy, band, whether the plain labeller runs) of the
    labeller's checks."""
    import torch
    from atomai_tpu_torch.ops import tile_frames
    cases = []
    seed = 0
    for shape in RANDOM_SHAPES:
        for density in [0.1, 0.5, 0.59, 0.9]:
            rng = np.random.RandomState(seed)
            seed += 1
            cases.append((f"random{shape}@{density}",
                          rng.rand(*shape) < density, 0, True))
    for shape in FULL_SHAPES:
        cases += [(f"zeros{shape}", np.zeros(shape, bool), 0, True),
                  (f"ones{shape}", np.ones(shape, bool), 0, True)]
    # ragged and narrow tiles (the kernel's tiles are 32 x 64)
    for shape in RAGGED_SHAPES:
        rng = np.random.RandomState(seed)
        seed += 1
        cases.append((f"ragged{shape}@0.6", rng.rand(*shape) < 0.6, 0, True))
    # min-propagation needs ~H*W/2 sweeps on a spiral: scipy only
    cases.append((f"spiral({SPIRAL},{SPIRAL})", spiral_mask(SPIRAL), 0,
                  False))
    tiled = tile_frames(torch.from_numpy(lattice_masks > 0).to(device))
    cases.append((f"lattice_tiled{tuple(tiled.shape)}", tiled.cpu().numpy(),
                  lattice_masks.shape[1] + 1, True))
    n, h, w = RANDOM_STACK
    frames = np.random.RandomState(seed).rand(n, h, w) < 0.5
    tiled = tile_frames(torch.from_numpy(frames)).numpy()
    cases.append((f"random_tiled{tiled.shape}", tiled, h + 1, True))
    return cases


def check_kernel_case(device, name, mask, band, with_plain):
    """The kernel's labels (alone and with the sums fused in) against scipy
    and, ``with_plain``, the plain labeller, exactly; its fused sums and
    blob order against the plain sums of the reference labels, exactly.
    Returns the number of components."""
    import torch
    from atomai_tpu_torch.ops import cc_kernel, cc_label
    m = torch.from_numpy(mask).to(device)
    got = cc_kernel.label_components_cuda(m)
    fused = cc_kernel.launch(m, band).labels
    sums = cc_kernel.blob_sums_cuda(m, band)
    again = cc_kernel.blob_sums_cuda(m, band)
    torch.cuda.synchronize(device)
    got = got.cpu().numpy()
    want = scipy_labels(mask)
    check(np.array_equal(got, want), f"kernel != scipy oracle on {name}")
    check(np.array_equal(fused.cpu().numpy(), want),
          f"fused kernel's labels != scipy oracle on {name}")
    if with_plain:
        ref = cc_kernel.label_components_reference(m)
        torch.cuda.synchronize(device)
        check(np.array_equal(got, ref.cpu().numpy()),
              f"kernel != plain labeller on {name}")
    ref_sums = cc_label._blob_extract(*cc_label._blob_moments(
        torch.from_numpy(want).to(device), band))
    for label, a, b, c in zip(("roots", "counts", "row sums", "col sums"),
                              sums, ref_sums, again):
        check(torch.equal(a, b), f"fused {label} != plain on {name}")
        check(torch.equal(a, c), f"fused {label} differ run to run on {name}")
    return int(len(sums[0]))


def phase_kernel(device, lattice_masks):
    results = {}
    for name, mask, band, with_plain in kernel_cases(device, lattice_masks):
        results[name] = check_kernel_case(device, name, mask, band,
                                          with_plain)
    emit("kernel", cases=len(results), components=results, exact=True)


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
    from atomai_tpu_torch.ops import cc_kernel
    from atomai_tpu_torch.predictors import SegPredictor
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
    lab = labeller_on(maps, device)
    # random weights mark nearly every pixel: one component per frame. The
    # ground-truth masks of the same stack are what a trained net marks.
    gt = ops.tile_frames(torch.from_numpy(gt_masks > 0).to(device))
    gt_kernel_ms = device_ms(lambda: cc_kernel.launch(gt, size + 1), 20,
                             device)
    gt_plain_ms = cuda_ms(lambda: ops.blob_sums_reference(gt, size + 1), 3,
                          device)
    forward_ms = cuda_ms(lambda: pred.predict_device(imgs), 5, device)
    predict_ms = cuda_ms(lambda: m.predict(imgs, verbose=False), 5, device)
    emit("main_path", maps=list(nn_output.shape), frames=len(coords),
         atoms=int(sum(len(c) for c in coords.values())),
         launches=launches, maps_repeat_max_diff=repeat_diff,
         predict_ms=predict_ms, forward_ms=forward_ms, **lab,
         gt_mask_kernel_ms=gt_kernel_ms, gt_mask_kernel_plain_ms=gt_plain_ms)
    # no one PyTorch call labels connected components: no library time
    return {"name": "cc_label", "route": "cuda",
            "source": "atomai_tpu_torch/csrc/cc_label.cu",
            "replaces": "atomai_tpu/ops/pallas_cc.py:27",
            "launches": launches, "max_abs_err": lab["max_abs_err"],
            "ms": lab["kernel_ms"], "plain_ms": lab["kernel_plain_ms"],
            "bound_ms": lab["bound_ms"], "bound_by": lab["bound_by"],
            "share_of_bound": lab["share_of_bound"], "library_ms": None,
            "labels_only_ms": lab["labels_only_ms"],
            "locate_ms": lab["locate_ms"]}


def labeller_on(maps, device):
    """The Locator's labelling of the (N, H, W, 1) device ``maps`` at 0.5,
    by the kernel and by the plain version: labels, fused sums and the
    Locator's coordinates must agree exactly. Times (CUDA events after a
    warm-up; the kernel by queued device time): the fused kernel
    (``kernel_ms``, labels and sums: what the Locator launches) and its
    plain version, the kernel without the sums and the plain labeller, and
    the Locator on each route; the bound on the fused kernel's bytes."""
    import torch
    from atomai_tpu_torch import ops
    from atomai_tpu_torch.ops import cc_kernel, cc_label, roofline
    from atomai_tpu_torch.predictors import Locator
    tiled = ops.tile_frames(maps[..., 0] > 0.5)
    band = maps.shape[1] + 1
    lab_k = ops.label_components_cuda(tiled)
    lab_r = ops.label_components_reference(tiled)
    max_abs_err = int((lab_k.long() - lab_r.long()).abs().max())
    check(max_abs_err == 0, f"kernel labels off by {max_abs_err}")
    sums_k = ops.blob_sums_cuda(tiled, band)
    sums_r = ops.blob_sums_reference(tiled, band)
    check(all(torch.equal(a, b) for a, b in zip(sums_k, sums_r)),
          "fused sums differ from the plain version's")
    locator = Locator(0.5)
    coords_kernel = locator.run(maps)
    fused = cc_label.blob_sums
    cc_label.blob_sums = ops.blob_sums_reference
    try:
        coords_plain = locator.run(maps)
        locate_plain_ms = cuda_ms(lambda: locator.run(maps), 3, device)
    finally:
        cc_label.blob_sums = fused
    check(coords_plain.keys() == coords_kernel.keys(), "frames differ")
    for i in coords_kernel:
        check(np.array_equal(coords_kernel[i], coords_plain[i]),
              f"frame {i}: coordinates differ from the plain labeller's")
    blobs = int(len(sums_k[0]))
    kernel_ms = device_ms(lambda: cc_kernel.launch(tiled, band), 20, device)
    # where a locate call's device time goes (the rest of its wall time is
    # the host's: torch's launches, the two syncs, numpy)
    split = device_split(lambda: locator.run(maps), device)
    bound_ms, bound_by = roofline.bound(0, cc_kernel.cc_label_bytes(
        *tiled.shape, blobs))
    return dict(
        tiled_mask=list(tiled.shape), blobs=blobs,
        foreground_share=float(tiled.float().mean()),
        max_abs_err=max_abs_err, kernel_ms=kernel_ms,
        kernel_plain_ms=cuda_ms(lambda: ops.blob_sums_reference(tiled, band),
                                3, device),
        labels_only_ms=device_ms(lambda: ops.label_components_cuda(tiled),
                                 20, device),
        labels_plain_ms=cuda_ms(
            lambda: ops.label_components_reference(tiled), 3, device),
        locate_ms=cuda_ms(lambda: locator.run(maps), 20, device),
        locate_plain_ms=locate_plain_ms,
        locate_device_ms=sum(split.values()) / 1e3,
        locate_device_us={k: round(v, 2) for k, v in split.items()},
        bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / kernel_ms)


def mlp_inputs(B, n, H, L, seed, device):
    """Random spatial-MLP inputs at the scales the decoder gives them."""
    import torch
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    args = (torch.rand(B, 2, n, generator=g) * 2 - 1, r(B, H, scale=0.3),
            r(2, H, scale=0.5), r(1, H, scale=0.1),
            r(L, H, H, scale=H ** -0.5), r(L, H, scale=0.1),
            r(H, 1, scale=H ** -0.5), r(1, 1, scale=0.1))
    return [a.to(device) for a in args], r(B, 1, n, scale=0.1).to(device)


def scaled_err(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-3)


def phase_spatial_mlp(device):
    import torch
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.ops import spatial_mlp as sm
    rows = []
    with Precision.full().scope(device):   # plain versions without TF32
        for i, (B, n, H, L) in enumerate(MLP_SHAPES):
            args, gy = mlp_inputs(B, n, H, L, i, device)
            y = sm.spatial_mlp_forward_cuda(*args)
            grads = sm.spatial_mlp_backward_cuda(*args, gy)
            again = sm.spatial_mlp_backward_cuda(*args, gy)
            torch.cuda.synchronize(device)
            y_ref = sm.spatial_mlp_reference(*args)
            g_ref = sm.spatial_mlp_backward_reference(*args, gy)
            errs = {"y": scaled_err(y, y_ref)}
            errs.update({name: scaled_err(a, b) for name, a, b in
                         zip(MLP_NAMES, grads, g_ref) if b.numel()})
            abs_fwd = float((y - y_ref).abs().max())
            abs_bwd = max(float((a - b).abs().max()) for a, b in
                          zip(grads, g_ref) if b.numel())
            deterministic = all(torch.equal(a, b)
                                for a, b in zip(grads, again))
            worst = max(errs, key=errs.get)
            check(errs[worst] <= TOL_MLP_SCALED,
                  f"spatial_mlp {(B, n, H, L)}: {worst} off by "
                  f"{errs[worst]} of its scale")
            check(deterministic, f"spatial_mlp {(B, n, H, L)}: two backward "
                  "runs differ")
            rows.append({"shape": [B, n, H, L], "scaled_err": errs,
                         "max_abs_err_fwd": abs_fwd,
                         "max_abs_err_bwd": abs_bwd})
    emit("spatial_mlp", cases=rows, deterministic=True,
         tolerance_scaled=TOL_MLP_SCALED)
    return rows[0]["max_abs_err_fwd"], rows[0]["max_abs_err_bwd"]


def flat_params(model):
    return {f"{part}.{k}": p for part, net in
            (("encoder", model.encoder_net), ("decoder", model.decoder_net))
            for k, p in net.named_parameters()}


def phase_rvae_fixture(device):
    import torch
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.models import rVAE, vae_from_jax
    fx = dict(np.load(os.path.join(FIXTURES, "torch_port_rvae_step.npz")))
    m = rVAE((32, 32), latent_dim=2, device=device)
    m.load_jax_params(unflatten(fx, "params"))
    m.dx_prior = 0.1
    m.kdict_["phi_prior"] = 0.1
    m.precision = Precision.full()   # the encoder in float32, TF32 off
    m.compile_trainer((fx["x"], None), training_cycles=1,
                      batch_size=len(fx["x"]))
    x = torch.from_numpy(fx["x"]).to(device)
    eps = torch.from_numpy(fx["eps"]).to(device)
    m.optimizer.zero_grad()
    with m.precision.scope(device):
        elbo = m.forward_compute_elbo(x, None, 0, eps=eps)
    (-elbo).backward()
    elbo_err = abs(float(elbo.detach()) - float(fx["elbo"])) / abs(
        float(fx["elbo"]))
    check(elbo_err <= TOL_ELBO_REL, f"ELBO off by {elbo_err} (relative)")

    def as_flat(pair):
        return {f"{part}.{k}": v for part, tree in zip(("encoder", "decoder"),
                                                       pair)
                for k, v in tree.items()}

    params = flat_params(m)
    grads_ref = as_flat(vae_from_jax(unflatten(fx, "grads"), m.metadict))
    grad_errs = {k: scaled_err(-params[k].grad.cpu(), grads_ref[k])
                 for k in grads_ref}
    worst = max(grad_errs, key=grad_errs.get)
    check(grad_errs[worst] <= TOL_GRAD_SCALED,
          f"gradient of {worst} off by {grad_errs[worst]} of its scale")
    before = {k: p.detach().clone() for k, p in params.items()}
    m.optimizer.step()
    # torch's Adam is optax's on the card: the first step on the loss -ELBO
    # is -lr * g / (|g| + eps), g the loss's gradient
    adam_formula = max(float((params[k].detach() - before[k] + LR * (
        params[k].grad / (params[k].grad.abs() + 1e-8))).abs().max())
        for k in params)
    # (1e-6 = 1% of the step: room for the float32 rounding of the weights)
    check(adam_formula <= 1e-6, f"Adam's first step is off by {adam_formula}")
    adam_ref = as_flat(vae_from_jax(unflatten(fx, "adam"), m.metadict))
    adam_err = max(float((params[k].detach().cpu() - adam_ref[k]).abs().max())
                   for k in adam_ref)
    far = sum(int(((params[k].detach().cpu() - adam_ref[k]).abs() > 1e-6)
                  .sum()) for k in adam_ref)
    check(adam_err <= TOL_ADAM_ABS, f"Adam step off by {adam_err}")
    emit("rvae_fixture", elbo=float(elbo.detach()),
         elbo_ref=float(fx["elbo"]), elbo_rel_err=elbo_err,
         grad_scaled_err=grad_errs, adam_formula_err=adam_formula,
         adam_max_abs_err=adam_err, adam_params_off_by_over_1e6=far,
         n_params=sum(p.numel() for p in params.values()),
         tolerances={"elbo_rel": TOL_ELBO_REL, "grad_scaled":
                     TOL_GRAD_SCALED, "adam_abs": TOL_ADAM_ABS})


def config_c_patches():
    """Bench config C's 1024 patches (`bench.py:300-304`)."""
    from atomai_tpu_torch.utils import extract_patches_2d, make_lattice_stack
    images, _, _ = make_lattice_stack(n_images=2, size=256, spacing=16,
                                      seed=3)
    return np.concatenate([extract_patches_2d(p, (32, 32), 512, i)
                           for i, p in enumerate(images)])


def decoder_args(model, x, device):
    """The spatial MLP's inputs as ``rVAE.forward_compute_elbo`` builds
    them for the batch ``x`` (its shapes and values)."""
    import torch
    from atomai_tpu_torch.core import head_f32
    from atomai_tpu_torch.utils import transform_coordinates
    with torch.no_grad():
        z_mean, _ = model.encoder_net(x)
        xc = transform_coordinates(
            model.x_coord.expand((len(x),) + model.x_coord.shape),
            z_mean[:, 0], (z_mean[:, 1:3] * model.dx_prior)[:, None])
        dec = model.decoder_net
        cl = dec.coord_latent
        hidden = [dec.fc_decoder[2 * i]
                  for i in range(len(dec.fc_decoder) // 2)]
        args = (xc.transpose(1, 2), head_f32(cl.fc_latent, z_mean[:, 3:]),
                cl.fc_coord.weight.T, cl.fc_coord.bias[None],
                torch.stack([m.weight.T for m in hidden]),
                torch.stack([m.bias for m in hidden]), dec.out.weight.T,
                dec.out.bias[None])
    return [a.float().contiguous() for a in args]


def loop_rate(model, fname, steps, device):
    """The production loop body (epoch, metadict, async checkpoint) for
    ``RVAE_EPOCHS`` epochs of ``steps`` steps, warm: steps/s and ms by CUDA
    events, host seconds, and the last epoch's ELBO."""
    import torch
    from atomai_tpu_torch.core import flush_async_checkpoints
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    start.record()
    for _ in range(RVAE_EPOCHS):
        elbo = model.train_epoch_lazy()
        model.update_metadict()
        model.save_model(fname, async_write=True)
    end.record()
    flush_async_checkpoints()
    torch.cuda.synchronize(device)
    loop_s = time.perf_counter() - t0
    loop_ms = start.elapsed_time(end)
    return RVAE_EPOCHS * steps / (loop_ms / 1e3), loop_ms, loop_s, float(elbo)


@contextlib.contextmanager
def stock_decoder(model):
    """The decoder on its per-layer route (``fused()`` false): cuBLAS GEMMs
    and elementwise tanh under the model's precision policy."""
    model.decoder_net.fused = lambda: False
    try:
        yield
    finally:
        del model.decoder_net.fused


def phase_rvae_path(device, mlp_errs):
    import tempfile
    import torch
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.models import rVAE
    from atomai_tpu_torch.ops import roofline
    from atomai_tpu_torch.ops import spatial_mlp as sm
    X = config_c_patches()
    steps = len(X) // RVAE_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "rvae")
        m = rVAE((32, 32), latent_dim=2, device=device)
        check(m.decoder_net.fused(), "config C's decoder does not route to "
              "the kernels")
        sm.FORWARD_LAUNCHES = sm.BACKWARD_LAUNCHES = 0
        t0 = time.perf_counter()
        m.fit(X, training_cycles=RVAE_EPOCHS, batch_size=RVAE_BATCH,
              filename=fname, verbose=False)
        fit_s = time.perf_counter() - t0
        manifold = m.manifold2d()
        torch.cuda.synchronize(device)
        launches = (sm.FORWARD_LAUNCHES, sm.BACKWARD_LAUNCHES)
        hist = m.loss_history["train_loss"]
        check(launches[0] > 0 and launches[1] > 0,
              f"the rVAE path launched the kernels {launches} times")
        check(len(hist) == RVAE_EPOCHS and bool(np.isfinite(hist).all()),
              "non-finite or missing epoch ELBOs")
        check(hist[-1] > hist[0], f"ELBO did not rise: {hist[0]} -> "
              f"{hist[-1]}")
        check(manifold.shape == (9 * 32, 9 * 32) and
              bool(np.isfinite(manifold).all()), "bad manifold2d output")
        check(os.path.exists(fname + ".aoit"), "no checkpoint written")
        z_mean, _ = m.encode(X[:256])
        rec = m.reconstruct(X[:4], num_samples=8)
        check(z_mean.shape == (256, 5) and rec.shape == (32, 32, 32) and
              bool(np.isfinite(rec).all()), "bad encode/reconstruct output")

        # steps/s of the production loop (warm: the fit above), on the
        # kernels and on the stock route, in turns: kernel, stock, stock,
        # kernel
        with stock_decoder(m):
            m.train_epoch_lazy()          # warm-up: cuBLAS plans
        rates = {"kernel": [], "stock": []}
        for route in ("kernel", "stock", "stock", "kernel"):
            with (stock_decoder(m) if route == "stock"
                  else contextlib.nullcontext()):
                rates[route].append(loop_rate(m, fname, steps, device))
        check(all(np.isfinite(r[3]) for v in rates.values() for r in v),
              "non-finite ELBO in the timed loops")

    # kernel against plain, bound and stock route at the path's own shapes
    x = torch.from_numpy(X[:RVAE_BATCH]).to(device)
    args = decoder_args(m, x, device)
    gy = torch.randn((RVAE_BATCH, 1, X.shape[1] * X.shape[2]),
                     generator=torch.Generator(device).manual_seed(0),
                     device=device) * 1e-2
    with Precision.full().scope(device):
        fwd_ms = device_ms(lambda: sm.spatial_mlp_forward_cuda(*args), 50,
                         device)
        fwd_plain_ms = device_ms(lambda: sm.spatial_mlp_reference(*args), 50,
                               device)
        bwd_ms = device_ms(lambda: sm.spatial_mlp_backward_cuda(*args, gy), 50,
                         device)
        bwd_plain_ms = device_ms(
            lambda: sm.spatial_mlp_backward_reference(*args, gy), 50, device)
        y_err = scaled_err(sm.spatial_mlp_forward_cuda(*args),
                           sm.spatial_mlp_reference(*args))
    check(y_err <= TOL_MLP_SCALED, f"kernel off by {y_err} at the path's "
          "own decoder inputs")

    # the whole decoder call, forward and forward + autograd backward, on
    # each route under the model's bf16 policy
    dec = m.decoder_net
    with torch.no_grad():
        z = m.encoder_net(x)[0][:, 3:].contiguous()
    xc = args[0].transpose(1, 2).contiguous()
    gy_img = gy.reshape((RVAE_BATCH,) + X.shape[1:])

    def dec_fwd():
        with m.precision.scope(device), torch.no_grad():
            return dec(xc, z)

    def dec_fwd_bwd():
        zz = z.detach().requires_grad_()
        with m.precision.scope(device):
            y = dec(xc, zz)
        with m.precision.tf32_scope():
            torch.autograd.backward(y, gy_img)

    # 10 runs: tens of launches each must stay within the card's launch
    # queue, or a slow host starves the card and its time counts again
    route_ms = {}
    with stock_decoder(m):
        stock_out = dec_fwd()
        route_ms["stock_fwd"] = device_ms(dec_fwd, 10, device)
        route_ms["stock_fwd_bwd"] = device_ms(dec_fwd_bwd, 10, device)
    kernel_out = dec_fwd()
    route_ms["kernel_fwd"] = device_ms(dec_fwd, 10, device)
    route_ms["kernel_fwd_bwd"] = device_ms(dec_fwd_bwd, 10, device)
    routes_err = scaled_err(kernel_out.float(), stock_out.float())
    check(routes_err <= TOL_MLP_SCALED, f"the decoder's two routes differ by "
          f"{routes_err} of scale")
    # the stock route's backward alone: its forward + backward less its
    # forward
    stock_fwd_ms = route_ms["stock_fwd"]
    stock_bwd_ms = route_ms["stock_fwd_bwd"] - route_ms["stock_fwd"]

    dims = (RVAE_BATCH, X.shape[1] * X.shape[2], args[2].shape[1],
            args[4].shape[0])
    flops = sm.spatial_mlp_flops(*dims)
    nbytes = sm.spatial_mlp_bytes(*dims)
    bounds = [roofline.bound(f, b) for f, b in zip(flops, nbytes)]
    kernel_rate = [r[0] for r in rates["kernel"]]
    stock_rate = [r[0] for r in rates["stock"]]
    emit("rvae_path", patches=list(X.shape), epochs=RVAE_EPOCHS,
         batch=RVAE_BATCH, steps_per_epoch=steps,
         fwd_launches=launches[0], bwd_launches=launches[1],
         elbo_first=hist[0], elbo_last=hist[-1], fit_s=fit_s,
         loop_steps_per_s=kernel_rate, loop_steps_per_s_stock=stock_rate,
         loop_ms_cuda_events={k: [r[1] for r in v] for k, v in rates.items()},
         loop_s_host={k: [r[2] for r in v] for k, v in rates.items()},
         fwd_kernel_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
         bwd_kernel_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
         fwd_bound_ms=bounds[0][0], bwd_bound_ms=bounds[1][0],
         fwd_share_of_bound=bounds[0][0] / fwd_ms,
         bwd_share_of_bound=bounds[1][0] / bwd_ms,
         flops={"fwd": flops[0], "bwd": flops[1]},
         decoder_route_ms=route_ms, decoder_routes_scaled_err=routes_err,
         path_inputs_scaled_err=y_err,
         precision=str(Precision.mixed().compute_dtype))
    source = "atomai_tpu_torch/csrc/spatial_mlp.cu"
    # no one PyTorch call computes the fused MLP: no library time; the
    # stock route is the decoder's per-layer route (several calls)
    return [{"name": "spatial_mlp_fwd", "route": "cuda", "source": source,
             "replaces": "atomai_tpu/ops/pallas_mlp.py:80",
             "launches": launches[0], "max_abs_err": mlp_errs[0],
             "ms": fwd_ms, "plain_ms": fwd_plain_ms,
             "bound_ms": bounds[0][0], "bound_by": bounds[0][1],
             "share_of_bound": bounds[0][0] / fwd_ms, "library_ms": None,
             "stock_ms": stock_fwd_ms},
            {"name": "spatial_mlp_bwd", "route": "cuda", "source": source,
             "replaces": "atomai_tpu/ops/pallas_mlp.py:94",
             "launches": launches[1], "max_abs_err": mlp_errs[1],
             "ms": bwd_ms, "plain_ms": bwd_plain_ms,
             "bound_ms": bounds[1][0], "bound_by": bounds[1][1],
             "share_of_bound": bounds[1][0] / bwd_ms, "library_ms": None,
             "stock_ms": stock_bwd_ms}]


@contextlib.contextmanager
def quiet():
    """Keeps the trainers' progress prints off the script's output."""
    with contextlib.redirect_stdout(io.StringIO()):
        yield


def mean_jaccard(prob_fg, true):
    """The IoU protocol's neutral metric (`scripts/measure_iou_parity.py:
    72-83`): threshold at 0.5, 2-class confusion histogram over all frames,
    mean Jaccard over the classes."""
    pred = (np.asarray(prob_fg) >= 0.5).astype(np.int64).ravel()
    true = (np.asarray(true) > 0.5).astype(np.int64).ravel()
    hist = np.bincount(2 * true + pred, minlength=4).reshape(2, 2)
    inter = np.diag(hist).astype(np.float64)
    jcd = inter / (hist.sum(1) + hist.sum(0) - inter + 1e-10)
    return float(np.mean(jcd[~np.isnan(jcd)]))


def atom_errors(coords, true_xy, offset):
    from scipy.spatial import cKDTree
    return np.concatenate([
        cKDTree(true_xy[i] + offset).query(coords[i][:, :2])[0]
        for i in range(len(true_xy))])


def phase_seg_train_fixture(device):
    import torch
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.models import Segmentor, conversion
    fx = dict(np.load(os.path.join(FIXTURES, "torch_port_seg_train.npz")))
    base = dict(np.load(os.path.join(FIXTURES, "torch_port_unet_fwd.npz")))
    m = Segmentor("Unet", 1, nb_filters=16, layers=(1, 2, 2, 3),
                  device=device)
    m.load_jax_variables(unflatten(base, "params"),
                         unflatten(base, "batch_stats"))
    m.precision = Precision.full()     # float32, TF32 off
    with tempfile.TemporaryDirectory() as tmp, quiet():
        m.compile_trainer((fx["x_train"], fx["y_train"], fx["x_test"],
                           fx["y_test"]), training_cycles=SEG_FX_CYCLES,
                          batch_size=4, print_loss=SEG_FX_CYCLES,
                          filename=os.path.join(tmp, "seg"))
        check(np.array_equal(m.batch_idx_train, fx["schedule"]),
              "batch schedule differs from the fixture's")
        m.run()
    loss_err = {k: float(np.max(np.abs(np.asarray(m.loss_acc[k]) / fx[k]
                                       - 1)))
                for k in ("train_loss", "test_loss")}
    for k, err in loss_err.items():
        check(err <= TOL_SEG_LOSS_REL, f"{k} off by {err} (relative)")
    final = unflatten(fx, "final")
    want = {f"c1.{k}": v for k, v in conversion._conv_block(
        final["params"]["ConvBlock_0"], final["batch_stats"]["ConvBlock_0"],
        False, "ConvBlock_0").items()}
    want.update({f"px.{k}": v for k, v in conversion._conv(
        final["params"]["Conv_0"], "Conv_0").items()})
    got = m.net.state_dict()
    w_err = {}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = float((got[k].float().cpu() - w).abs().max())
        if k.endswith("running_var"):
            # relative: the c1 weights may differ by 2 * lr * steps (3% of
            # their scale); BatchNorm's n / (n - 1) adds 6e-5
            err /= float(w.abs().max())
            tol = 1e-2
        else:
            tol = TOL_SEG_HEAD if k.startswith("px.") else TOL_SEG_ADAM
        w_err[k] = err
        check(err <= tol, f"{k} off by {err} (tolerance {tol})")
    emit("seg_train_fixture", cycles=SEG_FX_CYCLES,
         train_loss=m.loss_acc["train_loss"],
         train_loss_ref=fx["train_loss"].tolist(),
         test_loss=m.loss_acc["test_loss"],
         test_loss_ref=fx["test_loss"].tolist(), loss_rel_err=loss_err,
         weight_err=w_err, precision=str(m.precision.compute_dtype),
         tolerances={"loss_rel": TOL_SEG_LOSS_REL, "adam": TOL_SEG_ADAM,
                     "head": TOL_SEG_HEAD})


def phase_seg_path(device):
    import torch
    from atomai_tpu_torch import models
    from atomai_tpu_torch.ops import cc_kernel
    from atomai_tpu_torch.predictors import SegPredictor
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, masks, _ = make_lattice_stack(**MAIN)
    with tempfile.TemporaryDirectory() as tmp, quiet():
        m = models.Segmentor("Unet", 1, seed=1, device=device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        m.fit(imgs, masks, training_cycles=SEG_CYCLES, batch_size=SEG_BATCH,
              print_loss=SEG_CYCLES, filename=os.path.join(tmp, "seg"))
        torch.cuda.synchronize(device)
        fit_s = time.perf_counter() - t0
        hist = list(m.loss_acc["train_loss"])
        test_hist = list(m.loss_acc["test_loss"])
        # the warm production loop: another 300 cycles of run()
        m._reset_training_history()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        start.record()
        m.run()
        end.record()
        torch.cuda.synchronize(device)
        run_s = time.perf_counter() - t0
        run_ms = start.elapsed_time(end)
    staged = [list(m.Xb_train.shape), list(m.Xb_test.shape)]
    check(staged == [[1, SEG_BATCH, 256, 256, 1], [1, 10, 256, 256, 1]],
          f"config A staged as {staged}")
    check(len(hist) == SEG_CYCLES and bool(np.isfinite(hist).all()) and
          bool(np.isfinite(test_hist).all()), "non-finite losses")
    check(hist[-1] < hist[0], f"train loss did not fall: {hist[0]} -> "
          f"{hist[-1]}")

    cc_kernel.LAUNCHES = 0
    maps, coords = m.predict(imgs, verbose=False)
    torch.cuda.synchronize(device)
    launches = cc_kernel.LAUNCHES
    check(launches > 0, "predict after fit never launched the labeller")
    check(maps.shape == (64, 256, 256, 1) and len(coords) == 64,
          "bad predict output")

    # the trained masks, labelled by the kernel and by the plain version
    pred = SegPredictor(m.net, nb_classes=1, verbose=False)
    lab = labeller_on(pred.predict_device(imgs), device)
    predict_ms = cuda_ms(lambda: m.predict(imgs, verbose=False), 5, device)

    # held-out frames: mask IoU, atom error, refinement
    h_imgs, h_masks, h_xy = make_lattice_stack(**HELD_OUT)
    prob = m.predict(h_imgs, compute_coords=False, verbose=False)
    iou = mean_jaccard(prob[..., 0], h_masks)
    check(iou >= TOL_IOU, f"held-out IoU {iou}")
    _, h_coords = m.predict(h_imgs, verbose=False)
    err = atom_errors(h_coords, h_xy, MASK_OFFSET)
    median = float(np.median(err))
    check(median < TOL_MEDIAN_PX, f"held-out median atom error {median} px")
    with quiet():
        _, r_coords = m.predict(h_imgs, refine=True, d=REFINE_D,
                                verbose=False)
    moved = 0.0
    for i in h_coords:
        check(r_coords[i].shape == h_coords[i].shape and
              bool(np.isfinite(r_coords[i]).all()), f"frame {i} refined")
        if len(h_coords[i]):
            moved = max(moved, float(np.abs(r_coords[i][:, :2] -
                                            h_coords[i][:, :2]).max()))
    check(moved < 3.0, f"refinement moved an atom {moved} px")
    # the generator pastes each atom at its rounded position, so the fit's
    # target is np.round(true); the unrounded one is 0.38 px off it
    refined_median = float(np.median(atom_errors(
        r_coords, [np.round(xy) for xy in h_xy], 0.0)))
    check(refined_median < TOL_MEDIAN_PX, f"refined median error "
          f"{refined_median} px")
    emit("seg_path", frames=list(imgs.shape), staged=staged,
         cycles=SEG_CYCLES, batch=SEG_BATCH, loss_first=hist[0],
         loss_last=hist[-1], test_loss_last=test_hist[-1], fit_s=fit_s,
         run_s_host=run_s, run_ms_cuda_events=run_ms,
         cycles_per_s=SEG_CYCLES / (run_ms / 1e3), launches=launches,
         atoms=int(sum(len(c) for c in coords.values())),
         predict_ms=predict_ms, trained_masks=lab, held_out_iou=iou,
         held_out_median_err_px=median,
         refined_median_err_px=refined_median, refine_max_move_px=moved,
         precision=str(m.precision.compute_dtype))
    return {"launches": launches, "max_abs_err": lab["max_abs_err"],
            "ms": lab["kernel_ms"], "plain_ms": lab["kernel_plain_ms"],
            "bound_ms": lab["bound_ms"], "bound_by": lab["bound_by"],
            "share_of_bound": lab["share_of_bound"],
            "labels_only_ms": lab["labels_only_ms"],
            "locate_ms": lab["locate_ms"], "blobs": lab["blobs"]}


def phase_iou_protocol(device):
    from atomai_tpu_torch.models import Segmentor
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, masks, _ = make_lattice_stack(**IOU_DATA)
    ious = []
    with tempfile.TemporaryDirectory() as tmp, quiet():
        for seed in IOU_SEEDS:
            m = Segmentor("Unet", 1, seed=seed, device=device)
            m.fit(imgs[:IOU_TRAIN], masks[:IOU_TRAIN], imgs[IOU_TRAIN:],
                  masks[IOU_TRAIN:], training_cycles=IOU_CYCLES,
                  batch_size=IOU_BATCH, print_loss=IOU_CYCLES, seed=seed,
                  filename=os.path.join(tmp, "iou"))
            prob = m.predict(imgs[IOU_TRAIN:], compute_coords=False,
                             verbose=False)
            ious.append(mean_jaccard(prob[..., 0], masks[IOU_TRAIN:]))
    median = float(np.median(ious))
    check(median >= TOL_IOU, f"IoU protocol median {median}")
    emit("iou_protocol", seeds=list(IOU_SEEDS), ious=ious, median=median,
         jax_arm_median=JAX_IOU_MEDIAN, jax_arm_min=JAX_IOU_MIN,
         below_jax_min=median < JAX_IOU_MIN, gate=TOL_IOU)


def phase_augment(device):
    import torch
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.models import Segmentor
    from atomai_tpu_torch.transforms import DataTransform
    from atomai_tpu_torch.transforms import imaug
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, masks, _ = make_lattice_stack(**AUG_DATA)
    with tempfile.TemporaryDirectory() as tmp, quiet():
        m = Segmentor("Unet", 1, seed=1, device=device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        m.fit(imgs, masks, training_cycles=AUG_CYCLES, batch_size=AUG_BATCH,
              print_loss=AUG_CYCLES, filename=os.path.join(tmp, "aug"), **AUG)
        torch.cuda.synchronize(device)
        fit_s = time.perf_counter() - t0
    hist = m.loss_acc["train_loss"] + m.loss_acc["test_loss"]
    check(len(hist) == 2 * AUG_CYCLES and bool(np.isfinite(hist).all()),
          "non-finite augmented-training losses")

    # each op's apply on the card against the CPU, with the same draws,
    # chained as in the pipeline so that each op sees its real input
    dt = DataTransform(1, **AUG)
    x = torch.from_numpy(imgs[:AUG_BATCH]).to(device)
    x = (x - x.min()) / (x.max() - x.min())
    gts = torch.from_numpy(masks[:AUG_BATCH, ..., None] > 0).float().to(
        device)
    g = torch.Generator(device).manual_seed(0)
    grids = {"zoom": imaug.zoom_grid, "resize": imaug.resize_grid}
    rows = {}
    for name, draw, apply in dt.ops(tuple(x.shape)):
        p = draw(g, x)
        p_cpu = {k: v.cpu() for k, v in p.items()}
        with Precision.full().scope(device):
            xi, gi = apply(x, gts, p)
        xc, gc = apply(x.cpu(), gts.cpu(), p_cpu)
        err = float((xi.cpu() - xc).abs().max())
        flips = int((gi.cpu() != gc).sum())
        ties = 0
        if name in grids:
            # a warped mask value within 1e-5 of 0.5 may round either way
            from atomai_tpu_torch.transforms import separable_sample_nhwc
            ys, xs = grids[name](x.cpu(), p_cpu, apply.keywords["values"])
            raw = separable_sample_nhwc(gts.cpu(), ys, xs)
            ties = int(((raw - 0.5).abs() < 1e-5).sum())
        check(err <= TOL_AUG, f"{name}: card and CPU apply differ by {err}")
        check(flips <= ties, f"{name}: {flips} label pixels differ "
              f"({ties} ties)")
        rows[name] = {"max_abs_err": err, "label_flips": flips,
                      "label_ties": ties}
        x, gts = xi, gi
    emit("augment", frames=list(imgs.shape), cycles=AUG_CYCLES,
         batch=AUG_BATCH, fit_s=fit_s, loss_first=hist[0],
         loss_last=m.loss_acc["train_loss"][-1], ops=rows,
         tolerance=TOL_AUG)


def phase_refine_fixture(device):
    import torch
    from atomai_tpu_torch.utils import make_lattice_stack, peak_refinement
    imgs, _, coords = make_lattice_stack(n_images=2, size=64, spacing=12,
                                         seed=7)
    c3 = np.concatenate([coords[0], np.zeros((len(coords[0]), 1))], -1)
    got = peak_refinement(torch.from_numpy(imgs[0]).to(device), c3, d=5)
    expected = np.load(os.path.join(FIXTURES, "refined_coords_frame0.npy"))
    check(got.shape == expected.shape, f"refined shape {got.shape}")
    err = float(np.abs(got - expected).max())
    check(err <= TOL_REFINE_PX, f"refined coordinates off by {err} px")
    emit("refine_fixture", atoms=int(len(got)), max_abs_err_px=err,
         tolerance_px=TOL_REFINE_PX)


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
    kernels = [phase_main_path(device)]
    mlp_errs = phase_spatial_mlp(device)
    phase_rvae_fixture(device)
    kernels += phase_rvae_path(device, mlp_errs)
    phase_seg_train_fixture(device)
    kernels[0]["trained_masks"] = phase_seg_path(device)
    phase_iou_protocol(device)
    phase_augment(device)
    phase_refine_fixture(device)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
