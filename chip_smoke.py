"""Drives the PyTorch port's two paths once on one CUDA card, the
segmentation serving path and rVAE training, and checks every step of them.

    python3 chip_smoke.py

Phases, one JSON line each (all before the last line):
 0. device: the card, the CUDA version, and ``nvidia-smi``'s name and power
    limit (also printed raw on a line of their own);
 1. build: compiles the CUDA sources of ``atomai_tpu_torch/csrc``, one nvcc
    for each, all started together, and times them;
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
    with CUDA events after warm-up;
 6. spatial_mlp: the rVAE decoder's forward and backward kernels against
    their plain versions on the same CUDA tensors, at config C's shapes
    (B 128, n 1024, H 128, L 2), at n 784 and 2560, at H 256 and 512 and at
    a few odd shapes; the backward run twice must agree bit for bit;
 7. rvae_fixture: one config C step (ELBO, every gradient, one Adam step)
    against the numbers the JAX package left in ``tests/fixtures/``;
 8. rvae_path: ``rVAE((32, 32), latent_dim=2).fit`` on bench config C's 1024
    patches for 20 epochs of batch 128 with per-epoch async checkpoints, then
    ``manifold2d``: launch counts of both kernels, a finite and rising ELBO,
    then steps/s of the loop and kernel against plain times at the path's
    shapes, with CUDA events after warm-up.
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
SPIRAL = 1024
# (B, n, H, L) of the spatial MLP phase; the first is config C's
MLP_SHAPES = [(128, 1024, 128, 2), (128, 784, 128, 2), (32, 2560, 128, 2),
              (32, 1024, 256, 2), (16, 1024, 512, 2), (6, 300, 48, 0),
              (5, 333, 64, 3), (300, 64, 32, 1)]
RVAE_EPOCHS = 20
RVAE_BATCH = 128
MLP_NAMES = ["dx", "dzb", "dWc", "dbc", "dWs", "dbs", "dWo", "dbo"]


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
    emit("build", seconds=time.perf_counter() - t0, per_source=seconds)


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


def phase_rvae_path(device, mlp_errs):
    import tempfile
    import torch
    from atomai_tpu_torch.core import Precision, flush_async_checkpoints
    from atomai_tpu_torch.models import rVAE
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

        # steps/s of the production loop body (warm: the fit above)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        start.record()
        for _ in range(RVAE_EPOCHS):
            m.train_epoch_lazy()
            m.update_metadict()
            m.save_model(fname, async_write=True)
        end.record()
        flush_async_checkpoints()
        torch.cuda.synchronize(device)
        loop_s = time.perf_counter() - t0
        loop_ms = start.elapsed_time(end)

    # kernel against plain at the path's own shapes and values
    x = torch.from_numpy(X[:RVAE_BATCH]).to(device)
    args = decoder_args(m, x, device)
    gy = torch.randn((RVAE_BATCH, 1, X.shape[1] * X.shape[2]),
                     generator=torch.Generator(device).manual_seed(0),
                     device=device) * 1e-2
    with Precision.full().scope(device):
        fwd_ms = cuda_ms(lambda: sm.spatial_mlp_forward_cuda(*args), 50,
                         device)
        fwd_plain_ms = cuda_ms(lambda: sm.spatial_mlp_reference(*args), 50,
                               device)
        bwd_ms = cuda_ms(lambda: sm.spatial_mlp_backward_cuda(*args, gy), 50,
                         device)
        bwd_plain_ms = cuda_ms(
            lambda: sm.spatial_mlp_backward_reference(*args, gy), 50, device)
        y_err = scaled_err(sm.spatial_mlp_forward_cuda(*args),
                           sm.spatial_mlp_reference(*args))
    check(y_err <= TOL_MLP_SCALED, f"kernel off by {y_err} at the path's "
          "own decoder inputs")
    emit("rvae_path", patches=list(X.shape), epochs=RVAE_EPOCHS,
         batch=RVAE_BATCH, steps_per_epoch=steps,
         fwd_launches=launches[0], bwd_launches=launches[1],
         elbo_first=hist[0], elbo_last=hist[-1], fit_s=fit_s,
         loop_steps_per_s=RVAE_EPOCHS * steps / (loop_ms / 1e3),
         loop_ms_cuda_events=loop_ms, loop_s_host=loop_s,
         fwd_kernel_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
         bwd_kernel_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
         path_inputs_scaled_err=y_err,
         precision=str(Precision.mixed().compute_dtype))
    source = "atomai_tpu_torch/csrc/spatial_mlp.cu"
    return [{"name": "spatial_mlp_fwd", "route": "cuda", "source": source,
             "replaces": "atomai_tpu/ops/pallas_mlp.py:80",
             "launches": launches[0], "max_abs_err": mlp_errs[0],
             "ms": fwd_ms, "plain_ms": fwd_plain_ms},
            {"name": "spatial_mlp_bwd", "route": "cuda", "source": source,
             "replaces": "atomai_tpu/ops/pallas_mlp.py:94",
             "launches": launches[1], "max_abs_err": mlp_errs[1],
             "ms": bwd_ms, "plain_ms": bwd_plain_ms}]


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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
