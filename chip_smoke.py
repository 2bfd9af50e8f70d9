"""Drives the PyTorch port's paths once on one CUDA card (segmentation
serving, segmentation training with augmentation and peak refinement, rVAE
training, ImSpec training and serving, deep-ensemble training, serving
and atom finding, the GP family: deep kernel learning and sparse-image
reconstruction, the rest of the supervised zoo: the other segmentation
nets, the denoiser, regression and classification, the joint VAEs with
the VAE family's encoding tools, the JAX package's own checkpoints loaded,
resumed, exported and served, the stat layer, lattice-graph analysis
with the labeller's image utilities, training with rematerialisation,
and the device mesh) and checks every step of them.

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
    package's golden fixture;
14. imspec_path: three ``ImSpec.fit`` cycles at config B's width in float32
    (TF32 off) against the JAX run in ``tests/fixtures/``; bench config B
    whole (``ImSpec((64, 64), (16,))``, 300 cycles of batch 32): finite
    losses, the first fit's seconds, a warm run's cycles/s, ``predict`` and
    its milliseconds; the port arm of the ImSpec quality protocol
    (`scripts/measure_imspec_parity.py`), seeds 1, 2 and 5, beside the JAX
    arm's;
15. ensemble_path: ``train_ensemble_from_baseline`` (2 members, 3 cycles,
    float32) against the JAX run in ``tests/fixtures/``; bench config D
    whole (``train_ensemble_from_scratch``, 4 Unets, 30 cycles of batch 8
    with SWA and the full augmentation on 32 x 512 x 512 frames): the first
    and a warm call's seconds and images/s; two ensembles fine-tuned from
    phase 10's trained net for 30 cycles, with config D's augmentation and
    without, and the located atoms of each (and of the net alone) against
    the true ones; ``EnsemblePredictor`` of the one tuned without
    augmentation on the 32 frames, timed on the "map" and "vmap" member
    layouts in turns; ``ensemble_locate`` on its 4 x 32 member maps: the
    labeller's launches, coordinates equal to the plain route's, clusters
    against the true atoms (the gate), the labeller's time at this shape
    beside its plain version and its bound; the native DBSCAN against its
    plain version;
16. gp_fixture: the three GP runs of ``tests/fixtures/torch_port_dklgp.npz``
    in float32 (TF32 off) against the JAX package's: ``dklGPR(64,
    embedim=2)`` with the full-width extractor from numpy-drawn weights (5
    Adam steps: losses, raw GP parameters, ``predict``, ``embed``),
    ``GPTrainer`` 'exact' and 'kissgp', and ``Reconstructor.reconstruct``
    of a 32 x 32 image;
17. dkl_path: bench config E whole (`bench.py:409-429`): ``dklGPR(64,
    embedim=2).fit`` on 10,000 x 64 inputs, 5 cycles (the first fit
    timed), then 20 warm ones by CUDA events: ms a cycle, falling finite
    losses, the card's busy share and largest kernels of a cycle, the
    float32 loss and gradient against float64 after those 25 cycles;
    ``predict`` on the 10,000 training inputs and on 10,000 fresh ones (the
    fresh mean's correlation with their first input), ``thompson`` on
    4,096 candidates (a gate: its float64 draw finite, its index the
    argmax); a 25-cycle fit of 2,048 points whose step is replayed from its
    CUDA graph against the same fit in eager steps (a gate: losses and
    parameters bit for bit); independent outputs (4 x 2,048) and a 5-model
    ``fit_ensemble`` (2,048), ms a cycle each;
18. reconstruct: ``Reconstructor.reconstruct`` of a 256 x 256 sin-cos image
    at 10% measured pixels (the exact path) and at 30% (the inducing grid),
    100 cycles each: seconds, and the mean absolute error against the
    truth within the JAX tests' bars (0.15, 0.2);
19. zoo_fixture: every net of ``tests/fixtures/torch_port_zoo.npz`` at its
    default width (the dilated Unet, dilnet, SegResNet, ResHedNet, the
    denoiser, the regressor on ResNet50, VGG16, MobileNetV2 and the slim
    presets, a MobileNetV2 classifier) from numpy-drawn weights against
    the JAX package's eval outputs, in float32 (TF32 off) and under the
    mixed policy; three SGD cycles of ``Regressor("mobilenet")`` against
    the JAX run;
20. zoo_seg_path: ``Segmentor`` with dilnet, SegResNet, ResHedNet and the
    dilated Unet at their default widths on bench config A's data (300
    cycles of batch 32, the first fit timed, a warm run's cycles/s), then
    ``predict`` on the 64 frames: the labeller's launches (one a
    predict), its labels, fused sums and coordinates equal to the plain
    route's, ``predict`` ms, held-out IoU and atom error gated like
    config A;
21. denoiser_path: the JAX bench's pin, ``DenoisingAutoencoder()`` on 256
    noisy/clean pairs of 64² for 200 cycles of batch 32: warm cycles/s,
    ``predict`` ms, the held-out denoised MSE below the noisy input's;
22. reg_cls_path: ``Regressor("mobilenet")`` (the lattice spacing, 10-20
    px) and ``Classifier("mobilenet", 3)`` (three spacings) on 1,024
    lattice frames of 64², 100 cycles of batch 32: warm cycles/s,
    ``predict`` ms, held-out MSE below the constant predictor's and
    accuracy above 1/3 + 0.2; 20 cycles of the ResNet50 and VGG16
    classifiers;
23. jvae_fixture: one training step (ELBO, every gradient, one Adam step)
    of ``jVAE((32, 32), latent_dim=2, discrete_dim=[4])`` and of the
    ``jrVAE`` of the same arguments at config C's batch of 128, from the
    numpy-drawn params, noise and Gumbel uniforms of
    ``tests/fixtures/torch_port_jvae.npz``, against the JAX package's
    numbers there: both in float32 (TF32 off; the jrVAE's decoder on its
    per-layer route) at the float32 bounds, the jrVAE on the spatial-MLP
    kernels in float32 and under the mixed policy at phase 7's bounds;
24. jvae_path: the JAX bench's jVAE and jrVAE pins on phase 8's 1,024
    patches: ``fit`` for 2 epochs of batch 128, then 20 epochs of the
    bench loop (epoch, metadict, async checkpoint): ELBOs finite and
    rising, steps/s and the card's busy share of an epoch; the jrVAE's
    kernel launches equal to its steps, each kernel's ms at this path's
    shapes beside its plain version and bound; then the trained jrVAE's
    ``encode``, ``reconstruct``, ``manifold2d``, ``manifold_traversal``,
    ``encode_images`` of a 256² lattice frame (50,625 windows) and
    ``encode_trajectories`` on 16 frames of it shifted a pixel a frame,
    the tracks equal to those of the cKDTree route
    (``native.knn_reference``); ``fit(epochs_per_dispatch=5)`` for 10
    epochs against one epoch at a time from the same seed;
25. aoi_fixture: the JAX package's own checkpoints
    (``tests/fixtures/torch_port_unet.aoi``, config A's Unet after five
    cycles with its optax Adam state, and ``torch_port_rvae.aoi``, config
    C's rVAE after one epoch) loaded by ``load_model``: the Unet's forward
    against the JAX numbers of ``torch_port_aoi.npz`` in float32 and under
    the mixed policy, ``resume_training`` from the Adam state against the
    JAX package's resumed losses (the seg-train fixture's bound), the
    rVAE's counters, encoding (float32) and decoding (on the kernel);
26. served_from_jax: the loaded Unet's ``predict`` on config A's 64 x 256²
    frames (one labeller launch, labels, sums and coordinates equal to the
    plain version's), the loaded rVAE's ``manifold2d`` and ``decode`` on
    the spatial-MLP forward kernel against its plain version,
    ``export_model`` of the loaded Unet on the card and on the CPU, both
    artifacts served on the card by ``load_exported`` at batch 1 and 64
    against the live maps, with times;
27. stat_path: phase 10's trained Unet on the 64 x 512² lattice stack ->
    Locator (one labeller launch, exact) -> edge atoms removed ->
    ``stat.imlocal(window_size=32)`` (about 55,000 windows) -> GMM (diag),
    PCA, FastICA, NMF and ``transition_matrix``; ``SpectralUnmixer`` (NMF)
    of a 256 x 256 x 1024 cube made from a seed; ``SlidingFFTNMF`` of a
    2048² lattice frame; each call's seconds and the card's busy share,
    and the same calls of the port on the CPU (on the first windows and
    on corners) against the card's: PCA components and variances, KMeans
    and GMM labels, NMF and ICA reconstruction errors;
28. graph_path: the graph-analysis workflow on a 2048² graphene frame at
    0.104 Å a pixel (about 17,000 atoms, 40 vacancies 12 Å apart) rendered
    by ``create_lattice_mask``: ``find_com`` (one labeller launch, equal
    to the plain version's centres, every atom found within 1 px), then
    ``find_cycles`` and ``find_cycle_clusters(cycles=7..13)``: the native
    rings equal to the plain search's on the whole frame at depth 8 and on
    a crop of about 4,000 atoms at depth 12, one 12-member ring and one
    cluster at each vacancy; ``filter_cells``, ``get_contours`` and
    ``get_blob_params`` on phase 10's trained 64 x 512² maps (the kernel's
    labels equal to the plain labeller's, launches counted, the first
    frames equal to the port's CPU run); ``get_nn_distances``,
    ``map_bonds`` and ``find_coord_clusters`` of the ~55,000 located atoms,
    the ball and pair queries equal to cKDTree's; each call's seconds and
    the card's busy share;
29. remat_path: ``fit(remat=True)`` (each block's activations recomputed
    in the backward, ``nets/remat.py``) against the plain fit from the
    same weights, generators and batch order: config A's Unet for one
    cycle and for 10 (losses, weights and BatchNorm statistics; whether
    they are bit for bit equal with cuDNN's deterministic algorithms and
    without, plain against plain too; then within the stated bounds
    against every plain fit, or the nearest of three plain fits within 3
    times their largest distance from each other), the peak
    memory of one training step both ways at batch 32 and 256 of 256²,
    training steps/s both ways in turns, ``predict`` after the remat fit
    (one labeller launch, exact); config C's rVAE and the jrVAE pin for 3
    epochs (ELBOs against the plain fit's, the spatial-MLP launches: one
    forward and one backward a step, the peak memory of an epoch);
30. mesh_path: the device mesh (``core.mesh``, ``parallel``), in ranks
    started by ``parallel.launch``, each path on explicit meshes: a world
    of two on the one card over gloo at full width (config A's Unet for
    one float32 cycle against the plain one and 10 cycles against three
    plain fits, config C's rVAE for 3 epochs on 64
    rows a rank, config D's 4 members for 10 cycles, config E's 4 x 2,048
    independent outputs, each held against ``mesh=False`` in rank 0; the
    sharded ``SegPredictor`` with one labeller launch a rank and the
    ``EnsemblePredictor``; the dryrun's four paths against one
    process's), every rank ending with rank 0's model, and each rank's
    spatial-MLP kernels held against their plain versions on the inputs
    of its first step; a world of one on NCCL (the sharded predict and
    the rVAE: NCCL and the rank's card start up); the labeller's and the
    spatial-MLP kernels' launches a rank, each path's seconds, the busy
    share of the card during the split config A fit; config D's members
    in the "vmap" layout on the member axis, held like the loop's against
    one process's fits of that layout;
31. ensemble_vmap_path: config D with ``member_layout="vmap"`` (every
    member's step one ``torch.func.vmap`` over the stacked members): one
    float32 cycle against three "map" runs (a priori bounds), 30 bf16
    cycles with the augmentation against three "map" runs (within the
    bounds of each, or the nearest within 3 times their own spread);
    images/s, the peak memory of a fit above the resting allocation and
    the card's busy share, each layout; the members fine-tuned from phase
    10's net in the "vmap" layout, served by ``EnsemblePredictor`` and
    ``ensemble_locate`` (one labeller launch, labels and sums equal to the
    plain labeller's, its time);
32. ensemble_graph: config D's four members (default Unets, seeded) in
    ``EnsemblePredictor``'s CUDA graph at 1 and 3 frames of 512²: every
    call of ``_member_outputs`` (eager first sighting, capture, replays)
    equal to the eager forward bit for bit, and so ``predict`` and
    ``ensemble_forward``; the counters (one eager sighting, one capture,
    then replays); ``reserved`` and the card's allocations flat over 50
    replays; the "vmap" layout's graph against its eager forward the same
    way; and the size sweep behind
    ``GRAPH_MAX_PIXELS``: eager forwards of 1, 2, 4 and 8 frames, the
    host's time issuing a chunk against the card's time running it, and
    the graphed chunk's time;
33. spd_mll: the exact MLL's kernel pair (``ops/spd_mll.py``) at N = 1,
    31, 64, 65, 256, 1,024 and the route's limit, one output and three:
    q, h, dK and dr of the kernels, of the float32 plain version and of
    the library route (cuSOLVER under autograd) against the plain version
    in float64, the kernels within ``SPD_FACTOR`` times the larger
    distance of the two float32 references (dK symmetric bit for bit);
    NaN on the output whose factor fails, as on the library route;
    forwards on two streams at once equal to each alone; a dklGPR fit at
    585 points on the
    kernel route and the same fit with the route forced to the library,
    each one's CUDA graph's replays equal to its eager steps bit for
    bit, the route and launch counters; each kernel's device time at
    N = 256, 585, 1,024 beside its FLOP bound and pivot chain, the plain
    version's, the library route's and ``torch.cholesky_inverse``'s; and
    the sweep behind ``MLL_KERNEL_MAX_N``: both routes' forward and
    backward over N = 64 ... 4,096, at one output and at four;
34. vae_graph: the rVAE fit of the benchmark's ``rvae48.fit`` cell
    (AtomAI's widths on a 2048² frame's 48² atom windows, batch 100): two
    epochs on the graphed route (``viBaseTrainer._graphed``: eager steps,
    the capture, replays) against the same two epochs all eager from the
    same state, permutation and noise, ELBOs and weights within
    ``TOL_VAE_GRAPH`` (bit for bit expected); the step counters; each
    epoch's time on both routes; and the spatial-MLP kernels timed at B =
    100, n = 2,304 beside their roofline bounds;
35. jrvae_graph: the spatial-MLP kernels' residual variant (the skip
    decoder's, a library of its own) against its plain version at
    ``MLP_SHAPES`` and at the ``rvae48.fit`` shapes, within
    ``TOL_MLP_SCALED`` and bit-identical run to run, its launches counted
    by ``spatial_mlp.skip_*_launches``; then the jrVAE fit of the
    benchmark's ``jrvae48.fit`` cell (``jrVAE((48, 48), discrete_dim=[2],
    skip=True)`` on phase 34's windows, batch 100, both capacity
    schedules): two epochs on the graphed route (the draws, uniforms and
    step counts as the graph's inputs) against the same two epochs all
    eager, within ``TOL_VAE_GRAPH`` (bit for bit expected), the step and
    decoder-route counters; and the skip kernels timed at these shapes.
Then one JSON line on the kernels (the spatial-MLP records with their
``jrvae_path``, ``remat_path`` and ``mesh_path`` numbers, the labeller's
and the forward's with the ``served_from_jax`` ones, the labeller's with
the ``stat_path``, ``graph_path``, ``remat_path``, ``mesh_path`` and
``ensemble_vmap_path`` ones; the spatial-MLP records' ``vae_graph``
timings at the rvae48 shapes), and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the script exits
non-zero and prints no result. It imports neither JAX nor ``atomai_tpu``.
"""

import contextlib
import copy
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
# (B, n, H, L) of the spatial MLP phase; the first is config C's. Then
# rvae48.fit's, and two whose 128-row tiles fall unevenly on the SMs, so
# that blocks' runs cross samples: 126 tiles of 18, and 399 of 3
MLP_SHAPES = [(128, 1024, 128, 2), (128, 784, 128, 2), (32, 2560, 128, 2),
              (32, 1024, 256, 2), (16, 1024, 512, 2), (6, 300, 48, 0),
              (5, 333, 64, 3), (300, 64, 32, 1), (100, 2304, 128, 2),
              (7, 2304, 128, 2), (133, 300, 128, 2)]
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

# imspec_path. The fixture: three Adam(1e-3) cycles of config B against
# the JAX run, float32. Conv biases before a BatchNorm get gradients that
# cancel to rounding noise, so Adam moves them by about lr a step either
# way: 2 * lr * steps bounds the weights. flax's running variance takes the
# biased batch variance, torch's the unbiased one (n = 32 x 16 in the
# decoder), and eval mode divides by it: 1e-2 relative on the running
# variances, 5e-3 absolute (1% of the largest output, 0.46) on predict.
# On the CPU: losses within 7.8e-4 relative, predict within 1.7e-3.
TOL_IMSPEC_LOSS_REL = 1e-3
TOL_IMSPEC_ADAM = 2 * 1e-3 * 3
TOL_RUNNING_VAR_REL = 1e-2
TOL_IMSPEC_PREDICT = 5e-3
# bench config B (`bench.py:340-355`) and the ImSpec quality protocol
# (`scripts/measure_imspec_parity.py:10-20`; the JAX arm's medians from
# `scripts/imspec_parity_ours.json`, its worst seed's MSE 0.01813)
IMSPEC_CYCLES, IMSPEC_BATCH = 300, 32
PAIRED_N, PAIRED_IN, PAIRED_OUT, PAIRED_TEST = 512, (16, 16), (32,), 64
PAIRED_CYCLES, PAIRED_BATCH, PAIRED_SEEDS = 1000, 32, (1, 2, 5)
JAX_IMSPEC_MSE, JAX_IMSPEC_CORR = 0.01127, 0.9898
GATE_IMSPEC_MSE, GATE_IMSPEC_CORR = 0.03, 0.9
# ensemble_path. The fixture: 2 members, 3 Adam(1e-3) cycles from one
# baseline, float32, bounded as above (the Unet's bottleneck BatchNorm
# sees n = 4 x 4 x 4: (1 - 0.9^3) / (n - 1) = 4.3e-3 relative).
TOL_ENS_LOSS_REL = 1e-3
TOL_ENS_ADAM = 2 * 1e-3 * 3
# bench config D (`bench.py:357-394`); ensemble_locate's DBSCAN: an atom
# is 3 of the 4 members' detections within 1 px (a sixteenth of the
# lattice spacing)
ENS_DATA = dict(n_images=32, size=512, spacing=16, seed=0)
ENS_CYCLES, ENS_BATCH, ENS_MODELS = 30, 8, 4
ENS_EPS, ENS_MIN_SAMPLES = 1.0, 3
# "map" against "vmap" in float32 (TF32 off): the same function, grouped
# convs and elementwise BatchNorm against plain convs and torch's BatchNorm
ENS_LAYOUT_TOL = 1e-4
# ensemble_graph: the chunks checked against the eager forward, the
# replays over which the card's memory must stay flat, the sweep's chunks
ENS_GRAPH_FRAMES = (1, 3)
ENS_GRAPH_CALLS = 50
ENS_GRAPH_SWEEP = (1, 2, 4, 8)
# phase 33: the exact MLL's kernel pair (ops/spd_mll.py) at the edges of a
# tile (1, 31, 64, 65), dkl64's smallest and largest states (256, 1,024)
# and the route's limit, one output and three. K: an RBF matrix of points
# in [-1, 1]^2 (lengthscale 0.5) plus 0.05 on its diagonal (condition up
# to ~2e4 at N = 1,024), r standard normal, g_q and g_h in [0.5, 1.5).
# Each float32 route's q, h, dK and dr against the plain version in
# float64 on the card (relative: largest difference over largest value).
# The library route and the plain version in float32 are backward-stable
# float32 factorisations, each within about N u kappa of it, and their
# distances from it differ case by case by a few times; a priori the
# kernels lie within SPD_FACTOR times the larger of the two plus SPD_FLOOR
# (a few float32 roundings: h at N = 1 is one log), and so do their gaps
# to the float32 plain version; their gaps to the library route within one
# more of the library's distance.
SPD_SIZES = (1, 31, 64, 65, 256, 1024)
SPD_FACTOR, SPD_FLOOR = 4.0, 2e-6
# timed at dkl64's smallest, middle and largest states; a graphed dklGPR
# fit at the middle one, on each route
SPD_TIMED = (256, 585, 1024)
SPD_GRAPH_N = 585
# the sweep of both routes behind MLL_KERNEL_MAX_N, at one output (a DKL
# fit) and four (independent-output DKL, phase 17's mode)
SPD_SWEEP = (64, 256, 512, 1024, 1536, 2048, 2560, 3072, 4096)
SPD_SWEEP_B = (1, 4)
# forwards queued on each of two streams at once
SPD_CONCURRENT_CALLS = 8
# the forward's chain of pivots: a shuffle, an rsqrt with its Newton step
# and two multiply-adds each, ~70 cycles of the SM clock (1.98 GHz)
SPD_PIVOT_CYCLES, SM_HZ = 70, 1.98e9
# gp_fixture: the JAX runs of `tests/fixtures/torch_port_dklgp.npz`,
# float32 (TF32 off). The DKL run's 590 K extractor weights get gradients
# of rounding size where ReLUs are dead or nearly so, which Adam moves by
# up to lr a step either way: 2 * lr * steps bounds the GP parameters.
# Every other bound is at least 8x what the same run measured on the CPU,
# since cuBLAS and cuSOLVER round differently again: DKL loss 1.2e-5
# relative, mean 6.3e-3, variance 1.2e-4, embedding 3.3e-3; GP losses
# 6.4e-6 relative, predictions 4.2e-6; reconstruction 1.9e-5.
TOL_DKL_LOSS_REL = 1e-3
TOL_DKL_ADAM = 2 * 0.01 * 5
TOL_DKL_MEAN = 5e-2
TOL_DKL_VAR = 1e-3
TOL_DKL_EMBED = 3e-2
TOL_GP_LOSS_REL = 1e-4
TOL_GP_PREDICT = 1e-4
TOL_RECONSTRUCT = 2e-4
# zoo_fixture: the nets of `tests/fixtures/torch_port_zoo.npz` at their
# default widths, each error over the JAX output's largest |value|. In
# float32 (TF32 off) the two packages sum in other orders, and the seeded
# eval-mode nets (random running statistics, He-scaled kernels) amplify
# it through up to 53 layers: 1e-3 (measured on the CPU: at most 8.3e-5,
# MobileNetV2; on the H100 4.9e-5). Under the mixed policy the nets' convs
# run in bf16 (8-bit mantissa; the backbones in float32 with TF32's 10-bit
# one) through up to 53 layers of these amplifying eval-mode nets: 1e-1,
# the scale of the Unet's bf16 bound (2e-2 on outputs of at most 0.11);
# measured on the H100 at most 5.3e-2 (ResHedNet, MobileNet-slim 5.2e-2).
# Three SGD(1e-5) cycles of Regressor("mobilenet"), batch 8 on 64 x 64
# (SGD and its small lr: the fixture script says why). The first train
# loss (the same weights): 1e-3 relative (measured on the CPU 9.3e-5).
# After it, the two runs step with gradients that differ by the JAX
# package's own float32 error: at the fixture's weights its gradient lies
# 2-7% from the float64 one (the port's 0.2-1%), and these gradients are
# large (|g| up to 15), so each step moves the loss by ~0.02 and the later
# losses by a few percent of that. Bounds, with measured CPU values (1 and
# 4 threads) beside them: the later losses 1e-1 relative (train 0.4%,
# test 5.0%); each trained tensor's update (final - initial) against the
# JAX update, over its largest |value|, 3e-1 (15%: the gradient's error,
# and 1e-5-sized updates of BatchNorm scales near 1 that float32 resolves
# to ~9 ulps); running statistics 5e-2 relative (2.0%; includes torch's
# unbiased variance against flax's biased one over n = 8 x 2 x 2 = 32).
TOL_ZOO_F32 = 1e-3
TOL_ZOO_MIXED = 1e-1
TOL_ZOO_FIRST_LOSS_REL = 1e-3
TOL_ZOO_LOSS_REL = 1e-1
TOL_ZOO_STEP_REL = 3e-1
TOL_ZOO_STATS_REL = 5e-2
# zoo_seg_path: each new segmentation net at its default width on bench
# config A (MAIN, SEG_CYCLES of SEG_BATCH), gated as config A (TOL_IOU,
# TOL_MEDIAN_PX on HELD_OUT); a warm run of ZOO_WARM_CYCLES for cycles/s
ZOO_SEG_NETS = (("dilnet", {}), ("SegResNet", {}), ("ResHedNet", {}),
                ("Unet", {"with_dilation": True}))
ZOO_WARM_CYCLES = 50
# the card's busy share of a warm run() of this many cycles (phases 20-22)
BUSY_CYCLES = 10
# denoiser_path: the JAX bench's pin (`bench.py:450-463`): 256 pairs of
# 64 x 64 uniform images and their copies with N(0, 0.3^2) noise, 200
# cycles of batch 32; 32 more pairs held out for the gate
DEN_N, DEN_SIZE, DEN_NOISE, DEN_HELD = 256, 64, 0.3, 32
DEN_CYCLES, DEN_BATCH = 200, 32
# reg_cls_path: MobileNetV2 at full topology on 64 x 64 lattice frames;
# the regressor's target is the spacing (32 values evenly over 10-20 px,
# 32 frames each), the classifier's one of three spacings; 100 cycles of
# batch 32; held-out frames from other seeds; short runs of the ResNet50
# and VGG16 classifiers
RC_SIZE, RC_CYCLES, RC_BATCH, RC_SHORT = 64, 100, 32, 20
RC_SPACINGS = np.linspace(10, 20, 32)
RC_CLASSES = (10, 15, 20)
RC_TRAIN, RC_HELD = 1024, 128
GATE_CLS_ACC = 1 / 3 + 0.2
# dkl_path: bench config E (`bench.py:409-429`), 10,000 x 64 inputs, the
# default extractor and the exact Cholesky GP; 5 cycles that pay the
# first call, then 20 warm ones. The float64 check holds the float32 loss
# and gradient (extractor in float32 too) to the same computation in
# float64 after those 25 cycles: K's condition number is at most
# 1 + N * outputscale / noise (reported), ~1e4 here, so float32 solves
# keep ~1e-3 of their digits at worst; the loss is a sum of N such terms.
GP_N, GP_DIM, GP_FIRST, GP_WARM = 10000, 64, 5, 20
GP_N_SMALL, GP_OUTPUTS, GP_MODELS, GP_CAND = 2048, 4, 5, 4096
TOL_F64_LOSS_REL = 1e-3
TOL_F64_GRAD_REL = 1e-2
# reconstruct: `Reconstructor.reconstruct` of a 256 x 256 sin-cos image
# (the JAX tests' 20 x 20 one, `tests/trainers/test_gptrainer.py:97-106`,
# stretched to this size), 100 cycles, at the JAX tests' error bars
REC_SIZE, REC_CYCLES = 256, 100
REC_CASES = ((0.1, 0.15), (0.3, 0.2))     # (measured share, MAE gate)
# the joint VAEs (the JAX bench's pins, `bench.py:435-449`): one step of
# each against the fixture. In float32 (TF32 off) on cuBLAS the bounds of
# the CPU's rVAE fixture check: config C's weight gradients sum 131,072
# pixel rows, whose float32 summation orders differ by up to ~1.5e-5 of a
# tensor's scale; Adam's first step moves a weight by lr * sign(g), the
# other way for a rounding-size g, hence TOL_ADAM_ABS. On the spatial MLP
# kernels (bf16 operands) and under the mixed policy, phase 7's bounds
# for its kernel route: TOL_ELBO_REL and TOL_GRAD_SCALED.
TOL_JVAE_ELBO_REL = 1e-5
TOL_JVAE_GRAD_SCALED = 3e-5
JVAE_KW = dict(latent_dim=2, discrete_dim=[4])
JVAE_EPD = 5              # epochs a dispatch against one at a time
JVAE_EPD_EPOCHS = 10
TOL_EPD_REL = 1e-6
TRAJ_FRAMES = 16          # encode_trajectories: a 256² frame shifted 1 px
TRAJ_RMAX = 3             # a frame; tracks chained within 3 px

# phases 25-27: the JAX package's own checkpoints, served; the stat layer
AOI_UNET = os.path.join(FIXTURES, "torch_port_unet.aoi")
AOI_RVAE = os.path.join(FIXTURES, "torch_port_rvae.aoi")
AOI_RESUME_CYCLES = 3     # scripts/make_torch_port_fixtures.py's
TOL_AOI_ENCODE = 1e-4     # of scale: the rVAE encoder in float32, TF32 off
TOL_EXPORT_MIXED = 1e-2   # abs, probabilities: the traced bf16 forward
TOL_EXPORT_F32 = 1e-4     # abs, probabilities: a CPU artifact, float32
STAT_WINDOW = 32
STAT_EDGE = 16            # px kept clear of the frame's edge
STAT_CPU_N = 2048         # windows held against the CPU (the first ones)
TOL_STAT_PCA = 1e-3       # abs, unit-norm components (sign-fixed)
TOL_STAT_VAR_REL = 1e-3   # explained variance ratios, relative
STAT_LABEL_SHARE = 0.99   # KMeans / GMM labels equal on the card and CPU
TOL_STAT_REC_REL = 1e-2   # NMF / ICA reconstruction errors, relative
CUBE = (256, 256, 1024)   # SpectralUnmixer's cube (256 MB of float32)
CUBE_CPU = 32             # its 32 x 32 corner held against the CPU
TOL_CUBE_FIT = 5e-2       # the cube's NMF reconstruction error, relative
FFT_FRAME = 2048
FFT_CPU = 256             # the frame's 256² corner held against the CPU
GRAPH_FRAME = 2048        # px: the graphene frame of the graph path
PX2ANG = 0.104            # angstrom a pixel (the graph-analysis notebook's)
CC_BOND_ANG = 1.42        # graphene's C-C bond
GRAPH_VACANCIES = 40
VACANCY_CLEAR_ANG = 12.0  # vacancies this far from each other and the edge
GRAPH_EDGE_PX = 10        # atoms kept this far inside the frame
GRAPH_CROP_PX = 1000      # the crop searched by the plain rings at depth 12
DEFECT_CYCLES = list(range(7, 14))
BLOB_THRESH = 10          # px: filter_cells' and get_blob_params' size cut
GRAPH_CPU_FRAMES = 4      # trained frames held against the port on the CPU
TOL_BLOB_ANGLE = 1e-9     # degrees, modulo 180
NN_RMAX = 3               # px: find_coord_clusters across the 64 frames
# phase 29: fit(remat=True) against the plain fit from the same weights,
# generators and batch order (config A's Unet, config C's rVAE, the jrVAE)
REMAT_CYCLES = 10
REMAT_MEMORY_BATCHES = (32, 256)   # frames of 256² a measured step
REMAT_STEP_REPS = 20               # timed training steps a turn
REMAT_VAE_EPOCHS = 3
TOL_REMAT_LOSS_REL = 1e-3          # the seg-train fixture's loss bound
TOL_REMAT_W = 2 * 1e-3 * REMAT_CYCLES   # 2 * Adam's lr a step
TOL_REMAT_STATS_REL = 1e-2         # running statistics, of their scale
# ... or, where the card's own nondeterminism (the bilinear upsampling's
# backward adds with atomics) moves plain fits further apart, the nearest
# plain fit within this many times the largest distance between two of
# SPREAD_FITS plain fits (``hold_to_spread``). One pair is too few: on an
# H100 the running statistics of two plain 10-cycle fits lay from 1.4e-3
# to 3.5e-2 of scale apart over eight pairs
REMAT_NOISE_FACTOR = 3
SPREAD_FITS = 3
TOL_REMAT_ELBO_REL = 1e-4
# phase 30: the device mesh, in ranks started by parallel.launch. World 2
# with both ranks on the one card (gloo: NCCL refuses two ranks on one
# card) at full width, each path split over the two ranks and held against
# mesh=False fits in rank 0: config A's Unet for one float32 cycle (a
# priori bounds) and 10 cycles (as phase 29: ten Adam steps let the card's
# own nondeterminism show among three plain fits), config C's rVAE for 3
# epochs (24 steps: each kernel launched once a step and rank, on 64
# rows), config D's 4 members for 10 cycles (a
# third of its 30: the member axis computes member for member what one
# process does, so a few cycles hold it as well as many), config E's
# 4 x 2,048 independent outputs for 5 cycles; then the sharded predictors
# and the dryrun's four paths. World 1 on NCCL checks that NCCL and the
# rank's card start up: the sharded predict and the rVAE (a world of one
# splits nothing, so it holds nothing the world of 2 does not).
MESH_SEG_CYCLES = 10
MESH_VAE_EPOCHS = 3
MESH_ENS_CYCLES = 10
MESH_DKL_CYCLES = 5
MESH_LAUNCH_S = 300       # a launch's deadline: a hung rank fails the run
MESH_COLLECTIVE_S = 120   # a collective's: a hung one raises in its rank
# config A's first split step in float32 against the plain step from the
# same weights: the loss and the running statistics reorder float32 sums
# over 2^21 values a channel (measured: the first loss bit for bit), and
# Adam's first step moves a weight by lr either way, whatever its
# gradient's rounding: 2 * lr
TOL_MESH_SEG_STEP = {"first_loss_rel": 1e-5, "stats_rel": 1e-4,
                     "param_abs": 2 * 1e-3}
TOL_MESH_MAPS = 2e-2      # probabilities: bf16 convs of blocks of frames
TOL_MESH_MEMBERS = 1e-5   # the same members' forwards, gathered
TOL_MESH_DKL_REL = 1e-3   # losses: cuBLAS's batched GEMMs of a block
# the dryrun's four paths at world 2 against one process, (first loss,
# every loss), relative. The DKL's extractor runs its GEMMs in TF32 on the
# card (a 10-bit mantissa: 4.9e-4 a rounding), and a rank's batched GEMM
# over its one output is another cuBLAS call than one process's over two:
# the first loss (the same weights) within 1e-3 (measured on an H100:
# 1.9e-4); Adam then moves a weight whose gradient is rounding noise by lr
# (1e-2) either way a step, and the GP's loss follows (3.3e-3 after two
# steps): 1e-2
TOL_MESH_DRYRUN_REL = {"seg_loss": (1e-3, 1e-3), "rvae_loss": (1e-4, 1e-4),
                       "ens_loss": (1e-5, 1e-5), "dkl_loss": (1e-3, 1e-2)}
# phase 31: config D's members in the "vmap" layout against the "map"
# loop, the same members, schedules and draws. One float32 cycle (TF32
# off), a priori: the first losses 1e-5 relative (the same function;
# grouped convs and the elementwise BatchNorm sum in another order: 3e-7
# on the CPU), the weights 2 * lr (Adam's first step moves a weight by lr
# either way, whatever its gradient's rounding), the running statistics
# 1e-4 of their scale (one update from batch statistics summed in another
# order). 30 bf16 cycles with config D's augmentation: the bounds of phase
# 29 (losses 1e-3 relative, weights 2 * lr a step, statistics 1e-2 of
# their scale) against each of three "map" runs, or the nearest within 3
# times their own spread (``hold_to_spread``). Two loop runs differ only
# by the atomics of the upsampling's backward, from the first backward
# on a few values (after one bf16 cycle they are bit for bit equal); the
# vmap layout rounds every conv and BatchNorm in another order from its
# first forward, and on an H100 80GB HBM3 (700 W) landed 2-5 times further
# from the loop than two loop runs lie apart in float32 (10 and 30
# cycles) and 6-25 times in bf16 (10 cycles; scripts/
# ensemble_layout_spread.py), though its float32 and bf16 gradients lie
# as close to a float64 step as the loop's (scripts/
# ensemble_layout_gradients.py: medians 1.14e-4 and 1.32e-4 of scale in
# float32). So two of the three loop runs take
# their batches' frames in two other orders after the augmentation
# (``frames_reordered``): the same function, its sums over the batch in
# another order from the first step, as the vmap layout's are
TOL_ENS_VMAP_F32 = {"loss_rel": 1e-5, "abs": 2 * 1e-3, "stats_rel": 1e-4}
BUSY_CYCLES = 10
TOL_ENS_VMAP_BF16 = {"loss_rel": TOL_REMAT_LOSS_REL,
                     "abs": 2 * 1e-3 * ENS_CYCLES,
                     "stats_rel": TOL_REMAT_STATS_REL}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


# the spatial-MLP kernels' counters (forward, backward)
MLP_LAUNCHES = ("spatial_mlp.forward_launches",
                "spatial_mlp.backward_launches")


MLP_BACKWARD = ("spatial_mlp.backward_launches",
                "spatial_mlp.backward_pipelined_launches")
# every depth at both widths of the pipelined backward (HP 64: L <= 6, HP
# 128: L <= 2), at H below and at HP, and the first depths beyond it
MLP_RANGE_SHAPES = [(3, 200, H, L) for H in (48, 64) for L in range(8)] + \
    [(3, 200, H, L) for H in (112, 128) for L in range(4)]


def takes_pipelined(H, L):
    """Whether the backward at hidden width H and depth L takes the
    pipelined ``bwd_wgmma``: HP (H rounded up to 64) 64 with L <= 6, or
    128 with L <= 2, the shapes the kernel took before its redesign."""
    HP = -(-H // 64) * 64
    return (HP == 64 and L <= 6) or (HP == 128 and L <= 2)


def backward_routes(before):
    """Backward launches since the counters read ``before``
    (``counted(*MLP_BACKWARD)``): all of them, and the pipelined ones."""
    return tuple(b - a for a, b in zip(before, counted(*MLP_BACKWARD)))


def check_pipelined(args, gy):
    """One spatial-MLP backward on ``args``, checked to take the pipelined
    kernel by its counter; returns True."""
    from atomai_tpu_torch.ops import spatial_mlp as sm
    before = counted(*MLP_BACKWARD)
    sm.spatial_mlp_backward_cuda(*args, gy)
    delta = backward_routes(before)
    check(delta == (1, 1), f"spatial_mlp backward on {tuple(args[0].shape)}, "
          f"H {args[2].shape[1]}: launches {delta}, not the pipelined kernel")
    return True


def mlp_steps():
    """The spatial-MLP forward and backward runs since
    :func:`zero_counters`: the counted launches, plus one of each a
    training step replayed from the VAE trainer's CUDA graph (a replay runs
    the captured launches without counting them)."""
    fwd, bwd, replays = counted(*MLP_LAUNCHES, "vae.graph_replay")
    return [fwd + replays, bwd + replays]


def zero_counters():
    """Zeroes the program's counters (``core.profiling``)."""
    from atomai_tpu_torch.core import profiling
    profiling.reset()


def counted(*names):
    """The program's counters ``names`` since :func:`zero_counters`
    (``profiling.summary()["counters"]``): one number, or a tuple."""
    from atomai_tpu_torch.core import profiling
    counters = profiling.summary()["counters"]
    got = tuple(counters.get(n, 0) for n in names)
    return got[0] if len(got) == 1 else got


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


def busy_share(fn, device):
    """The card's busy share during one call of ``fn``: the device time of
    its kernels, copies and fills (a ``torch.profiler`` trace) over its
    wall time (which the profiler lengthens a little)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        busy_us += evt.cuda_time_total if us is None else us
    return busy_us / wall_us


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
    from atomai_tpu_torch.ops import cc_kernel, spatial_mlp, spd_mll

    def timed(build):
        t = time.perf_counter()
        build()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        futures = {name: pool.submit(timed, build) for name, build in
                   (("cc_label", cc_kernel.build),
                    ("spatial_mlp", spatial_mlp.build),
                    ("spatial_mlp_skip",
                     lambda: spatial_mlp.build(skip=True)),
                    ("spd_mll", spd_mll.build))}
        seconds = {name: f.result() for name, f in futures.items()}
    emit("build", seconds=time.perf_counter() - t0, per_source=seconds,
         ptxas=ptxas_report())


def ptxas_report():
    """Registers and spill bytes of each kernel, from the ``-Xptxas -v``
    output of this run's builds."""
    import re
    from atomai_tpu_torch.ops import _build
    report = {}
    for source, log in _build.BUILD_LOG.items():
        # a variant built with macros: its kernels under "name (macros)"
        variant = source.partition(" ")[2]
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
                name += f" ({variant})" if variant else ""
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

    zero_counters()
    nn_output, coords = m.predict(imgs, verbose=False)
    torch.cuda.synchronize(device)
    launches = counted("labeller.launches")

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


def labeller_on(maps, device, timed=True):
    """The Locator's labelling of the (N, H, W, 1) device ``maps`` at 0.5,
    by the kernel and by the plain version: labels, fused sums and the
    Locator's coordinates must agree exactly. With ``timed``, times (CUDA
    events after a warm-up; the kernel by queued device time): the fused
    kernel
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
    if not timed:
        return dict(tiled_mask=list(tiled.shape), blobs=blobs,
                    max_abs_err=max_abs_err)
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


def mlp_kernels_on(args, gy, device):
    """Both spatial-MLP kernels against their plain versions (float32
    without TF32) on ``args`` and ``gy``, checked by error over scale:
    the largest absolute errors of the forward and of the backward, and
    the scaled ones."""
    import torch
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.ops import spatial_mlp as sm
    with Precision.full().scope(device):
        y = sm.spatial_mlp_forward_cuda(*args)
        grads = sm.spatial_mlp_backward_cuda(*args, gy)
        torch.cuda.synchronize(device)
        y_ref = sm.spatial_mlp_reference(*args)
        g_ref = sm.spatial_mlp_backward_reference(*args, gy)
    errs = {"y": scaled_err(y, y_ref)}
    errs.update({name: scaled_err(a, b) for name, a, b in
                 zip(MLP_NAMES, grads, g_ref) if b.numel()})
    worst = max(errs, key=errs.get)
    check(errs[worst] <= TOL_MLP_SCALED, f"spatial_mlp on inputs "
          f"{tuple(args[0].shape)}: {worst} off by {errs[worst]} of its "
          "scale")
    return {"rows": int(args[0].shape[0]), "scaled_err": errs,
            "max_abs_err_fwd": float((y - y_ref).abs().max()),
            "max_abs_err_bwd": max(float((a - b).abs().max()) for a, b in
                                   zip(grads, g_ref) if b.numel())}


def phase_spatial_mlp(device):
    import torch
    from atomai_tpu_torch.ops import spatial_mlp as sm
    rows = []
    for i, (B, n, H, L) in enumerate(MLP_SHAPES):
        args, gy = mlp_inputs(B, n, H, L, i, device)
        before = counted(*MLP_BACKWARD)
        row = mlp_kernels_on(args, gy, device)
        grads = sm.spatial_mlp_backward_cuda(*args, gy)
        again = sm.spatial_mlp_backward_cuda(*args, gy)
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"spatial_mlp {(B, n, H, L)}: two backward runs differ")
        launches, pipelined = backward_routes(before)
        want = launches if takes_pipelined(H, L) else 0
        check(pipelined == want, f"spatial_mlp {(B, n, H, L)}: {pipelined} "
              f"of {launches} backward launches pipelined, {want} expected")
        rows.append({"shape": [B, n, H, L], "scaled_err": row["scaled_err"],
                     "max_abs_err_fwd": row["max_abs_err_fwd"],
                     "max_abs_err_bwd": row["max_abs_err_bwd"],
                     "pipelined": pipelined == launches})
    # the pipelined kernel's whole range of depths, and the staged kernel
    # just beyond it: the route each takes and its errors
    ranged = []
    for i, (B, n, H, L) in enumerate(MLP_RANGE_SHAPES):
        args, gy = mlp_inputs(B, n, H, L, 100 + i, device)
        before = counted(*MLP_BACKWARD)
        row = mlp_kernels_on(args, gy, device)
        launches, pipelined = backward_routes(before)
        check(pipelined == (launches if takes_pipelined(H, L) else 0),
              f"spatial_mlp {(B, n, H, L)}: {pipelined} of {launches} "
              "backward launches pipelined")
        ranged.append({"shape": [B, n, H, L], "pipelined": pipelined == 1,
                       "worst_scaled_err": max(row["scaled_err"].values())})
    emit("spatial_mlp", cases=rows, range_cases=ranged, deterministic=True,
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
    """The spatial MLP's inputs as ``rVAE.forward_compute_elbo`` (or
    ``jrVAE``'s) builds them for the batch ``x`` (its shapes and
    values)."""
    import torch
    from atomai_tpu_torch.core import head_f32
    from atomai_tpu_torch.utils import transform_coordinates
    with torch.no_grad():
        encoded = model.encoder_net(x)
        z_mean = encoded[0]
        xc = transform_coordinates(
            model.x_coord.expand((len(x),) + model.x_coord.shape),
            z_mean[:, 0], (z_mean[:, 1:3] * model.dx_prior)[:, None])
        # a joint model's decoder also takes the discrete latents (here
        # their softmax parameters)
        z = torch.cat([z_mean[:, 3:]] + list(encoded[2:]), 1)
        dec = model.decoder_net
        cl = dec.coord_latent
        hidden = [dec.fc_decoder[2 * i]
                  for i in range(len(dec.fc_decoder) // 2)]
        args = (xc.transpose(1, 2), head_f32(cl.fc_latent, z),
                cl.fc_coord.weight.T, cl.fc_coord.bias[None],
                torch.stack([m.weight.T for m in hidden]),
                torch.stack([m.bias for m in hidden]), dec.out.weight.T,
                dec.out.bias[None])
    return [a.float().contiguous() for a in args]


def mlp_kernel_ms(args, gy, device):
    """Device ms of the forward kernel, its plain version, the backward
    kernel and its plain version on the spatial MLP inputs ``args`` and
    output gradient ``gy``, and the forward kernel's error over scale
    there (checked)."""
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.ops import spatial_mlp as sm
    with Precision.full().scope(device):
        fwd_ms = device_ms(lambda: sm.spatial_mlp_forward_cuda(*args), 50,
                           device)
        fwd_plain_ms = device_ms(lambda: sm.spatial_mlp_reference(*args), 50,
                                 device)
        bwd_ms = device_ms(lambda: sm.spatial_mlp_backward_cuda(*args, gy),
                           50, device)
        bwd_plain_ms = device_ms(
            lambda: sm.spatial_mlp_backward_reference(*args, gy), 50, device)
        y_err = scaled_err(sm.spatial_mlp_forward_cuda(*args),
                           sm.spatial_mlp_reference(*args))
    check(y_err <= TOL_MLP_SCALED, f"kernel off by {y_err} at the path's "
          "own decoder inputs")
    return fwd_ms, fwd_plain_ms, bwd_ms, bwd_plain_ms, y_err


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
        zero_counters()
        t0 = time.perf_counter()
        m.fit(X, training_cycles=RVAE_EPOCHS, batch_size=RVAE_BATCH,
              filename=fname, verbose=False)
        fit_s = time.perf_counter() - t0
        manifold = m.manifold2d()
        torch.cuda.synchronize(device)
        launches = counted(*MLP_LAUNCHES)
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
    fwd_ms, fwd_plain_ms, bwd_ms, bwd_plain_ms, y_err = mlp_kernel_ms(
        args, gy, device)
    pipelined = check_pipelined(args, gy)

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
         path_inputs_scaled_err=y_err, bwd_pipelined=pipelined,
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
             "stock_ms": stock_bwd_ms, "pipelined": pipelined}]


def timed(fn, device):
    """(host seconds, CUDA-event milliseconds) of one call of ``fn``, from
    an idle card to an idle card."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0, start.elapsed_time(end)


def timed_result(fn, device):
    """(host seconds, result) of one call of ``fn``, from an idle card to
    an idle card."""
    import torch
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0, result


def frames_reordered(augment_fn, shift):
    """``augment_fn``'s batch with its frames in reverse order, rolled by
    ``shift``: the same training step, its sums over the batch taken in
    another order."""
    def reordered(g, X, y):
        X, y = augment_fn(g, X, y)
        return X.flip(0).roll(shift, 0), y.flip(0).roll(shift, 0)
    return reordered


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
        run_s, run_ms = timed(m.run, device)
    staged = [list(m.Xb_train.shape), list(m.Xb_test.shape)]
    check(staged == [[1, SEG_BATCH, 256, 256, 1], [1, 10, 256, 256, 1]],
          f"config A staged as {staged}")
    check(len(hist) == SEG_CYCLES and bool(np.isfinite(hist).all()) and
          bool(np.isfinite(test_hist).all()), "non-finite losses")
    check(hist[-1] < hist[0], f"train loss did not fall: {hist[0]} -> "
          f"{hist[-1]}")

    zero_counters()
    maps, coords = m.predict(imgs, verbose=False)
    torch.cuda.synchronize(device)
    launches = counted("labeller.launches")
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
            "locate_ms": lab["locate_ms"], "blobs": lab["blobs"]}, m.net


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


def fixture_script():
    """``scripts/make_torch_port_fixtures.py`` as a module (numpy at import;
    its JAX runs import JAX inside their functions)."""
    import importlib.util
    path = os.path.join(ROOT, "scripts", "make_torch_port_fixtures.py")
    spec = importlib.util.spec_from_file_location("_torch_port_fixtures",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def state_errors(got, want, adam_tol, errs, tols,
                 var_tol=TOL_RUNNING_VAR_REL):
    """Max abs error of each tensor of ``want`` (relative for running
    variances) into ``errs``, with its tolerance into ``tols``."""
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = float((got[k].detach().float().cpu() - w).abs().max())
        if k.endswith("running_var"):
            err /= float(w.abs().max())
            tols[k] = var_tol
        else:
            tols[k] = adam_tol
        errs[k] = err


def failures(errs, tols):
    return {k: [errs[k], tols[k]] for k in errs if not errs[k] <= tols[k]}


def fixture_summary(errs, tols):
    """The losses' errors and the quantity nearest its tolerance."""
    worst = max((k for k in errs if tols[k]), key=lambda k: errs[k] / tols[k])
    return {"checked": len(errs),
            "loss_rel_err": {k: v for k, v in errs.items() if "loss" in k},
            "nearest_tolerance": [worst, errs[worst], tols[worst]]}


def imspec_fixture_run(device, tmp):
    """Config B's ImSpec trained as the fixture's JAX run was (the same
    numpy-drawn variables, data and schedule; float32, TF32 off) on
    ``device``: (model, {name: error}, {name: tolerance})."""
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.models import ImSpec, conversion
    fx = fixture_script()
    stored = dict(np.load(fx.IMSPEC_FIXTURE))
    variables = fx.seeded_variables({k[len("shape/"):]: v for k, v in
                                     stored.items() if k.startswith("shape/")})
    m = ImSpec((64, 64), (16,), latent_dim=2, device=device)
    m.load_jax_variables(unflatten(variables, "params"),
                         unflatten(variables, "batch_stats"))
    m.precision = Precision.full()
    Xb, yb = fx.config_b_data()
    with quiet():
        m.fit(Xb, yb, Xb[:64], yb[:64], training_cycles=fx.IMSPEC_CYCLES,
              batch_size=fx.IMSPEC_BATCH, print_loss=fx.IMSPEC_CYCLES,
              filename=os.path.join(tmp, "imspec"))
    errs = {"schedule": int(np.abs(m.batch_idx_train - stored["schedule"])
                            .max())}
    tols = {"schedule": 0}
    for k in ("train_loss", "test_loss"):
        errs[k] = float(np.max(np.abs(np.asarray(m.loss_acc[k]) / stored[k]
                                      - 1)))
        tols[k] = TOL_IMSPEC_LOSS_REL
    final = unflatten(stored, "final")
    port_name = {"encoder": "encoder.conv", "Dense_0": "decoder.fc",
                 "ConvBlock_0": "decoder.conv", "Conv_0": "decoder.out"}
    want = {}
    for part, name in fx.IMSPEC_FINAL:
        p = final["params"][part][name]
        rank = 4 if part == "encoder" else 3     # 2D images, 1D spectra
        if name.startswith("ConvBlock"):
            s = final["batch_stats"][part][name]
            tensors = conversion._conv_block(p, s, False, name, rank)
        elif name.startswith("Dense"):
            tensors = conversion._dense(p, name)
        else:
            tensors = conversion._conv(p, name, rank)
        prefix = port_name["encoder" if part == "encoder" else name]
        want.update({f"{prefix}.{k}": v for k, v in tensors.items()})
    state_errors(m.net.state_dict(), want, TOL_IMSPEC_ADAM, errs, tols)
    pred = m.predict(Xb[:fx.IMSPEC_PREDICT], verbose=False)
    errs["predict"] = float(np.abs(pred - stored["predict"]).max())
    tols["predict"] = TOL_IMSPEC_PREDICT
    return m, errs, tols


def identity_stats(params):
    """BatchNorm statistics (mean 0, variance 1) for a JAX params tree:
    what a fresh net holds."""
    out = {}
    for k, v in params.items():
        if k.startswith("BatchNorm"):
            out[k] = {"mean": np.zeros_like(v["scale"]),
                      "var": np.ones_like(v["scale"])}
        elif isinstance(v, dict):
            sub = identity_stats(v)
            if sub:
                out[k] = sub
    return out


def ensemble_fixture_run(device, tmp):
    """The fixture's ensemble (2 members fine-tuned for 3 cycles from one
    baseline; float32, TF32 off) trained by the port on ``device``:
    ({name: error}, {name: tolerance}) of the schedules, the losses and
    every member's state."""
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.models import ensemble_from_jax, unet_from_jax
    from atomai_tpu_torch.trainers import EnsembleTrainer
    fx = fixture_script()
    stored = dict(np.load(fx.ENSEMBLE_FIXTURE))
    E = fx.ENSEMBLE
    et = EnsembleTrainer("Unet", 1, nb_filters=E["nb_filters"],
                         layers=E["layers"], device=device)
    et.precision = Precision.full()
    base = unflatten(stored, "base")
    et.compile_ensemble_trainer(batch_size=E["batch"],
                                filename=os.path.join(tmp, "ens"))
    with quiet():
        _, ens = et.train_ensemble_from_baseline(
            stored["x_train"], stored["y_train"], stored["x_test"],
            stored["y_test"], basemodel=unet_from_jax(base,
                                                      identity_stats(base)),
            n_models=E["n_models"], training_cycles_ensemble=E["cycles"])
    errs = {"schedules": int(np.abs(et.member_schedules -
                                    stored["schedules"]).max()),
            "train_loss": float(np.max(np.abs(np.asarray(
                et.loss_acc["train_loss"]) / stored["train_loss"] - 1)))}
    tols = {"schedules": 0, "train_loss": TOL_ENS_LOSS_REL}
    want = ensemble_from_jax(unflatten(stored, "member"), et.meta_state_dict)
    for i, w in want.items():
        e, t = {}, {}
        state_errors(ens[i], w, TOL_ENS_ADAM, e, t)
        errs.update({f"{i}.{k}": v for k, v in e.items()})
        tols.update({f"{i}.{k}": v for k, v in t.items()})
    return errs, tols


def zoo_port_net(name):
    """The port's net of ``ZOO_NETS`` entry ``name`` (in the fixture
    script) and its JAX weight bridge ``(params, batch_stats) ->
    state_dict``."""
    from atomai_tpu_torch import nets
    from atomai_tpu_torch.models import (conversion,
                                         init_denoising_autoencoder)
    kind, kw = fixture_script().ZOO_NETS[name]
    if kind == "seg":
        kw = dict(kw)
        net, meta = nets.init_fcnn_model(kw.pop("model"), 1, **kw)
        bridge = conversion.fcnn_from_jax
    elif kind == "denoiser":
        net, meta = init_denoising_autoencoder()
        bridge = conversion.denoiser_from_jax
    else:
        net, meta = (nets.init_reg_model(1, kw["backbone"]) if kind == "reg"
                     else nets.init_cls_model(kw["nb_classes"],
                                              kw["backbone"]))
        bridge = conversion.reg_cls_from_jax
    return net, lambda p, s: bridge(p, s, meta)


def zoo_variables(stored, name, fresh_stats=False):
    """The numpy-drawn variables of net ``name`` of the zoo fixture; with
    ``fresh_stats``, a fresh net's BatchNorm statistics."""
    fx = fixture_script()
    prefix = f"shape/{name}/"
    v = fx.seeded_variables({k[len(prefix):]: a for k, a in stored.items()
                             if k.startswith(prefix)},
                            kernel_gain=fx.ZOO_GAIN)
    if fresh_stats:
        v = fx.with_identity_stats(v)
    return unflatten(v, "params"), unflatten(v, "batch_stats")


def zoo_fixture_run(device, tmp, policies):
    """Every net of the zoo fixture on ``device`` under each of
    ``policies`` ({label: (Precision, tolerance)}), and the fixture's
    three Regressor("mobilenet") cycles in float32 (TF32 off): ({name:
    error}, {name: tolerance}). A forward's error is its largest absolute
    difference over the JAX output's largest absolute value."""
    import torch
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.models import Regressor, conversion
    fx = fixture_script()
    stored = dict(np.load(fx.ZOO_FIXTURE))
    x = torch.from_numpy(stored["x"]).permute(0, 3, 1, 2).to(device)
    errs, tols = {}, {}
    for name, (kind, _) in fx.ZOO_NETS.items():
        net, bridge = zoo_port_net(name)
        net.load_state_dict(bridge(*zoo_variables(stored, name)))
        net.to(device).eval()
        want = stored[f"y/{name}"]
        for label, (policy, tol) in policies.items():
            with torch.inference_mode(), policy.scope(device):
                y = net(x).float()
            if y.ndim == 4:
                y = y.permute(0, 2, 3, 1)
            errs[f"{name}/{label}"] = float(
                np.abs(y.cpu().numpy() - want).max() / np.abs(want).max())
            tols[f"{name}/{label}"] = tol
    X, y = fx.zoo_reg_data()
    t, R = fx.ZOO_REG["n_test"], fx.ZOO_REG
    m = Regressor("mobilenet", 1, device=device)
    m.load_jax_variables(*zoo_variables(stored, "reg_mobilenet",
                                        fresh_stats=True))
    m.precision = Precision.full()
    with quiet():
        m.fit(X[:-t], y[:-t], X[-t:], y[-t:], training_cycles=R["cycles"],
              batch_size=R["batch"], print_loss=R["cycles"],
              optimizer="sgd", lr_scheduler=[R["lr"]],
              filename=os.path.join(tmp, "reg"))
    errs["reg/schedule"] = int(np.abs(m.batch_idx_train -
                                      stored["reg_schedule"]).max())
    tols["reg/schedule"] = 0
    for k in ("train_loss", "test_loss"):
        rel = np.abs(np.asarray(m.loss_acc[k]) / stored[f"reg_{k}"] - 1)
        errs[f"reg/{k}"], tols[f"reg/{k}"] = float(rel.max()), \
            TOL_ZOO_LOSS_REL
        if k == "train_loss":
            errs["reg/first_train_loss"] = float(rel[0])
            tols["reg/first_train_loss"] = TOL_ZOO_FIRST_LOSS_REL
    final = unflatten(stored, "reg_final")
    init_p, init_s = zoo_variables(stored, "reg_mobilenet", fresh_stats=True)
    names = {path: (key, kind) for key, path, kind in
             conversion.BACKBONE_NAMES["mobilenet"]()}
    got = m.net.state_dict()
    for path in fx.ZOO_REG_FINAL:
        flat = "/".join(path)
        trees = []
        for p, s in ((final["params"], final.get("batch_stats", {})),
                     (init_p, init_s)):
            for part in path:
                p, s = p[part], s.get(part, {})
            trees.append((p, s))
        if path == ("Dense_0",):
            prefix, convert = "output_layer", (
                lambda p, s: conversion._dense(p, flat))
        else:
            key, kind = names[path[2:]]
            prefix = f"backbone.features.{key}"
            convert = (lambda p, s: conversion._conv(p, flat)) \
                if kind == "conv" else (lambda p, s: conversion._batch_norm(
                    p, s, len(p["scale"]), flat))
        (want, start) = (convert(*t) for t in trees)
        for k, w in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            g = got[f"{prefix}.{k}"].detach().float().cpu()
            if k.startswith("running"):
                err = float((g - w).abs().max() / w.abs().max())
                tol = TOL_ZOO_STATS_REL
            else:
                # the SGD update, against the JAX one
                step = w - start[k]
                err = float(((g - start[k]) - step).abs().max()
                            / step.abs().max())
                tol = TOL_ZOO_STEP_REL
            errs[f"reg/{prefix}.{k}"], tols[f"reg/{prefix}.{k}"] = err, tol
    return errs, tols


def make_paired_data(n=PAIRED_N, seed=0):
    """The ImSpec protocol's (image, spectrum) pairs: a copy of
    `scripts/measure_imspec_parity.py` ``make_paired_data`` (a CPU test
    holds the two equal)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:PAIRED_IN[0], :PAIRED_IN[1]]
    e = np.linspace(0, 1, PAIRED_OUT[0])
    pos = rng.uniform(4, 12, size=(n, 2))
    width = rng.uniform(1.2, 3.0, size=n)
    imgs = np.exp(-((yy - pos[:, 0, None, None]) ** 2 +
                    (xx - pos[:, 1, None, None]) ** 2) /
                  (2 * width[:, None, None] ** 2))
    imgs += 0.05 * rng.randn(*imgs.shape)
    centers = pos[:, 1] / PAIRED_IN[1]
    widths = width / 20.0
    spectra = np.exp(-0.5 * ((e[None] - centers[:, None]) /
                             widths[:, None]) ** 2)
    spectra += 0.02 * rng.randn(*spectra.shape)
    return imgs.astype(np.float32), spectra.astype(np.float32)


def imspec_score(pred, true):
    """The protocol's held-out MSE and peak-position correlation (a copy
    of the script's ``score``)."""
    mse = float(np.mean((np.asarray(pred) - true) ** 2))
    corr = float(np.corrcoef(np.asarray(pred).argmax(-1),
                             true.argmax(-1))[0, 1])
    return mse, corr


def phase_imspec_path(device):
    import torch
    from atomai_tpu_torch.models import ImSpec
    with tempfile.TemporaryDirectory() as tmp:
        _, fx_errs, fx_tols = imspec_fixture_run(device, tmp)
    bad = failures(fx_errs, fx_tols)
    check(not bad, f"ImSpec fixture: {bad}")

    # bench config B whole
    rng = np.random.RandomState(0)
    Xb = rng.rand(512, 64, 64).astype(np.float32)
    yb = rng.rand(512, 16).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp, quiet():
        m = ImSpec((64, 64), (16,), latent_dim=2, device=device)
        fit_s, _ = timed(lambda: m.fit(
            Xb, yb, Xb[:64], yb[:64], training_cycles=IMSPEC_CYCLES,
            batch_size=IMSPEC_BATCH, print_loss=IMSPEC_CYCLES,
            filename=os.path.join(tmp, "imspec")), device)
        hist = list(m.loss_acc["train_loss"]) + list(m.loss_acc["test_loss"])
        m._reset_training_history()
        run_s, run_ms = timed(m.run, device)
    check(len(hist) == 2 * IMSPEC_CYCLES and bool(np.isfinite(hist).all()),
          "non-finite or missing config B losses")
    pred = m.predict(Xb, verbose=False)
    check(pred.shape == (512, 16) and bool(np.isfinite(pred).all()),
          f"bad config B predict output {pred.shape}")
    with quiet():
        predict_ms = cuda_ms(lambda: m.predict(Xb, verbose=False), 5, device)

    # the ImSpec quality protocol's port arm
    X, y = make_paired_data()
    split = len(X) - PAIRED_TEST
    mses, corrs = [], []
    with tempfile.TemporaryDirectory() as tmp, quiet():
        for seed in PAIRED_SEEDS:
            q = ImSpec(PAIRED_IN, PAIRED_OUT, latent_dim=10, seed=seed,
                       device=device)
            q.fit(X[:split], y[:split], X[split:], y[split:],
                  training_cycles=PAIRED_CYCLES, batch_size=PAIRED_BATCH,
                  print_loss=PAIRED_CYCLES, filename=os.path.join(tmp, "q"))
            mse, corr = imspec_score(q.predict(X[split:], verbose=False),
                                     y[split:])
            mses.append(mse)
            corrs.append(corr)
    mse_median, corr_median = float(np.median(mses)), float(np.median(corrs))
    check(mse_median < GATE_IMSPEC_MSE and corr_median > GATE_IMSPEC_CORR,
          f"ImSpec protocol: median MSE {mse_median}, correlation "
          f"{corr_median}")
    emit("imspec_path", fixture=fixture_summary(fx_errs, fx_tols),
         data=[list(Xb.shape), list(yb.shape)], cycles=IMSPEC_CYCLES,
         batch=IMSPEC_BATCH, loss_first=hist[0],
         loss_last=hist[IMSPEC_CYCLES - 1], test_loss_last=hist[-1],
         fit_s=fit_s, run_s_host=run_s, run_ms_cuda_events=run_ms,
         cycles_per_s=IMSPEC_CYCLES / (run_ms / 1e3), predict_ms=predict_ms,
         protocol={"seeds": list(PAIRED_SEEDS), "mse": mses, "corr": corrs,
                   "mse_median": mse_median, "corr_median": corr_median,
                   "jax_arm_mse_median": JAX_IMSPEC_MSE,
                   "jax_arm_corr_median": JAX_IMSPEC_CORR,
                   "gate": {"mse": GATE_IMSPEC_MSE,
                            "corr": GATE_IMSPEC_CORR}},
         precision=str(m.precision.compute_dtype))


def phase_ensemble_path(device, basenet):
    """``basenet``: phase 10's trained Unet, the serving ensemble's
    baseline."""
    import torch
    from scipy.spatial import cKDTree
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.native import dbscan, dbscan_reference
    from atomai_tpu_torch.predictors import (EnsemblePredictor, Locator,
                                             SegPredictor, ensemble_locate)
    from atomai_tpu_torch.trainers import EnsembleTrainer
    from atomai_tpu_torch.transforms import seg_augmentor
    from atomai_tpu_torch.utils import make_lattice_stack
    with tempfile.TemporaryDirectory() as tmp:
        fx_errs, fx_tols = ensemble_fixture_run(device, tmp)
    bad = failures(fx_errs, fx_tols)
    check(not bad, f"ensemble fixture: {bad}")

    # bench config D whole: the first call, then a warm one
    imgs, masks, true_xy = make_lattice_stack(**ENS_DATA)
    n, size = ENS_DATA["n_images"], ENS_DATA["size"]
    aug = seg_augmentor(1, **AUG)
    train_s, fine_s, served, hist = [], {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp, quiet():
        et = EnsembleTrainer("Unet", 1, device=device)
        et.compile_ensemble_trainer(training_cycles=ENS_CYCLES,
                                    batch_size=ENS_BATCH, swa=True,
                                    filename=os.path.join(tmp, "ens"))
        for _ in range(2):
            train_s.append(timed(lambda: et.train_ensemble_from_scratch(
                imgs, masks, n_models=ENS_MODELS, augment_fn=aug),
                device)[0])
        hist["scratch"] = et.loss_acc["train_loss"][-ENS_CYCLES:]
        # ensembles to serve, fine-tuned from phase 10's trained net as
        # config D trains (with its augmentation) and without augmentation
        for name, fn in (("augmented", aug), ("plain", None)):
            fine_s[name] = timed(lambda: et.train_ensemble_from_baseline(
                imgs, masks, basemodel=basenet, n_models=ENS_MODELS,
                training_cycles_ensemble=ENS_CYCLES, augment_fn=fn),
                device)[0]
            served[name] = (copy.deepcopy(et.net), et.ensemble_state_dict)
            hist[name] = et.loss_acc["train_loss"][-ENS_CYCLES:]

    def quality(coord_means):
        """Median distance of the cluster means (or atoms) to the true
        atoms, and their count against the true atoms that the Locator's
        5 px edge margin keeps."""
        errs, found, interior = [], 0, 0
        for i in range(n):
            true = true_xy[i] + MASK_OFFSET
            interior += int(((true >= 5) & (true < size - 5)).all(1).sum())
            found += len(coord_means[i])
            if len(coord_means[i]):
                errs.append(cKDTree(true).query(coord_means[i][:, :2])[0])
        errs = np.concatenate(errs) if errs else np.zeros(0)
        return {"median_err_px": float(np.median(errs)) if len(errs)
                else float("inf"), "found": found, "interior_atoms": interior,
                "ratio": found / max(interior, 1)}

    def member_maps(predictor):
        """(members, frames, H, W, 1) maps on the card."""
        return torch.from_numpy(predictor.ensemble_forward(
            predictor.preprocess(imgs), num_batches=n)).to(device)

    qualities = {"baseline_net": quality(Locator(0.5).run(SegPredictor(
        basenet, nb_classes=1, verbose=False).predict_device(imgs)))}
    aug_pred = EnsemblePredictor(*served["augmented"], nb_classes=1,
                                 verbose=0)
    qualities["augmented"] = quality(ensemble_locate(
        member_maps(aug_pred), eps=ENS_EPS, min_samples=ENS_MIN_SAMPLES)[0])

    # EnsemblePredictor of the plain-tuned ensemble on the 32 frames, each
    # layout
    net, ens = served["plain"]
    preds = {layout: EnsemblePredictor(net, ens, nb_classes=1,
                                       member_layout=layout, verbose=0)
             for layout in ("map", "vmap")}
    out = {layout: p.predict(imgs) for layout, p in preds.items()}
    mean, var = out["map"]
    # under the bf16 policy the layouts round differently (reported); in
    # float32 they must agree (the gate), on 4 frames
    bf16_diff = max(float(np.abs(a - b).max()) for a, b in
                    zip(out["map"], out["vmap"]))
    f32 = {}
    for layout, p in preds.items():
        policy, p.precision = p.precision, Precision.full()
        f32[layout] = p.predict(imgs[:4])
        p.precision = policy
    layout_diff = max(float(np.abs(a - b).max()) for a, b in
                      zip(f32["map"], f32["vmap"]))
    x = preds["map"].preprocess(imgs)
    ms = {"predict": {"map": [], "vmap": []},
          "device_batches": {"map": [], "vmap": []}}
    for layout in ("map", "vmap", "vmap", "map"):
        p = preds[layout]
        ms["predict"][layout].append(cuda_ms(lambda: p.predict(imgs), 3,
                                             device))
        ms["device_batches"][layout].append(cuda_ms(
            lambda: p.ensemble_batch_predict(x), 3, device))

    # ensemble_locate on every member's maps: one Locator run of 4 x 32
    maps = member_maps(preds["map"])
    zero_counters()
    c_mean, _ = ensemble_locate(maps, eps=ENS_EPS,
                                min_samples=ENS_MIN_SAMPLES)
    torch.cuda.synchronize(device)
    launches = counted("labeller.launches")
    qualities["plain"] = quality(c_mean)
    flat = maps.reshape((-1,) + tuple(maps.shape[2:]))
    lab = labeller_on(flat, device)     # kernel == plain route, and times
    locate_ms = cuda_ms(lambda: ensemble_locate(
        maps, eps=ENS_EPS, min_samples=ENS_MIN_SAMPLES), 3, device)
    # DBSCAN native against plain on each frame's member coordinates
    coords = Locator(0.5).run(flat)
    dbscan_equal = all(np.array_equal(
        dbscan(pts, ENS_EPS, ENS_MIN_SAMPLES),
        dbscan_reference(pts, ENS_EPS, ENS_MIN_SAMPLES)) for pts in (
            np.concatenate([coords[m * n + i][:, :2]
                            for m in range(ENS_MODELS)]) for i in range(n)))
    emit("ensemble_path", fixture=fixture_summary(fx_errs, fx_tols),
         frames=list(imgs.shape), members=ENS_MODELS, cycles=ENS_CYCLES,
         batch=ENS_BATCH, train_s=train_s,
         images_per_s=[ENS_CYCLES * ENS_BATCH * ENS_MODELS / t
                       for t in train_s],
         fine_tune_s=fine_s,
         loss_first_last={k: [v[0], v[-1]] for k, v in hist.items()},
         predictor_ms=ms, layouts_max_diff_f32=layout_diff,
         layouts_max_diff_bf16=bf16_diff,
         member_maps=list(maps.shape), launches=launches,
         locate_ms=locate_ms, labeller=lab, eps=ENS_EPS,
         min_samples=ENS_MIN_SAMPLES, quality=qualities,
         dbscan_equal=dbscan_equal,
         precision=str(et.precision.compute_dtype))
    check(bool(np.isfinite(sum(hist.values(), [])).all()),
          "non-finite ensemble losses")
    check(len(ens) == ENS_MODELS, f"{len(ens)} members")
    check(mean.shape == var.shape == (n, size, size, 1),
          f"predictor shapes {mean.shape}, {var.shape}")
    check(bool(np.isfinite(mean).all() and np.isfinite(var).all()),
          "non-finite predictor output")
    check(0 <= mean.min() and mean.max() <= 1 and 0 <= var.min() and
          var.max() <= 1, "predictor mean or variance out of [0, 1]")
    check(layout_diff <= ENS_LAYOUT_TOL, f"'map' and 'vmap' differ by "
          f"{layout_diff}")
    check(launches > 0, "ensemble_locate never launched the labeller")
    check(dbscan_equal, "native DBSCAN differs from its plain version")
    q = qualities["plain"]
    check(q["median_err_px"] < TOL_MEDIAN_PX,
          f"ensemble_locate median error {q['median_err_px']}")
    check(0.9 <= q["ratio"] <= 1.1, f"ensemble_locate found {q['found']} "
          f"clusters for {q['interior_atoms']} atoms")
    return {"launches": launches, "ms": lab["kernel_ms"],
            "plain_ms": lab["kernel_plain_ms"], "bound_ms": lab["bound_ms"],
            "bound_by": lab["bound_by"],
            "share_of_bound": lab["share_of_bound"],
            "max_abs_err": lab["max_abs_err"], "blobs": lab["blobs"],
            "tiled_mask": lab["tiled_mask"], "locate_ms": locate_ms}


def dklgp_fixture_run(device):
    """The fixture's three GP runs (`scripts/make_torch_port_fixtures.py`
    ``make_dklgp_fixture``) by the port on ``device`` from the same
    numpy-drawn weights and data, float32 with TF32 off: ({name: error},
    {name: tolerance})."""
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.models import Reconstructor, dklGPR
    from atomai_tpu_torch.trainers import GPTrainer
    fx = fixture_script()
    stored = dict(np.load(fx.DKLGP_FIXTURE))
    errs, tols = {}, {}

    def err(name, got, tol, rel=False):
        d = np.asarray(got, np.float64) - stored[name]
        errs[name] = float(np.max(np.abs(d / stored[name] if rel else d)))
        tols[name] = tol

    D = fx.DKL
    X, y, Xp = fx.dkl_fixture_data()
    with quiet():
        m = dklGPR(D["indim"], embedim=D["embedim"], device=device)
        m.precision = Precision.full()
        m.compile_trainer(X, y, training_cycles=D["cycles"], lr=D["lr"])
        m.load_jax_params(fx.dkl_fe_params(), fx.dkl_gp_init())
        m.fit(X, y, D["cycles"], print_loss=D["cycles"])
        mean, var = m.predict(Xp)
        err("dkl_loss", m.train_loss, TOL_DKL_LOSS_REL, rel=True)
        for k, v in m.gp_params.items():
            err(f"dkl_gp/{k}", v.detach().cpu().numpy(), TOL_DKL_ADAM)
        err("dkl_mean", mean, TOL_DKL_MEAN)
        err("dkl_var", var, TOL_DKL_VAR)
        err("dkl_embed", m.embed(Xp), TOL_DKL_EMBED)
        X2, y2, Xp2 = fx.gp2d_data()
        for kind, kw in (("exact", {}), ("kissgp", {
                "grid_points_ratio": fx.GP2D["grid_points_ratio"]})):
            t = GPTrainer(device=device)
            t.run(X2, y2, fx.GP2D["cycles"], print_loss=fx.GP2D["cycles"],
                  kernel_type=kind, **kw)
            mean, var = t.predict(Xp2)
            err(f"gp_{kind}_loss", t.train_loss, TOL_GP_LOSS_REL, rel=True)
            err(f"gp_{kind}_mean", mean, TOL_GP_PREDICT)
            err(f"gp_{kind}_var", var, TOL_GP_PREDICT)
        err("reconstruct", Reconstructor(device=device).reconstruct(
            fx.reconstruct_image(), training_cycles=fx.RECONSTRUCT["cycles"],
            print_loss=fx.RECONSTRUCT["cycles"]), TOL_RECONSTRUCT)
    return errs, tols


def phase_gp_fixture(device):
    errs, tols = dklgp_fixture_run(device)
    bad = failures(errs, tols)
    check(not bad, f"GP fixture: {bad}")
    emit("gp_fixture", errors=errs, tolerances=tols)


def dkl_loss_grad(model, dtype):
    """(loss, flat gradient over the GP parameters and the extractor's) of
    a DKL model's training loss, computed by the trainer's own two-stage
    backward on copies of its parameters and data in ``dtype``, float32
    policy (TF32 off)."""
    import torch
    from atomai_tpu_torch.core import Precision
    c = copy.copy(model)
    c.fe = copy.deepcopy(model.fe).to(dtype)
    for p in c.fe.parameters():
        p.grad = None
    c.gp_params = {k: v.detach().to(dtype).requires_grad_()
                   for k, v in model.gp_params.items()}
    c.X, c.y = model.X.to(dtype), model.y.to(dtype)
    c.precision = Precision.full()
    loss = c._loss_backward()
    params = [*c.gp_params.values(), *c.fe.parameters()]
    return (loss.item(), torch.cat([p.grad.reshape(-1) for p in params])
            .double(), sum(p.numel() for p in c.gp_params.values()))


def graphed_fit_is_eager(X, y, device, cycles=GP_FIRST + GP_WARM):
    """Whether a dklGPR fit whose step is replayed from its CUDA graph
    gives the losses and parameters of the same fit in eager steps, bit
    for bit."""
    import torch
    from atomai_tpu_torch.models import dklGPR
    from atomai_tpu_torch.trainers import gptrainer
    fits = []
    for warmup in (gptrainer.GRAPH_WARMUP, cycles):
        saved, gptrainer.GRAPH_WARMUP = gptrainer.GRAPH_WARMUP, warmup
        try:
            m = dklGPR(X.shape[1], embedim=2, device=device, seed=1)
            with quiet():
                m.fit(X, y, training_cycles=cycles, print_loss=GP_FIRST)
        finally:
            gptrainer.GRAPH_WARMUP = saved
        fits.append((m.train_loss, torch.cat(
            [p.detach().reshape(-1) for p in m._trainable()])))
    (la, pa), (lb, pb) = fits
    return la == lb and torch.equal(pa, pb)


def float64_check(model):
    """The float32 loss and gradient against float64, with K's condition
    number bound, 1 + N * outputscale / noise."""
    import torch
    from atomai_tpu_torch.trainers.gptrainer import _hyp
    l32, g32, n_gp = dkl_loss_grad(model, torch.float32)
    l64, g64, _ = dkl_loss_grad(model, torch.float64)
    _, os_, noise, _ = _hyp({k: v.detach() for k, v in
                             model.gp_params.items()})

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    out = {"loss_32": l32, "loss_64": l64,
           "loss_rel_err": abs(l32 - l64) / abs(l64),
           "grad_rel_err": rel(g32, g64),
           "gp_grad_rel_err": rel(g32[:n_gp], g64[:n_gp]),
           "fe_grad_rel_err": rel(g32[n_gp:], g64[n_gp:]),
           "cond_bound": float(torch.max(
               1 + model.X.shape[0] * os_ / noise)),
           "gate": {"loss_rel": TOL_F64_LOSS_REL,
                    "grad_rel": TOL_F64_GRAD_REL}}
    check(out["loss_rel_err"] <= TOL_F64_LOSS_REL
          and out["grad_rel_err"] <= TOL_F64_GRAD_REL,
          f"float32 against float64: {out}")
    return out


def losses_ok(model, n):
    losses = np.asarray(model.train_loss)
    return (len(losses) == n and bool(np.isfinite(losses).all())
            and losses[-1] < losses[0])


def phase_dkl_path(device, n=GP_N, n_small=GP_N_SMALL, n_cand=GP_CAND):
    """Bench config E whole, then the independent-output and ensemble
    modes at ``n_small`` points."""
    import warnings
    from atomai_tpu_torch.models import dklGPR
    rng = np.random.RandomState(0)
    Xg = rng.randn(n, GP_DIM).astype(np.float32)
    yg = (Xg[:, 0] + 0.1 * rng.randn(n)).astype(np.float32)
    gp = dklGPR(GP_DIM, embedim=2, device=device)
    with quiet():
        fit_s, _ = timed(lambda: gp.fit(Xg, yg, training_cycles=GP_FIRST,
                                        print_loss=GP_FIRST), device)
        gp.training_cycles = GP_WARM
        warm_s, warm_ms = timed(lambda: gp.run(print_loss=GP_FIRST), device)
    check(losses_ok(gp, GP_FIRST + GP_WARM),
          f"config E losses: {gp.train_loss}")
    loss_first, loss_last = gp.train_loss[0], gp.train_loss[-1]
    f64 = float64_check(gp)
    ms_cycle = warm_ms / GP_WARM
    with quiet():
        gp.training_cycles = 1
        split = device_split(lambda: gp.run(print_loss=1), device, reps=3)
    busy = sum(split.values()) / 1e3 / ms_cycle

    first_predict_s, _ = timed(lambda: gp.predict(Xg), device)
    predict_train_ms = cuda_ms(lambda: gp.predict(Xg), 3, device)
    Xf = rng.randn(n, GP_DIM).astype(np.float32)
    predict_fresh_ms = cuda_ms(lambda: gp.predict(Xf), 3, device)
    mean, var = gp.predict(Xf)
    check(mean.shape == (n,) and var.shape == (n,)
          and bool(np.isfinite(mean).all()) and bool((var > 0).all()),
          "bad config E predict output")
    corr = float(np.corrcoef(mean, Xf[:, 0])[0, 1])
    Xc = Xf[:n_cand]
    thompson_ms = cuda_ms(lambda: gp.thompson(Xc), 3, device)
    sample, idx = gp.thompson(Xc)
    check(sample.shape == (1, n_cand) and 0 <= int(idx[0]) < n_cand,
          f"bad thompson output {sample.shape} {idx}")
    check(bool(np.isfinite(sample).all()) and int(idx[0]) ==
          int(np.argmax(sample)), f"thompson draw over {n_cand} candidates "
          f"not finite or its index not its argmax: {idx}")

    # independent outputs and an ensemble, at n_small points
    Xs, ys = Xg[:n_small], yg[:n_small]
    graph_equal = graphed_fit_is_eager(Xs, ys, device)
    check(graph_equal, "a fit whose step is replayed from its CUDA graph "
          "differs from the same fit's eager steps")
    Ys = np.stack([ys, -ys, Xs[:, 1], Xs[:, 0] + Xs[:, 1]])[:GP_OUTPUTS]
    modes = {}
    for name, shared in (("independent", False), ("ensemble", True)):
        mm = dklGPR(GP_DIM, embedim=2, shared_embedding_space=shared,
                    device=device)
        with quiet(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if name == "independent":
                first_s, _ = timed(lambda: mm.fit(
                    Xs, Ys, training_cycles=GP_FIRST, print_loss=GP_FIRST),
                    device)
            else:
                first_s, _ = timed(lambda: mm.fit_ensemble(
                    Xs, ys, training_cycles=GP_FIRST, n_models=GP_MODELS,
                    print_loss=GP_FIRST), device)
            _, ms = timed(lambda: mm.run(print_loss=GP_FIRST), device)
            check(losses_ok(mm, 2 * GP_FIRST),
                  f"{name} DKL losses: {mm.train_loss}")
            losses = mm.train_loss[0], mm.train_loss[-1]
            mm.training_cycles = 1
            busy_us = sum(device_split(lambda: mm.run(print_loss=1), device,
                                       reps=3).values())
        b = GP_OUTPUTS if name == "independent" else GP_MODELS
        m_, v_ = mm.predict(Xs[:256])
        check(m_.shape == (b, 256) and bool(np.isfinite(m_).all()),
              f"{name} DKL predict: {m_.shape}")
        modes[name] = {"n": n_small, "members": b, "first_fit_s": first_s,
                       "ms_per_cycle": ms / GP_FIRST,
                       "device_busy_share": busy_us / 1e3 / (ms / GP_FIRST),
                       "loss_first": losses[0], "loss_last": losses[1]}
    emit("dkl_path", data=[list(Xg.shape), list(yg.shape)],
         first_fit_s=fit_s, first_cycles=GP_FIRST, warm_cycles=GP_WARM,
         warm_s_host=warm_s, ms_per_cycle=ms_cycle,
         cycles_per_s=1e3 / ms_cycle, loss_first=loss_first,
         loss_last=loss_last, float64_check=f64,
         device_busy_share=busy,
         top_kernels_us=dict(list(split.items())[:8]),
         first_predict_s=first_predict_s,
         predict_train_ms=predict_train_ms,
         predict_fresh_ms=predict_fresh_ms,
         fresh_mean_corr_x0=corr, thompson_ms=thompson_ms,
         thompson_candidates=n_cand, thompson_idx=int(idx[0]),
         thompson_finite=bool(np.isfinite(sample).all()),
         graphed_fit_equal=graph_equal, modes=modes)


def sparse_test_image(size, share, seed=0):
    """(sparse image, truth): ``share`` of the pixels of a sin-cos image
    measured, the others 0."""
    yy, xx = np.mgrid[:size, :size]
    s = 3.0 * size / 20
    true = (np.sin(yy / s) * np.cos(xx / s)).astype(np.float32)
    idx = np.random.RandomState(seed).choice(
        size * size, int(round(share * size * size)), replace=False)
    img = np.zeros(size * size, np.float32)
    img[idx] = true.ravel()[idx]
    return img.reshape(size, size), true


def phase_reconstruct(device, size=REC_SIZE, cycles=REC_CYCLES):
    from atomai_tpu_torch.models import Reconstructor
    cases = []
    for share, gate in REC_CASES:
        img, true = sparse_test_image(size, share)
        rec = Reconstructor(device=device)
        run = {}
        with quiet():
            secs, _ = timed(lambda: run.update(out=rec.reconstruct(
                img, training_cycles=cycles, print_loss=cycles)), device)
        out = run["out"]
        mae = float(np.abs(out - true).mean())
        check(out.shape == true.shape and bool(np.isfinite(out).all())
              and mae < gate, f"reconstruct at {share}: MAE {mae}")
        cases.append({"measured_share": share,
                      "points": int(np.count_nonzero(img)),
                      "kernel_type": rec.kernel_type,
                      "inducing_points": (0 if rec.inducing_points is None
                                          else len(rec.inducing_points)),
                      "seconds": secs, "mae": mae, "gate": gate,
                      "loss_first": rec.train_loss[0],
                      "loss_last": rec.train_loss[-1]})
    emit("reconstruct", size=size, cycles=cycles, cases=cases)


def phase_zoo_fixture(device):
    from atomai_tpu_torch.core import Precision, default_precision
    with tempfile.TemporaryDirectory() as tmp:
        errs, tols = zoo_fixture_run(device, tmp, {
            "f32": (Precision.full(), TOL_ZOO_F32),
            "mixed": (default_precision(device), TOL_ZOO_MIXED)})
    bad = failures(errs, tols)
    emit("zoo_fixture", nets={k: errs[k] for k in errs
                              if not k.startswith("reg/")},
         **fixture_summary(errs, tols), failures=bad)
    check(not bad, f"zoo fixture off: {bad}")


def phase_zoo_seg_path(device):
    import torch
    from atomai_tpu_torch import models
    from atomai_tpu_torch.predictors import SegPredictor
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, masks, _ = make_lattice_stack(**MAIN)
    h_imgs, h_masks, h_xy = make_lattice_stack(**HELD_OUT)
    results = {}
    for model, kw in ZOO_SEG_NETS:
        name = model + ("_dilated" if kw else "")
        with tempfile.TemporaryDirectory() as tmp, quiet():
            m = models.Segmentor(model, 1, seed=1, device=device, **kw)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            m.fit(imgs, masks, training_cycles=SEG_CYCLES,
                  batch_size=SEG_BATCH, print_loss=SEG_CYCLES,
                  filename=os.path.join(tmp, "seg"))
            torch.cuda.synchronize(device)
            fit_s = time.perf_counter() - t0
            hist = list(m.loss_acc["train_loss"])
            check(bool(np.isfinite(hist).all()) and hist[-1] < hist[0],
                  f"{name}: train loss {hist[0]} -> {hist[-1]}")

            zero_counters()
            maps, coords = m.predict(imgs, verbose=False)
            torch.cuda.synchronize(device)
            launches = counted("labeller.launches")
            check(launches > 0, f"{name}: predict never launched the "
                  "labeller")
            check(maps.shape == (64, 256, 256, 1) and len(coords) == 64,
                  f"{name}: bad predict output")
            lab = labeller_on(SegPredictor(m.net, nb_classes=1,
                                           verbose=False)
                              .predict_device(imgs), device, timed=False)
            predict_ms = cuda_ms(lambda: m.predict(imgs, verbose=False), 3,
                                 device)
            prob = m.predict(h_imgs, compute_coords=False, verbose=False)
            iou = mean_jaccard(prob[..., 0], h_masks)
            _, h_coords = m.predict(h_imgs, verbose=False)
            median = float(np.median(atom_errors(h_coords, h_xy,
                                                 MASK_OFFSET)))
            # the warm production loop: ZOO_WARM_CYCLES more of run(),
            # then BUSY_CYCLES more under the profiler
            m.training_cycles = ZOO_WARM_CYCLES
            m._reset_training_history()
            _, run_ms = timed(m.run, device)
            m.training_cycles = BUSY_CYCLES
            busy = busy_share(m.run, device)
        results[name] = dict(
            nb_filters=m.meta_state_dict["nb_filters"],
            layers=m.meta_state_dict["layers"], loss_first=hist[0],
            loss_last=hist[-1], fit_s=fit_s,
            warm_cycles_per_s=ZOO_WARM_CYCLES / (run_ms / 1e3),
            busy_share=busy, predict_ms=predict_ms, launches=launches,
            labeller_max_abs_err=lab["max_abs_err"], blobs=lab["blobs"],
            atoms=int(sum(len(c) for c in coords.values())),
            held_out_iou=iou, held_out_median_err_px=median)
    emit("zoo_seg_path", frames=list(imgs.shape), cycles=SEG_CYCLES,
         batch=SEG_BATCH, nets=results,
         gates={"iou": TOL_IOU, "median_err_px": TOL_MEDIAN_PX})
    for name, r in results.items():
        check(r["held_out_iou"] >= TOL_IOU,
              f"{name}: held-out IoU {r['held_out_iou']}")
        check(r["held_out_median_err_px"] < TOL_MEDIAN_PX,
              f"{name}: held-out median atom error "
              f"{r['held_out_median_err_px']} px")
    return {name: r["launches"] for name, r in results.items()}


def phase_denoiser_path(device):
    import torch
    from atomai_tpu_torch.models import DenoisingAutoencoder
    rng = np.random.RandomState(0)
    clean = rng.rand(DEN_N + DEN_HELD, DEN_SIZE, DEN_SIZE).astype(np.float32)
    noisy = clean + DEN_NOISE * rng.randn(*clean.shape).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp, quiet():
        m = DenoisingAutoencoder(device=device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        m.fit(noisy[:DEN_N], clean[:DEN_N], training_cycles=DEN_CYCLES,
              batch_size=DEN_BATCH, print_loss=DEN_CYCLES,
              filename=os.path.join(tmp, "den"))
        torch.cuda.synchronize(device)
        fit_s = time.perf_counter() - t0
        hist = list(m.loss_acc["train_loss"])
        out = m.predict(noisy[DEN_N:])
        predict_ms = cuda_ms(lambda: m.predict(noisy[DEN_N:]), 5, device)
        # the bench's loop: another DEN_CYCLES of run()
        m._reset_training_history()
        _, run_ms = timed(m.run, device)
        m.training_cycles = BUSY_CYCLES
        busy = busy_share(m.run, device)
    mse_out = float(np.mean((out - clean[DEN_N:]) ** 2))
    mse_in = float(np.mean((noisy[DEN_N:] - clean[DEN_N:]) ** 2))
    emit("denoiser_path", pairs=[DEN_N, DEN_SIZE, DEN_SIZE],
         cycles=DEN_CYCLES, batch=DEN_BATCH, loss_first=hist[0],
         loss_last=hist[-1], fit_s=fit_s,
         warm_cycles_per_s=DEN_CYCLES / (run_ms / 1e3), busy_share=busy,
         predict_ms=predict_ms, predict_frames=DEN_HELD,
         held_out_mse_denoised=mse_out, held_out_mse_noisy=mse_in)
    check(out.shape == (DEN_HELD, DEN_SIZE, DEN_SIZE) and
          bool(np.isfinite(out).all()), "bad denoiser output")
    check(mse_out < mse_in, f"denoised MSE {mse_out} not below the noisy "
          f"input's {mse_in}")


def spacing_frames(spacings, per_spacing, seed):
    """``per_spacing`` lattice frames of RC_SIZE for each spacing (each
    group min-max normalised by the generator), shuffled: (images,
    spacing of each)."""
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs = np.concatenate([
        make_lattice_stack(n_images=per_spacing, size=RC_SIZE,
                           spacing=float(sp), seed=seed + i)[0]
        for i, sp in enumerate(spacings)])
    target = np.repeat(np.asarray(spacings, np.float32), per_spacing)
    perm = np.random.RandomState(seed).permutation(len(imgs))
    return imgs[perm], target[perm]


def fit_timed(m, device, X, y, cycles, tmp):
    """Fits ``m`` for ``cycles`` of RC_BATCH: (first fit's seconds, the
    train losses)."""
    import torch
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with quiet():
        m.fit(X, y, training_cycles=cycles, batch_size=RC_BATCH,
              print_loss=cycles, filename=os.path.join(tmp, "rc"))
    torch.cuda.synchronize(device)
    hist = list(m.loss_acc["train_loss"])
    check(bool(np.isfinite(hist).all()), "non-finite losses")
    return time.perf_counter() - t0, hist


def phase_reg_cls_path(device):
    from atomai_tpu_torch.models import Classifier, Regressor
    n_sp = RC_TRAIN // len(RC_SPACINGS)
    X, y = spacing_frames(RC_SPACINGS, n_sp, seed=0)
    Xh, yh = spacing_frames(RC_SPACINGS, RC_HELD // len(RC_SPACINGS),
                            seed=1000)
    Xc, yc = spacing_frames(RC_CLASSES, RC_TRAIN // len(RC_CLASSES), seed=0)
    Xch, ych = spacing_frames(RC_CLASSES, RC_HELD // len(RC_CLASSES),
                              seed=1000)
    label = {sp: i for i, sp in enumerate(RC_CLASSES)}
    yc, ych = (np.asarray([label[int(v)] for v in a]) for a in (yc, ych))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, make, data, held in (
                ("regressor", lambda: Regressor("mobilenet", 1,
                                                device=device), (X, y),
                 (Xh, yh)),
                ("classifier", lambda: Classifier("mobilenet", 3,
                                                  device=device), (Xc, yc),
                 (Xch, ych))):
            m = make()
            fit_s, hist = fit_timed(m, device, *data, RC_CYCLES, tmp)
            pred = m.predict(held[0], verbose=False)
            if kind == "regressor":
                score = {"held_out_mse": float(np.mean((pred - held[1]) ** 2)),
                         "constant_mse": float(np.mean(
                             (held[1] - data[1].mean()) ** 2))}
            else:
                score = {"held_out_accuracy": float(np.mean(
                    pred == held[1]))}
            predict_ms = cuda_ms(lambda: m.predict(held[0], verbose=False),
                                 5, device)
            m.training_cycles = RC_CYCLES
            m._reset_training_history()
            with quiet():
                _, run_ms = timed(m.run, device)
                m.training_cycles = BUSY_CYCLES
                busy = busy_share(m.run, device)
            out[kind] = dict(fit_s=fit_s, loss_first=hist[0],
                             loss_last=hist[-1], predict_ms=predict_ms,
                             predict_frames=len(held[0]),
                             warm_cycles_per_s=RC_CYCLES / (run_ms / 1e3),
                             busy_share=busy, **score)
        for backbone in ("resnet", "vgg"):
            m = Classifier(backbone, 3, device=device)
            fit_s, hist = fit_timed(m, device, Xc, yc, RC_SHORT, tmp)
            out[f"classifier_{backbone}"] = dict(
                fit_s=fit_s, cycles=RC_SHORT, loss_first=hist[0],
                loss_last=hist[-1])
    emit("reg_cls_path", frames=[RC_TRAIN, RC_SIZE, RC_SIZE],
         held_out=RC_HELD, cycles=RC_CYCLES, batch=RC_BATCH, **out,
         gates={"classifier_accuracy": GATE_CLS_ACC})
    r = out["regressor"]
    check(r["held_out_mse"] < r["constant_mse"], f"regressor held-out MSE "
          f"{r['held_out_mse']} not below the constant's {r['constant_mse']}")
    acc = out["classifier"]["held_out_accuracy"]
    check(acc > GATE_CLS_ACC, f"classifier held-out accuracy {acc}")


def jvae_fixture_step(device, name, precision, stock=False):
    """One training step of the fixture's ``name`` ("jvae" or "jrvae") on
    ``device`` under ``precision``, from its seeded params and noise (the
    jrVAE's decoder on its per-layer route when ``stock``): (ELBO error
    relative, {param: gradient error over scale}, Adam's largest absolute
    error)."""
    import torch
    from atomai_tpu_torch import models
    fx = fixture_script()
    stored = dict(np.load(fx.JVAE_FIXTURE))
    shapes = {k[len(f"shape/{name}/"):]: v for k, v in stored.items()
              if k.startswith(f"shape/{name}/")}
    params = unflatten(fx.seeded_variables(shapes, fx.JVAE_SEEDS[name]),
                       "params")
    m = getattr(models, fx.JVAE_MODELS[name])((32, 32), device=device,
                                              **JVAE_KW)
    m.load_jax_params(params)
    if m.coord:
        m.dx_prior = 0.1
        m.kdict_["phi_prior"] = 0.1
    m.precision = precision
    x = fx.jvae_batch()
    m.compile_trainer((x, None), training_cycles=1, batch_size=len(x))
    x = torch.from_numpy(x).to(device)
    eps = torch.from_numpy(stored[f"{name}/eps"]).to(device)
    u = torch.from_numpy(stored[f"{name}/u"]).to(device)
    route = stock_decoder(m) if stock else contextlib.nullcontext()
    m.optimizer.zero_grad()
    with route, precision.tf32_scope():
        with precision.scope(device):
            elbo = m.forward_compute_elbo(x, None, fx.JVAE_NUM_ITER,
                                          eps=eps, u=[u])
        (-elbo).backward()
    want = float(stored[f"{name}/elbo"])
    elbo_err = abs(float(elbo.detach()) - want) / abs(want)

    def as_flat(pair):
        return {f"{part}.{k}": v for part, tree in zip(("encoder", "decoder"),
                                                       pair)
                for k, v in tree.items()}

    flat = flat_params(m)
    grads = as_flat(models.vae_from_jax(unflatten(stored, f"{name}_grads"),
                                        m.metadict))
    grad_errs = {k: scaled_err(-flat[k].grad.cpu(), g)
                 for k, g in grads.items()}
    m.optimizer.step()
    adam = as_flat(models.vae_from_jax(unflatten(stored, f"{name}_adam"),
                                       m.metadict))
    adam_err = max(float((flat[k].detach().cpu() - a).abs().max())
                   for k, a in adam.items())
    return elbo_err, grad_errs, adam_err


def jvae_fixture_run(device, cases):
    """The fixture's steps ``cases`` {label: (model, Precision, stock,
    ELBO tolerance, gradient tolerance, Adam tolerance)} on ``device``:
    ({label: {"elbo_rel", "grad_scaled", "worst_grad", "adam_abs"}},
    failures)."""
    out, bad = {}, {}
    for label, (name, precision, stock, tol_elbo, tol_grad,
                tol_adam) in cases.items():
        elbo_err, grad_errs, adam_err = jvae_fixture_step(
            device, name, precision, stock)
        worst = max(grad_errs, key=grad_errs.get)
        out[label] = {"elbo_rel": elbo_err, "grad_scaled": grad_errs[worst],
                      "worst_grad": worst, "adam_abs": adam_err,
                      "tolerances": [tol_elbo, tol_grad, tol_adam]}
        for what, err, tol in (("elbo", elbo_err, tol_elbo),
                               ("grad", grad_errs[worst], tol_grad),
                               ("adam", adam_err, tol_adam)):
            if not err <= tol:
                bad[f"{label}/{what}"] = [err, tol]
    return out, bad


def jvae_card_cases(device):
    """Phase 23's steps: both models in float32 (TF32 off) at the float32
    bounds (the jrVAE's decoder on its per-layer route), then the jrVAE on
    its spatial-MLP kernels in float32 and under the card's mixed policy,
    at phase 7's bounds for the kernel route."""
    from atomai_tpu_torch.core import Precision, default_precision
    f32 = Precision.full()
    tight = (TOL_JVAE_ELBO_REL, TOL_JVAE_GRAD_SCALED, TOL_ADAM_ABS)
    bf16 = (TOL_ELBO_REL, TOL_GRAD_SCALED, TOL_ADAM_ABS)
    return {"jvae_f32": ("jvae", f32, False) + tight,
            "jrvae_f32_stock": ("jrvae", f32, True) + tight,
            "jrvae_f32_kernels": ("jrvae", f32, False) + bf16,
            "jrvae_mixed_kernels": ("jrvae", default_precision(device),
                                    False) + bf16}


def phase_jvae_fixture(device):
    zero_counters()
    cases, bad = jvae_fixture_run(device, jvae_card_cases(device))
    emit("jvae_fixture", cases=cases, failures=bad,
         kernel_launches=list(counted(*MLP_LAUNCHES)))
    check(not bad, f"joint VAE fixture off: {bad}")
    check(counted(*MLP_LAUNCHES) == (2, 2),
          "the jrVAE's kernel steps did not launch the kernels once each")


def lattice_track_stack(frames, size=256, spacing=16, seed=0):
    """One lattice frame shifted one pixel to the right a frame, and its
    atoms {frame: (n, 3) [row, col, 0]}."""
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, _, xy = make_lattice_stack(n_images=1, size=size, spacing=spacing,
                                     seed=seed)
    stack = np.stack([np.roll(imgs[0], t, axis=1) for t in range(frames)])
    atoms = {t: np.concatenate([xy[0] + [0, t], np.zeros((len(xy[0]), 1))],
                               -1) for t in range(frames)}
    return stack, atoms


def joint_path_run(m, X, fname, device):
    """``fit(2 epochs)`` then the bench loop (``loop_rate``) of a joint
    model: its numbers; the ELBOs checked finite and rising."""
    import torch
    steps = len(X) // RVAE_BATCH
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    m.fit(X, training_cycles=2, batch_size=RVAE_BATCH, filename=fname,
          verbose=False)
    torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    hist = list(m.loss_history["train_loss"])
    rate, loop_ms, loop_s, elbo_last = loop_rate(m, fname, steps, device)
    check(bool(np.isfinite(hist + [elbo_last]).all()),
          "non-finite epoch ELBOs")
    check(elbo_last > hist[0], f"ELBO did not rise: {hist[0]} -> "
          f"{elbo_last}")
    return {"fit_s": fit_s, "elbo_fit": hist, "elbo_loop_last": elbo_last,
            "loop_steps_per_s": rate, "loop_ms_cuda_events": loop_ms,
            "loop_s_host": loop_s, "steps": (2 + RVAE_EPOCHS) * steps}


def phase_jvae_path(device, mlp_errs):
    import torch
    from atomai_tpu_torch import native
    from atomai_tpu_torch.models import jrVAE, jVAE
    from atomai_tpu_torch.ops import roofline
    from atomai_tpu_torch.ops import spatial_mlp as sm
    from atomai_tpu_torch.utils import coords
    X = config_c_patches()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        jv = jVAE((32, 32), device=device, **JVAE_KW)
        out["jvae"] = joint_path_run(jv, X, os.path.join(tmp, "jv"), device)
        out["jvae"]["busy_share"] = busy_share(jv.train_epoch_lazy, device)
        m = jrVAE((32, 32), device=device, **JVAE_KW)
        check(m.decoder_net.fused(), "the jrVAE's decoder does not route to "
              "the kernels")
        zero_counters()
        out["jrvae"] = joint_path_run(m, X, os.path.join(tmp, "jrv"), device)
        launches = tuple(mlp_steps())
        steps = out["jrvae"]["steps"]
        check(launches == (steps, steps), f"the jrVAE's {steps} steps "
              f"ran the kernels {launches} times")
        out["jrvae"]["busy_share"] = busy_share(m.train_epoch_lazy, device)

    # the kernels at this path's shapes (the decoder's 2 + 4 latents)
    x = torch.from_numpy(X[:RVAE_BATCH]).to(device)
    args = decoder_args(m, x, device)
    gy = torch.randn((RVAE_BATCH, 1, X.shape[1] * X.shape[2]),
                     generator=torch.Generator(device).manual_seed(0),
                     device=device) * 1e-2
    fwd_ms, fwd_plain_ms, bwd_ms, bwd_plain_ms, y_err = mlp_kernel_ms(
        args, gy, device)
    dims = (RVAE_BATCH, X.shape[1] * X.shape[2], args[2].shape[1],
            args[4].shape[0])
    bounds = [roofline.bound(f, b) for f, b in
              zip(sm.spatial_mlp_flops(*dims), sm.spatial_mlp_bytes(*dims))]

    # serving the trained jrVAE
    with quiet():
        z_mean, z_logsd, alphas = m.encode(X[:256])
        rec = m.reconstruct(X[:4], num_samples=8)
        manifold = m.manifold2d()
        traversal = m.manifold_traversal(0, d=10)
    check(z_mean.shape == z_logsd.shape == (256, 5) and
          alphas.shape == (256, 4) and
          bool(np.allclose(alphas.sum(1), 1, atol=1e-5)), "bad encode")
    check(rec.shape == (32, 32, 32) and bool(np.isfinite(rec).all()),
          "bad reconstruct")
    check(manifold.shape == (9 * 32, 9 * 32) and
          bool(np.isfinite(manifold).all()), "bad manifold2d")
    check(traversal.shape == (4 * 34, 10 * 34 + 2) and
          float(traversal.min()) >= 0 and float(traversal.max()) <= 1,
          "bad manifold_traversal")
    frames, atoms = lattice_track_stack(TRAJ_FRAMES)

    def encode_images():
        with quiet():
            return m.encode_images(frames[0])

    def encode_trajectories():
        return m.encode_trajectories(frames, atoms, 32, 0, TRAJ_RMAX)

    # each timed warm (host clock, to an idle card), after the call whose
    # output is checked
    _, encoded = encode_images()
    images_ms = timed(encode_images, device)[0] * 1e3
    n_win = 256 - 32 + 1
    check(encoded.shape == (1, n_win, n_win, 5) and
          bool(np.isfinite(encoded).all()), f"bad encode_images output "
          f"{encoded.shape}")
    traj = encode_trajectories()
    traj_ms = timed(encode_trajectories, device)[0] * 1e3
    knn = coords.knn
    coords.knn = native.knn_reference
    try:
        traj_ref = encode_trajectories()
    finally:
        coords.knn = knn
    same = (len(traj[0]) == len(traj_ref[0]) and all(
        np.array_equal(a[:, :2], b[:, :2]) and np.allclose(a, b, rtol=1e-6)
        and np.array_equal(fa, fb) for a, b, fa, fb in
        zip(traj[0], traj_ref[0], traj[1], traj_ref[1])))
    full = sum(len(f) == TRAJ_FRAMES for f in traj[1])
    check(same, "encode_trajectories differs from the cKDTree route")
    check(full > 100, f"only {full} tracks run through all frames")

    # fit(epochs_per_dispatch) against one epoch at a time, same seed
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for epd in (JVAE_EPD, 1):
            r = jrVAE((32, 32), device=device, **JVAE_KW)
            r.fit(X, training_cycles=JVAE_EPD_EPOCHS, batch_size=RVAE_BATCH,
                  epochs_per_dispatch=epd, verbose=False,
                  filename=os.path.join(tmp, f"epd{epd}"))
            runs.append((np.asarray(r.loss_history["train_loss"]),
                         r.num_iter))
    epd_err = float(np.abs(runs[0][0] / runs[1][0] - 1).max())
    check(epd_err <= TOL_EPD_REL and runs[0][1] == runs[1][1],
          f"epochs_per_dispatch history off by {epd_err}, num_iter "
          f"{runs[0][1]} vs {runs[1][1]}")

    emit("jvae_path", patches=list(X.shape), batch=RVAE_BATCH,
         models=out, fwd_launches=launches[0], bwd_launches=launches[1],
         fwd_kernel_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
         bwd_kernel_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
         fwd_bound_ms=bounds[0][0], bwd_bound_ms=bounds[1][0],
         path_inputs_scaled_err=y_err,
         encode_images_ms=images_ms, encode_images_windows=n_win ** 2,
         encode_trajectories_ms=traj_ms,
         tracks=len(traj[0]), tracks_through_all_frames=full,
         trajectories_equal_reference=same,
         epochs_per_dispatch={"epd": JVAE_EPD, "epochs": JVAE_EPD_EPOCHS,
                              "max_rel_diff": epd_err,
                              "num_iter": [runs[0][1], runs[1][1]]})
    return [{"launches": launches[i], "max_abs_err": mlp_errs[i],
             "ms": (fwd_ms, bwd_ms)[i],
             "plain_ms": (fwd_plain_ms, bwd_plain_ms)[i],
             "bound_ms": bounds[i][0], "bound_by": bounds[i][1],
             "share_of_bound": bounds[i][0] / (fwd_ms, bwd_ms)[i]}
            for i in range(2)]


def timed_load(path, device):
    """``load_model`` of ``path`` on ``device``: the model and its
    seconds."""
    import torch
    from atomai_tpu_torch import load_model
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda d: None)
    sync(device)
    t0 = time.perf_counter()
    m = load_model(path, device=device)
    sync(device)
    return m, time.perf_counter() - t0


def aoi_fixture_run(device):
    """The JAX package's own .aoi files on ``device``: forwards, encodings
    and decodings against its numbers, and resume_training of its Adam
    state against its resumed losses (checked); the fields to report."""
    import torch
    from atomai_tpu_torch.core import Precision
    fx = dict(np.load(os.path.join(FIXTURES, "torch_port_aoi.npz")))
    st = dict(np.load(os.path.join(FIXTURES, "torch_port_seg_train.npz")))
    x = np.load(os.path.join(FIXTURES, "torch_port_unet_fwd.npz"))["x"]
    m, unet_load_s = timed_load(AOI_UNET, device)
    errs = {}
    for label, policy, tol in [("f32", Precision.full(), TOL_UNET_F32),
                               ("mixed", m.precision, TOL_UNET_BF16)]:
        m_policy, m.precision = m.precision, policy
        with torch.no_grad():
            y = m.forward(torch.from_numpy(x).to(device)).cpu().numpy()
        m.precision = m_policy
        errs[label] = float(np.abs(y - fx["unet/y"]).max())
        check(errs[label] <= tol, f"loaded Unet {label} off by "
              f"{errs[label]} (tolerance {tol})")
    m.precision = Precision.full()
    with tempfile.TemporaryDirectory() as tmp, quiet():
        m.compile_trainer((st["x_train"], st["y_train"], st["x_test"],
                           st["y_test"]), training_cycles=AOI_RESUME_CYCLES,
                          batch_size=4, print_loss=AOI_RESUME_CYCLES,
                          filename=os.path.join(tmp, "resume"))
        m.resume_training(AOI_UNET, additional_cycles=AOI_RESUME_CYCLES)
    check(np.array_equal(m.batch_idx_train, fx["unet/resume_schedule"]),
          "resumed batch schedule differs from the JAX package's")
    loss_err = {k: [float(v) for v in np.abs(
        np.asarray(m.loss_acc[k]) / fx[f"unet/resume_{k}"] - 1)]
        for k in ("train_loss", "test_loss")}
    check(loss_err["train_loss"][0] <= TOL_SEG_LOSS_REL,
          f"first resumed loss off by {loss_err['train_loss'][0]}")
    worst = max(max(v) for v in loss_err.values())
    check(worst <= TOL_SEG_LOSS_REL, f"resumed losses off by {worst}")
    check(m.num_steps == 5 + AOI_RESUME_CYCLES, f"{m.num_steps} steps")

    v, rvae_load_s = timed_load(AOI_RVAE, device)
    check(v.num_iter == 8 and (device.type != "cuda" or
                               v.decoder_net.fused()),
          f"loaded rVAE: num_iter {v.num_iter}, fused {v.decoder_net.fused()}")
    v.precision = Precision.full()     # the encoder in float32, TF32 off
    z_mean, z_logsd = v.encode(fx["rvae/x"])
    enc_err = max(scaled_err(torch.from_numpy(z_mean),
                             torch.from_numpy(fx["rvae/z_mean"])),
                  scaled_err(torch.from_numpy(z_logsd),
                             torch.from_numpy(fx["rvae/z_logsd"])))
    check(enc_err <= TOL_AOI_ENCODE, f"encode off by {enc_err} of scale")
    dec_err = {k: scaled_err(torch.from_numpy(np.asarray(got, np.float32)),
                             torch.from_numpy(fx[f"rvae/{k}"]))
               for k, got in (("decoded", v.decode(fx["rvae/z"])),
                              ("manifold", v.manifold2d(d=4)))}
    for k, e in dec_err.items():
        check(e <= TOL_MLP_SCALED, f"{k} off by {e} of scale (the bf16 "
              "kernel's bound)")
    return dict(unet_load_s=unet_load_s, rvae_load_s=rvae_load_s,
                unet_fwd_max_abs_err=errs,
                resume_train_loss=m.loss_acc["train_loss"],
                resume_train_loss_ref=fx["unet/resume_train_loss"].tolist(),
                resume_rel_err=loss_err, rvae_num_iter=v.num_iter,
                rvae_encode_scaled_err=enc_err,
                rvae_decode_scaled_err=dec_err,
                tolerances={"f32": TOL_UNET_F32, "mixed": TOL_UNET_BF16,
                            "loss_rel": TOL_SEG_LOSS_REL,
                            "encode": TOL_AOI_ENCODE,
                            "decode": TOL_MLP_SCALED})


def phase_aoi_fixture(device):
    emit("aoi_fixture", **aoi_fixture_run(device))


def phase_served_from_jax(device):
    """The JAX-written Unet and rVAE served on the card: predict -> Locator
    (one labeller launch, exact), the rVAE's decode and manifold on the
    spatial-MLP forward kernel against its plain version, and the Unet
    exported (on the card and on the CPU) and served at batch 1 and 64."""
    import torch
    from atomai_tpu_torch import export_model, load_exported, load_model
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.nets import ed
    from atomai_tpu_torch.ops import spatial_mlp as sm
    from atomai_tpu_torch.predictors import SegPredictor
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, _, _ = make_lattice_stack(**MAIN)
    m = load_model(AOI_UNET, device=device)
    m.predict(imgs, verbose=False)          # warm-up
    zero_counters()
    maps, coords = m.predict(imgs, verbose=False)
    torch.cuda.synchronize(device)
    launches = counted("labeller.launches")
    check(launches == 1, f"predict launched the labeller {launches} times")
    n, size = MAIN["n_images"], MAIN["size"]
    check(maps.shape == (n, size, size, 1) and len(coords) == n,
          "bad predict output")
    lab = labeller_on(SegPredictor(m.net, nb_classes=1, verbose=False
                                   ).predict_device(imgs), device)
    predict_ms = cuda_ms(lambda: m.predict(imgs, verbose=False), 5, device)

    v = load_model(AOI_RVAE, device=device)
    zero_counters()
    z = np.random.RandomState(0).randn(81, 2).astype(np.float32)
    manifold, decoded = v.manifold2d(), v.decode(z)
    torch.cuda.synchronize(device)
    mlp_launches = counted("spatial_mlp.forward_launches")
    check(mlp_launches == 2, f"decode and manifold2d launched the forward "
          f"kernel {mlp_launches} times")
    fused = ed.spatial_mlp
    ed.spatial_mlp = lambda *args, remat=False, skip=False: \
        sm.spatial_mlp_reference(*args, skip=skip)
    try:
        plain = v.manifold2d(), v.decode(z)
    finally:
        ed.spatial_mlp = fused
    mlp_err = max(scaled_err(torch.from_numpy(np.asarray(a, np.float32)),
                             torch.from_numpy(np.asarray(b, np.float32)))
                  for a, b in zip((manifold, decoded), plain))
    check(mlp_err <= TOL_MLP_SCALED, f"loaded rVAE's kernel decode off by "
          f"{mlp_err} of scale")
    v.dx_prior = 0.1          # the fit's default, which decoder_args reads
    args = decoder_args(v, torch.from_numpy(config_c_patches()[:81]).to(
        device), device)
    gy = torch.zeros((81, 1, 1024), device=device)
    fwd_ms, fwd_plain_ms, _, _, _ = mlp_kernel_ms(args, gy, device)
    bound = roofline_bound_fwd(81, 1024, args[2].shape[1], args[4].shape[0])

    # export: on the card (its bf16 policy traced), and on the CPU
    served, timing = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = export_model(m, os.path.join(tmp, "unet"),
                            example_shape=(size, size, 1))
        timing["export_card_s"] = time.perf_counter() - t0
        cpu_model = load_model(AOI_UNET, device="cpu")
        t0 = time.perf_counter()
        cpu_path = export_model(cpu_model, os.path.join(tmp, "unet_cpu"),
                                example_shape=(size, size, 1))
        timing["export_cpu_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        served["card"] = load_exported(path, device=device)
        served["cpu"] = load_exported(cpu_path, device=device)
        timing["load_exported_s"] = time.perf_counter() - t0

    def probs(e, x):
        return 1 / (1 + np.exp(-e.predict(x, max_batch=64)))

    errs = {}
    live = {64: m.predict(imgs, compute_coords=False, verbose=False),
            1: m.predict(imgs[:1], compute_coords=False, verbose=False)}
    for b, want in live.items():
        errs[f"card_b{b}"] = float(np.abs(probs(served["card"], imgs[:b])
                                          - want).max())
        check(errs[f"card_b{b}"] <= TOL_EXPORT_MIXED, f"exported predict "
              f"at batch {b} off by {errs[f'card_b{b}']}")
    # the CPU's float32 artifact against the live float32 forward (the
    # predictor runs the card's mixed policy, the trainer's forward the
    # model's own)
    m.precision = Precision.full()
    x = (imgs - imgs.min()) / (imgs.max() - imgs.min())
    with torch.no_grad():
        want = torch.sigmoid(m.forward(torch.from_numpy(
            x[..., None].astype(np.float32)).to(device))).cpu().numpy()
    m.precision = Precision.mixed()
    errs["cpu_artifact_b64"] = float(np.abs(probs(served["cpu"], imgs) -
                                            want).max())
    check(errs["cpu_artifact_b64"] <= TOL_EXPORT_F32, "the CPU artifact on "
          f"the card off by {errs['cpu_artifact_b64']}")
    for b in (1, 64):
        timing[f"exported_predict_b{b}_ms"] = cuda_ms(
            lambda: served["card"].predict(imgs[:b], max_batch=64), 5,
            device)
        timing[f"segmentor_predict_maps_b{b}_ms"] = cuda_ms(
            lambda: m.predict(imgs[:b], compute_coords=False,
                              verbose=False), 5, device)
        timing[f"exported_forward_b{b}_ms"] = cuda_ms(
            lambda: served["card"](torch.from_numpy(imgs[:b, ..., None]
                                                    ).to(device)), 5, device)
    emit("served_from_jax", frames=list(imgs.shape), launches=launches,
         atoms=int(sum(len(c) for c in coords.values())),
         predict_ms=predict_ms, labeller=lab, mlp_launches=mlp_launches,
         mlp_scaled_err=mlp_err, mlp_fwd_ms=fwd_ms,
         mlp_fwd_plain_ms=fwd_plain_ms, mlp_fwd_bound_ms=bound[0],
         export_max_abs_err=errs, export=timing,
         tolerances={"mlp": TOL_MLP_SCALED, "export_mixed":
                     TOL_EXPORT_MIXED, "export_f32": TOL_EXPORT_F32})
    return ({"launches": launches, "max_abs_err": lab["max_abs_err"],
             "ms": lab["kernel_ms"], "plain_ms": lab["kernel_plain_ms"],
             "bound_ms": lab["bound_ms"], "bound_by": lab["bound_by"]},
            {"launches": mlp_launches, "max_abs_err": mlp_err, "ms": fwd_ms,
             "plain_ms": fwd_plain_ms, "bound_ms": bound[0],
             "bound_by": bound[1]})


def roofline_bound_fwd(B, n, H, L):
    """(ms, "bytes"/"operations") of the spatial-MLP forward's bound."""
    from atomai_tpu_torch.ops import roofline
    from atomai_tpu_torch.ops import spatial_mlp as sm
    return roofline.bound(sm.spatial_mlp_flops(B, n, H, L)[0],
                          sm.spatial_mlp_bytes(B, n, H, L)[0])


def stat_call(fn, device):
    """(result, wall seconds, the card's busy share) of ``fn``: timed on
    the host clock to an idle card, then profiled in a second call."""
    import torch
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0, busy_share(fn, device)


def rel_rec_err(X, W, H):
    return float(np.linalg.norm(X - W @ H) / np.linalg.norm(X))


def span_rec_err(X, C):
    """Relative error of ``X`` (centred) projected on the row span of C."""
    Xc = X - X.mean(0)
    q, _ = np.linalg.qr(np.asarray(C, np.float64).T)
    return float(np.linalg.norm(Xc - Xc @ q @ q.T) / np.linalg.norm(Xc))


def spectral_cube(shape, seed=0):
    """(h, w, e) non-negative cube: 4 Gaussian-peak spectra mixed by
    smooth abundance maps, plus 1% noise."""
    h, w, e = shape
    rng = np.random.RandomState(seed)
    axis = np.arange(e, dtype=np.float32)
    ends = np.stack([np.exp(-((axis - c) / s) ** 2) for c, s in
                     zip(rng.uniform(100, e - 100, 4),
                         rng.uniform(20, 80, 4))]).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    maps = np.stack([np.sin(2 * np.pi * (a * yy + b * xx)) + 1.2
                     for a, b in rng.uniform(0.5, 2, (4, 2))], -1)
    maps = (maps / maps.sum(-1, keepdims=True)).astype(np.float32)
    cube = maps.reshape(-1, 4) @ ends
    cube += 0.01 * np.abs(rng.randn(*cube.shape)).astype(np.float32)
    return cube.reshape(h, w, e)


def phase_stat_path(device, trained_net):
    """The stat layer at users' sizes: phase 10's Unet on the 64 x 512²
    lattice stack -> Locator -> imlocal(32) -> GMM, PCA, ICA, NMF and
    transitions; SpectralUnmixer on a 256 x 256 x 1024 cube; SlidingFFTNMF
    on a 2048² frame; each timed with its busy share, and held against the
    same call of the port on the CPU (on the first windows, a corner)."""
    import torch
    from atomai_tpu_torch import stat
    from atomai_tpu_torch.predictors import SegPredictor
    from atomai_tpu_torch.utils import make_lattice_stack, remove_edge_coord
    imgs, _, _ = make_lattice_stack(**LATTICE)
    pred = SegPredictor(trained_net, nb_classes=1, verbose=False)
    pred.run(imgs)                            # warm-up
    zero_counters()
    t0 = time.perf_counter()
    maps, coords = pred.run(imgs)
    torch.cuda.synchronize(device)
    predict_s = time.perf_counter() - t0
    launches = counted("labeller.launches")
    check(launches == 1, f"predict launched the labeller {launches} times")
    lab = labeller_on(pred.predict_device(imgs), device)
    size = LATTICE["size"]
    coords = {k: remove_edge_coord(c, (size, size), STAT_EDGE)
              for k, c in coords.items()}
    n_atoms = int(sum(len(c) for c in coords.values()))
    check(n_atoms > 50000, f"only {n_atoms} atoms after edge removal")
    times, busy, agree = {}, {}, {}

    def run(name, fn):
        out, times[name], busy[name] = stat_call(fn, device)
        return out

    loc = run("imlocal", lambda: stat.imlocal(maps, coords, STAT_WINDOW,
                                              device=device))
    n = loc.d0
    check(loc.imgstack.shape == (n, STAT_WINDOW, STAT_WINDOW, 1) and
          n > 50000, f"stack {loc.imgstack.shape}")
    X = loc.imgstack.reshape(n, -1)
    gmm = run("gmm", lambda: loc.gmm(4, "diag"))
    pca = run("pca", lambda: loc.pca(8))
    ica = run("ica", lambda: loc.ica(4))
    nmf = run("nmf", lambda: loc.nmf(4))
    tm = run("transition_matrix", lambda: loc.transition_matrix(
        4, rmax=4, sum_all_transitions=True))
    for name, res in (("gmm", gmm[0]), ("pca", pca[1]), ("ica", ica[1]),
                      ("nmf", nmf[1])):
        check(bool(np.isfinite(res).all()), f"{name}: non-finite output")
    check(len(tm["trajectories"]) > 500 and
          bool(np.isfinite(tm["all_transitions"]).all()), "transitions")

    # the same calls on the first STAT_CPU_N windows, card against CPU
    t_cpu = time.perf_counter()
    sub = X[:STAT_CPU_N]
    res = {}
    for key, dev in (("card", device), ("cpu", torch.device("cpu"))):
        res[key] = {
            "pca": stat.PCA(8, device=dev).fit(sub),
            "km": stat.KMeans(4, device=dev).fit_predict(sub),
            "gmm": stat.GaussianMixture(4, "diag", device=dev
                                        ).fit_predict(sub),
            "ica": stat.FastICA(4, device=dev),
            "nmf": stat.NMF(4, device=dev)}
        res[key]["ica_s"] = res[key]["ica"].fit_transform(sub)
        res[key]["nmf_w"] = res[key]["nmf"].fit_transform(sub)
    c, h = res["card"], res["cpu"]
    agree["pca_components_max_abs"] = float(np.abs(
        c["pca"].components_ - h["pca"].components_).max())
    agree["pca_variance_rel"] = float(np.abs(
        c["pca"].explained_variance_ratio_ /
        h["pca"].explained_variance_ratio_ - 1).max())
    agree["kmeans_label_share"] = float((c["km"] == h["km"]).mean())
    agree["gmm_label_share"] = float((c["gmm"] == h["gmm"]).mean())
    rec = {d: (rel_rec_err(sub, r["nmf_w"], r["nmf"].components_),
               span_rec_err(sub, r["ica"].components_))
           for d, r in res.items()}
    agree["nmf_rec_err"] = [rec["card"][0], rec["cpu"][0]]
    agree["ica_rec_err"] = [rec["card"][1], rec["cpu"][1]]
    agree["nmf_rec_rel"] = abs(rec["card"][0] / rec["cpu"][0] - 1)
    agree["ica_rec_rel"] = abs(rec["card"][1] / rec["cpu"][1] - 1)
    check(agree["pca_components_max_abs"] <= TOL_STAT_PCA and
          agree["pca_variance_rel"] <= TOL_STAT_VAR_REL,
          f"PCA card vs CPU: {agree}")
    check(min(agree["kmeans_label_share"], agree["gmm_label_share"]) >=
          STAT_LABEL_SHARE, f"labels card vs CPU: {agree}")
    check(max(agree["nmf_rec_rel"], agree["ica_rec_rel"]) <=
          TOL_STAT_REC_REL, f"reconstructions card vs CPU: {agree}")
    times["card_vs_cpu_windows"] = time.perf_counter() - t_cpu

    # hyperspectral unmixing of a 256 MB cube
    cube = spectral_cube(CUBE)
    comps, abund = run("spectral_unmixer", lambda: stat.SpectralUnmixer(
        "nmf", 4, device=device).fit(cube))
    flat = cube.reshape(-1, CUBE[2])
    cube_err = rel_rec_err(flat, abund.reshape(-1, 4), comps)
    check(cube_err <= TOL_CUBE_FIT, f"cube NMF error {cube_err}")
    t_cpu = time.perf_counter()
    corner = np.ascontiguousarray(cube[:CUBE_CPU, :CUBE_CPU])
    cerr = [rel_rec_err(corner.reshape(-1, CUBE[2]), a.reshape(-1, 4), cc)
            for cc, a in (stat.SpectralUnmixer("nmf", 4, device=d).fit(
                corner) for d in (device, "cpu"))]
    agree["unmixer_corner_rec_err"] = cerr
    check(abs(cerr[0] / cerr[1] - 1) <= TOL_STAT_REC_REL,
          f"unmixer card vs CPU: {cerr}")
    times["card_vs_cpu_cube"] = time.perf_counter() - t_cpu

    # sliding FFT + NMF on one 2048² frame
    frame = make_lattice_stack(n_images=1, size=FFT_FRAME, spacing=16,
                               seed=0)[0][0]
    fc, fa = run("sliding_fft_nmf", lambda: stat.SlidingFFTNMF(
        device=device).analyze_image(frame, output_path=""))
    check(bool(np.isfinite(fc).all() and np.isfinite(fa).all()),
          "FFT-NMF non-finite")
    ferr = []
    t_cpu = time.perf_counter()
    for d in (device, "cpu"):
        an = stat.SlidingFFTNMF(device=d)
        spectra = an.process_fft(an.make_windows(frame[:FFT_CPU, :FFT_CPU]))
        comp, ab = an.run_nmf(spectra)
        ferr.append(rel_rec_err(spectra.reshape(len(spectra), -1),
                                ab.reshape(-1, comp.shape[0]),
                                comp.reshape(comp.shape[0], -1)))
    agree["fft_nmf_corner_rec_err"] = ferr
    check(abs(ferr[0] / ferr[1] - 1) <= TOL_STAT_REC_REL,
          f"FFT-NMF card vs CPU: {ferr}")
    times["card_vs_cpu_fft"] = time.perf_counter() - t_cpu
    emit("stat_path", frames=list(imgs.shape), launches=launches,
         predict_s=predict_s, atoms=n_atoms, windows=n,
         stack_mb=loc.imgstack.nbytes / 2 ** 20, seconds=times,
         busy_share=busy, card_vs_cpu=agree, labeller=lab,
         gmm_class_sizes=[int(len(v)) for v in gmm[1]],
         pca_variance_ratio=c["pca"].explained_variance_ratio_.tolist(),
         trajectories=len(tm["trajectories"]), cube=list(CUBE),
         cube_rec_err=cube_err, fft_frame=FFT_FRAME,
         fft_windows=int(fa.shape[1] * fa.shape[2]),
         tolerances={"pca": TOL_STAT_PCA, "variance": TOL_STAT_VAR_REL,
                     "label_share": STAT_LABEL_SHARE,
                     "rec_rel": TOL_STAT_REC_REL, "cube": TOL_CUBE_FIT})
    return {"launches": launches, "max_abs_err": lab["max_abs_err"],
            "ms": lab["kernel_ms"], "plain_ms": lab["kernel_plain_ms"],
            "bound_ms": lab["bound_ms"], "bound_by": lab["bound_by"]}


def graphene_frame(seed=0):
    """A 2048² frame of graphene at 0.104 Å a pixel, with 40 vacancies at
    least 12 Å from each other and from the frame's edge: (atoms [row,
    col] px, vacancies [row, col] px), both float64."""
    a1 = np.array([1.5, np.sqrt(3) / 2]) * CC_BOND_ANG
    a2 = np.array([1.5, -np.sqrt(3) / 2]) * CC_BOND_ANG
    side = GRAPH_FRAME * PX2ANG
    n = int(side / a1[1]) + 2   # rows i - j and columns i + j span it
    i, j = np.meshgrid(np.arange(n), np.arange(-n, n), indexing="ij")
    cells = i.reshape(-1, 1) * a1 + j.reshape(-1, 1) * a2
    xy = np.concatenate([cells, cells + [CC_BOND_ANG, 0.0]]) / PX2ANG
    inside = ((xy >= GRAPH_EDGE_PX) &
              (xy <= GRAPH_FRAME - GRAPH_EDGE_PX)).all(1)
    xy = xy[inside]
    xy = xy[np.lexsort((xy[:, 1], xy[:, 0]))]
    clear = VACANCY_CLEAR_ANG / PX2ANG
    rng = np.random.RandomState(seed)
    picked = []
    for k in rng.permutation(len(xy)):
        p = xy[k]
        if (min(p.min(), (GRAPH_FRAME - p).max()) >= clear and
                all(np.hypot(*(p - xy[q])) >= clear for q in picked)):
            picked.append(k)
            if len(picked) == GRAPH_VACANCIES:
                break
    check(len(picked) == GRAPH_VACANCIES, "too few vacancy sites")
    return np.delete(xy, picked, 0), xy[picked]


def rings_equal(adjacency, depth):
    """(the native rings, their seconds, the plain search's seconds) of a
    graph at ``depth``; the two must give the same rings in order."""
    from atomai_tpu_torch import native
    t0 = time.perf_counter()
    got = native.find_rings_native(adjacency, depth)
    t1 = time.perf_counter()
    want = native.find_rings_reference(adjacency, depth)
    t2 = time.perf_counter()
    check(got == want, f"native rings differ from the plain search's at "
          f"depth {depth} ({len(got)} against {len(want)})")
    return got, t1 - t0, t2 - t1


def axis_diff(a, b):
    """Distance of two axis orientations in degrees (period 180)."""
    return np.abs((np.asarray(a) - np.asarray(b) + 90) % 180 - 90)


def phase_graph_path(device, trained_net):
    """The graph-analysis workflow and the rest of ``utils`` on the card:
    ``find_com`` of a rendered 2048² graphene frame with 40 vacancies ->
    ``find_cycles`` / ``find_cycle_clusters`` (the native ring search,
    held to its plain version); ``filter_cells``, ``get_contours`` and
    ``get_blob_params`` on phase 10's trained masks of the 64 x 512²
    stack (labels against the plain labeller, outputs against the port on
    the CPU); nearest-neighbour distances, bonds and coordinate clusters
    of its ~55,000 located atoms (the queries held to cKDTree)."""
    import torch
    from atomai_tpu_torch import native, ops
    from atomai_tpu_torch.ops import cc_kernel, roofline
    from atomai_tpu_torch.predictors import SegPredictor
    from atomai_tpu_torch.utils import (Graph, create_lattice_mask,
                                        filter_cells, find_com,
                                        find_coord_clusters, find_cycles,
                                        find_cycle_clusters, get_blob_params,
                                        get_contours, get_nn_distances,
                                        make_lattice_stack, map_bonds,
                                        remove_edge_coord)
    times, busy, launches = {}, {}, {}

    def run(name, fn, count=False):
        """Times one call from an idle card to an idle card (its labeller
        launches counted), then profiles a second for the busy share."""
        torch.cuda.synchronize(device)
        zero_counters()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        times[name] = time.perf_counter() - t0
        if count:
            launches[name] = counted("labeller.launches")
        busy[name] = busy_share(fn, device)
        return out

    # 1-2: a graphene frame, its atoms located by the labeller
    atoms, vacancies = graphene_frame()
    t0 = time.perf_counter()
    mask = create_lattice_mask(
        np.zeros((GRAPH_FRAME, GRAPH_FRAME), np.float32), atoms)
    times["render"] = time.perf_counter() - t0
    com = run("find_com", lambda: find_com(mask), count=True)
    check(launches["find_com"] == 1,
          f"find_com launched the labeller {launches['find_com']} times")
    graphene = torch.from_numpy(mask > 0).to(device)
    plain = ops.blob_means(*ops.blob_sums_reference(graphene))[0]
    check(np.array_equal(com, plain.cpu().numpy()),
          "find_com differs from the plain labeller's centres")
    check(len(com) == len(atoms), f"{len(com)} atoms found, "
          f"{len(atoms)} placed")
    atom_err = float(np.median(atom_errors([com], [atoms], MASK_OFFSET)))
    check(atom_err < TOL_MEDIAN_PX, f"median atom error {atom_err} px")

    # 3: rings and ring clusters
    coord = np.concatenate([com.astype(np.float64),
                            np.zeros((len(com), 1))], 1)
    carbon = {0: "C"}
    twelve = run("find_cycles", lambda: find_cycles(
        coord, 12, carbon, PX2ANG))
    clusters = run("find_cycle_clusters", lambda: find_cycle_clusters(
        coord, DEFECT_CYCLES, carbon, PX2ANG))
    scaled = coord.copy()
    scaled[:, :2] *= PX2ANG
    g = Graph(scaled, carbon)
    t0 = time.perf_counter()
    g.find_neighbors()
    times["find_neighbors"] = time.perf_counter() - t0
    rings8, times["rings_depth8_native"], times["rings_depth8_plain"] = \
        rings_equal(g.adjacency, 8)
    t0 = time.perf_counter()
    rings12 = native.find_rings_native(g.adjacency, 12)
    times["rings_depth12_native"] = time.perf_counter() - t0
    crop = scaled[(coord[:, :2] < GRAPH_CROP_PX).all(1)]
    gc = Graph(crop, carbon)
    gc.find_neighbors()
    _, times["crop_depth12_native"], times["crop_depth12_plain"] = \
        rings_equal(gc.adjacency, 12)
    sizes, counts = np.unique([len(r) for r in rings12], return_counts=True)
    histogram = {int(k): int(v) for k, v in zip(sizes, counts)}
    check(histogram.get(12) == GRAPH_VACANCIES and
          twelve.shape == (12 * GRAPH_VACANCIES, 3),
          f"12-member rings {histogram}, find_cycles {twelve.shape}")
    check(len(clusters) == GRAPH_VACANCIES,
          f"{len(clusters)} clusters for {GRAPH_VACANCIES} vacancies")
    centres = np.array([c.mean(0) for c in clusters])
    d = np.linalg.norm(centres[:, None] - (vacancies + MASK_OFFSET)[None],
                       axis=-1)
    nearest = d.argmin(1)
    cluster_err = float(d.min(1).max())
    check(len(set(nearest.tolist())) == GRAPH_VACANCIES and
          cluster_err < TOL_MEDIAN_PX and
          all(len(c) == 12 for c in clusters),
          f"clusters off their vacancies by up to {cluster_err} px")

    # 4: the trained masks
    imgs, _, _ = make_lattice_stack(**LATTICE)
    pred = SegPredictor(trained_net, nb_classes=1, verbose=False)
    maps_t = pred.predict_device(imgs)[..., 0].contiguous()
    maps = maps_t.cpu().numpy()
    label_err = 0
    for f in maps_t:
        m = f > 0.5
        label_err = max(label_err, int((ops.label_components_cuda(m).long()
                                        - ops.label_components_reference(
                                            m).long()).abs().max()))
    check(label_err == 0, f"kernel labels off by {label_err}")
    filtered = run("filter_cells", lambda: filter_cells(
        maps, 0.5, BLOB_THRESH), count=True)
    contours = run("get_contours", lambda: [
        get_contours(f) for f in maps > 0.5], count=True)
    blobs = run("get_blob_params", lambda: get_blob_params(
        maps, 0.5, BLOB_THRESH), count=True)
    n = len(maps)
    check(launches["filter_cells"] == n and launches["get_contours"] == n
          and launches["get_blob_params"] == 2 * n,
          f"labeller launches {launches}")
    t0 = time.perf_counter()
    k = GRAPH_CPU_FRAMES
    cpu = dict(device="cpu")
    f_cpu = filter_cells(maps[:k], 0.5, BLOB_THRESH, **cpu)
    check(np.array_equal(filtered[:k], f_cpu), "filter_cells: card vs CPU")
    for i in range(k):
        c_cpu = get_contours(maps[i] > 0.5, **cpu)
        check(len(c_cpu) == len(contours[i]) and all(
            np.array_equal(a, b) for a, b in zip(contours[i], c_cpu)),
            f"get_contours frame {i}: card vs CPU")
    b_cpu = get_blob_params(maps[:k], 0.5, BLOB_THRESH, **cpu)
    angle_err = 0.0
    for i in range(k):
        check(np.array_equal(blobs[i]["coordinates"],
                             b_cpu[i]["coordinates"]),
              f"get_blob_params frame {i}: centres card vs CPU")
        angle_err = max(angle_err, float(axis_diff(
            blobs[i]["angles"], b_cpu[i]["angles"]).max()))
    check(angle_err <= TOL_BLOB_ANGLE, f"blob angles off by {angle_err}")
    times["card_vs_cpu_frames"] = time.perf_counter() - t0
    n_blobs = int(sum(len(b["coordinates"]) for b in blobs.values()))
    n_contours = int(sum(len(c) for c in contours))
    check(n_blobs > 50000 and n_contours >= n_blobs,
          f"{n_blobs} blobs, {n_contours} contours")

    # 5: neighbours of the located atoms
    _, coords = pred.run(imgs)
    size = LATTICE["size"]
    coords = {i: remove_edge_coord(c, (size, size), STAT_EDGE)
              for i, c in coords.items()}
    dists, _ = run("get_nn_distances", lambda: get_nn_distances(coords))
    bonds = run("map_bonds", lambda: map_bonds(coords, plot_results=False))
    cl_mean, _, cl = run("find_coord_clusters", lambda: find_coord_clusters(
        coords, coords, NN_RMAX))
    check(np.array_equal(bonds, np.concatenate(dists)) and
          bool(np.isfinite(bonds).all()), "map_bonds")
    pts = np.concatenate(list(coords.values()))[:, :2]
    t0 = time.perf_counter()
    balls = native.ball_query(pts, coords[0][:, :2], NN_RMAX)
    balls_ref = native.ball_query_reference(pts, coords[0][:, :2], NN_RMAX)
    check(len(balls) == len(balls_ref) and all(
        np.array_equal(a, b) for a, b in zip(balls, balls_ref)),
        "ball_query differs from cKDTree's")
    pairs = native.query_pairs(pts, NN_RMAX)
    check(np.array_equal(pairs, native.query_pairs_reference(pts, NN_RMAX)),
          "query_pairs differs from cKDTree's")
    times["queries_vs_ckdtree"] = time.perf_counter() - t0
    check(len(cl) == len(coords[0]) == len(cl_mean) and
          min(len(c) for c in cl) >= 1, "coord clusters")

    # the labeller at this path's shapes
    kernel_ms = device_ms(lambda: cc_kernel.launch(graphene), 20, device)
    bound_ms, bound_by = roofline.bound(0, cc_kernel.cc_label_bytes(
        GRAPH_FRAME, GRAPH_FRAME, len(com)))
    frame = maps_t[0] > 0.5
    emit("graph_path", frame=[GRAPH_FRAME, GRAPH_FRAME], atoms=len(atoms),
         vacancies=GRAPH_VACANCIES, median_atom_err_px=atom_err,
         ring_histogram=histogram, rings_depth8=len(rings8),
         crop_atoms=len(crop), clusters=len(clusters),
         cluster_max_err_px=cluster_err, trained_frames=list(maps.shape),
         blobs=n_blobs, contours=n_contours, blob_angle_err=angle_err,
         located_atoms=len(pts), nn_distances=int(len(bonds)),
         ball_pairs=int(sum(map(len, balls))), pairs=int(len(pairs)),
         launches=launches, seconds=times, busy_share=busy,
         kernel_ms=kernel_ms, bound_ms=bound_ms,
         tolerances={"blob_angle_deg": TOL_BLOB_ANGLE,
                     "median_px": TOL_MEDIAN_PX})
    return {"launches": launches, "max_abs_err": label_err,
            "ms": kernel_ms,
            "plain_ms": cuda_ms(lambda: ops.blob_sums_reference(graphene),
                                3, device),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": [GRAPH_FRAME, GRAPH_FRAME], "blobs": len(com),
            "frame_ms": device_ms(lambda: cc_kernel.launch(frame), 20,
                                  device),
            "frame_plain_ms": cuda_ms(
                lambda: ops.blob_sums_reference(frame), 3, device)}


def _seg_remat_runs(device, imgs, masks, deterministic, cycles):
    """Config A's Unet fitted for ``cycles`` cycles from seed 1 (the
    same weights, generators and batch order): ``SPREAD_FITS`` plain fits,
    then one with ``remat=True``; cuDNN's deterministic algorithms on or
    off. Returns (the plain fits, the remat fit)."""
    import torch
    from atomai_tpu_torch import models
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    runs = []
    try:
        with tempfile.TemporaryDirectory() as tmp, quiet():
            for i, remat in enumerate([False] * SPREAD_FITS + [True]):
                m = models.Segmentor("Unet", 1, seed=1, device=device)
                m.fit(imgs, masks, training_cycles=cycles,
                      batch_size=SEG_BATCH, print_loss=cycles,
                      remat=remat, filename=os.path.join(tmp, f"r{i}"))
                runs.append(m)
    finally:
        torch.backends.cudnn.deterministic = saved
    return runs[:-1], runs[-1]


def hold_to_spread(what, fit, plains, diff, bounds, spread_keys):
    """Holds ``fit``, which should compute what the plain fits compute,
    to them: a measure k of ``diff`` passes where ``fit`` lies within
    ``bounds[k]`` of every plain fit or, for k in ``spread_keys``, where
    the nearest plain fit lies within ``REMAT_NOISE_FACTOR`` times the
    largest distance between two plain fits (the card's own spread). A fit
    that follows the plain fits' distribution is then an outlier only by
    chance far below one run in a hundred; one that goes its own way lies
    far from all of them. Returns the distances."""
    near = [diff(fit, p) for p in plains]
    pairs = [diff(a, b) for i, a in enumerate(plains) for b in plains[i + 1:]]
    nearest = {k: min(d[k] for d in near) for k in bounds}
    farthest = {k: max(d[k] for d in near) for k in bounds}
    spread = {k: max(d[k] for d in pairs) for k in bounds}
    check(all(farthest[k] <= b or (k in spread_keys and nearest[k] <=
                                   REMAT_NOISE_FACTOR * spread[k])
              for k, b in bounds.items()),
          f"{what} off the plain fits: nearest {nearest}, farthest "
          f"{farthest}; the plain fits' spread {spread}")
    return {"vs_plain": near, "plain_vs_plain": pairs, "nearest": nearest,
            "spread": spread}


def _seg_run_diff(a, b):
    """How far two fits of the same Unet are apart: losses (relative),
    parameters (absolute), BatchNorm running statistics (of their scale),
    and whether all of it is bit for bit equal."""
    import torch
    losses = [(np.asarray(a.loss_acc[k]), np.asarray(b.loss_acc[k]))
              for k in ("train_loss", "test_loss")]
    loss_rel = max(float(np.abs(x / y - 1).max()) for x, y in losses)
    sa, sb = a.net.state_dict(), b.net.state_dict()
    params = dict(a.net.named_parameters())
    w = max(float((sa[k] - sb[k]).abs().max()) for k in params)
    stats = max(float((sa[k] - sb[k]).abs().max() / sb[k].abs().max())
                for k in sa if k.endswith(("running_mean", "running_var")))
    bitwise = all(np.array_equal(x, y) for x, y in losses) and all(
        torch.equal(sa[k], sb[k]) for k in sa)
    return {"loss_rel": loss_rel, "param_abs": w, "stats_rel": stats,
            "bitwise": bitwise,
            "first_loss_bitwise": bool(losses[0][0][0] == losses[0][1][0]),
            "stats_bitwise": all(torch.equal(sa[k], sb[k]) for k in sa
                                 if k.startswith("running")
                                 or ".running" in k)}


def _peak_step(m, X, y, device):
    """(peak bytes, peak bytes above what was allocated before, ms) of one
    training step of ``m`` on the batch, after a warm-up step."""
    import torch
    m._train_batch(X, y)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    _, ms = timed(lambda: m._train_batch(X, y), device)
    peak = torch.cuda.max_memory_allocated(device)
    return peak, peak - base, ms


def _vae_remat_pair(cls, kw, X, device):
    """A VAE of ``cls`` fitted plain and with ``remat=True`` from the same
    seed for ``REMAT_VAE_EPOCHS`` epochs: the ELBO histories, each fit's
    spatial-MLP launches, and the peak bytes above the resting allocation
    of one more epoch."""
    import torch
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for remat in (False, True):
            m = cls((32, 32), device=device, **kw)
            check(m.decoder_net.fused(), f"{cls.__name__}'s decoder does "
                  "not route to the kernels")
            zero_counters()
            m.fit(X, training_cycles=REMAT_VAE_EPOCHS, batch_size=RVAE_BATCH,
                  remat=remat, verbose=False,
                  filename=os.path.join(tmp, f"v{remat}"))
            torch.cuda.synchronize(device)
            launches = mlp_steps()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            m.train_epoch()
            peak = torch.cuda.max_memory_allocated(device) - base
            out["remat" if remat else "plain"] = {
                "elbo": list(m.loss_history["train_loss"]),
                "launches": launches, "epoch_peak_bytes": peak}
    steps = REMAT_VAE_EPOCHS * (len(X) // RVAE_BATCH)
    plain, remat = out["plain"], out["remat"]
    rel = float(np.abs(np.asarray(remat["elbo"]) /
                       np.asarray(plain["elbo"]) - 1).max())
    check(bool(np.isfinite(remat["elbo"]).all()) and
          rel <= TOL_REMAT_ELBO_REL, f"{cls.__name__}: remat ELBOs "
          f"{rel} off the plain fit's")
    for way in (plain, remat):
        check(way["launches"] == [steps, steps], f"{cls.__name__}: "
              f"{steps} steps launched the kernels {way['launches']} times")
    out.update(steps=steps, elbo_rel=rel,
               elbo_bitwise=remat["elbo"] == plain["elbo"],
               launches_per_step=[v / steps for v in remat["launches"]])
    return out


def phase_remat_path(device):
    """``fit(remat=True)`` on the card (``nets/remat.py``): config A's Unet
    against the plain fit (bitwise, with cuDNN's deterministic algorithms
    and without, then within the stated bounds), the peak memory of one
    training step both ways at batch 32 and 256, training steps/s both
    ways in turns, and ``predict`` after the remat fit (one labeller
    launch, held exactly to the plain labeller); config C's rVAE and the
    jrVAE pin against their plain fits, with the spatial-MLP launches a
    step (one forward, one backward: the kernels stay outside the
    checkpoints) and the peak memory of an epoch both ways."""
    import torch
    from atomai_tpu_torch.models import jrVAE, rVAE
    from atomai_tpu_torch.nets import set_remat
    from atomai_tpu_torch.predictors import SegPredictor
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, masks, _ = make_lattice_stack(**MAIN)
    t0 = time.perf_counter()
    # one cycle with cuDNN's deterministic algorithms: the forward (the
    # first loss, the running statistics it sets) against the plain one,
    # the weights within one Adam step of each other
    plains, remat = _seg_remat_runs(device, imgs, masks, True, 1)
    compare = {"first_cycle_deterministic": hold_to_spread(
        "remat's first cycle", remat, plains, _seg_run_diff,
        {"loss_rel": TOL_REMAT_LOSS_REL,
         "param_abs": TOL_REMAT_W / REMAT_CYCLES,
         "stats_rel": TOL_REMAT_STATS_REL}, ())}
    bounds = {"loss_rel": TOL_REMAT_LOSS_REL, "param_abs": TOL_REMAT_W,
              "stats_rel": TOL_REMAT_STATS_REL}
    for mode, det in (("deterministic", True), ("default", False)):
        plains, remat = _seg_remat_runs(device, imgs, masks, det,
                                        REMAT_CYCLES)
        check(remat.remat and remat.net.c1.remat, "remat was not set")
        compare[mode] = hold_to_spread(f"remat fit ({mode} cuDNN)", remat,
                                       plains, _seg_run_diff, bounds, bounds)

    # predict after the remat fit: one labeller launch, exact labels
    zero_counters()
    maps, coords = remat.predict(imgs, verbose=False)
    torch.cuda.synchronize(device)
    launches = counted("labeller.launches")
    check(launches == 1, f"predict launched the labeller {launches} times")
    check(maps.shape == (64, 256, 256, 1) and len(coords) == 64,
          "bad predict output")
    lab = labeller_on(SegPredictor(remat.net, nb_classes=1, verbose=False)
                      .predict_device(imgs), device, timed=False)

    # peak memory of one step, and steps/s at config A's batch, both ways
    m = plains[0]
    memory = {}
    g = torch.Generator(device).manual_seed(0)
    for bs in REMAT_MEMORY_BATCHES:
        X = torch.rand((bs, 256, 256, 1), generator=g, device=device)
        y = (torch.rand((bs, 256, 256), generator=g, device=device)
             > 0.8).float()
        for on in (False, True):
            set_remat(m.net, on)
            peak, above, ms = _peak_step(m, X, y, device)
            memory[f"batch{bs}_{'remat' if on else 'plain'}"] = {
                "peak_bytes": peak, "step_peak_bytes": above, "step_ms": ms}
        del X, y
    for bs in REMAT_MEMORY_BATCHES:
        check(memory[f"batch{bs}_remat"]["step_peak_bytes"] <
              memory[f"batch{bs}_plain"]["step_peak_bytes"],
              f"remat did not lower a step's peak at batch {bs}: {memory}")
    X32, y32 = m.Xb_train[0], m.yb_train[0]
    rates = {"plain": [], "remat": []}
    for on in (False, True, True, False):
        set_remat(m.net, on)
        rates["remat" if on else "plain"].append(1e3 / cuda_ms(
            lambda: m._train_batch(X32, y32), REMAT_STEP_REPS, device))
    set_remat(m.net, False)
    seg_s = time.perf_counter() - t0

    # the VAEs: rVAE (config C) and the jrVAE pin
    X = config_c_patches()
    vaes = {"rvae": _vae_remat_pair(rVAE, {"latent_dim": 2}, X, device),
            "jrvae": _vae_remat_pair(jrVAE, JVAE_KW, X, device)}
    emit("remat_path", frames=list(imgs.shape), cycles=REMAT_CYCLES,
         batch=SEG_BATCH, unet=compare, predict_launches=launches,
         labeller=lab, memory=memory, train_steps_per_s=rates,
         unet_seconds=seg_s, vaes=vaes,
         tolerances={**bounds, "noise_factor": REMAT_NOISE_FACTOR,
                     "first_cycle_param_abs": TOL_REMAT_W / REMAT_CYCLES,
                     "elbo_rel": TOL_REMAT_ELBO_REL})
    mlp = [{"launches": sum(v["remat"]["launches"][i] for v in vaes.values()),
            "steps": sum(v["steps"] for v in vaes.values()),
            "launches_per_step": vaes["rvae"]["launches_per_step"][i]}
           for i in range(2)]
    return ({"launches": launches, "max_abs_err": lab["max_abs_err"],
             "blobs": lab["blobs"]}, mlp[0], mlp[1])


def _mesh_seg(device, data_mesh, tmp, plain):
    """Config A's Unet split over the data mesh, against ``mesh=False``
    fits from the same weights in rank 0 (``plain``):

    - one cycle in float32 without TF32, where the split only reorders
      float32 sums: the first loss, the running statistics (one update
      from the same weights) and the weights (Adam's first step moves each
      by lr either way) within a priori bounds;
    - 10 cycles under the production (bf16) policy, under the profiler
      (this rank's busy share of the card): the losses within the
      seg-train fixture's bound or the card's own spread, and the weights
      within Adam's 2 * lr a step. The statistics are recorded: the split
      reorders every layer's sums where the card's atomics reorder only
      the upsampling's backward, so after 10 cycles they end further
      apart than two plain fits (measured on an H100), with no bound
      to hold them to; the ranks hold them bit for bit equal.
    """
    import torch
    from atomai_tpu_torch import models
    from atomai_tpu_torch.core.dtypes import Precision, set_default_precision
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, masks, _ = make_lattice_stack(**MAIN)

    def fit(mesh, name, cycles, full=False):
        set_default_precision(Precision.full() if full else None)
        try:
            m = models.Segmentor("Unet", 1, seed=1, device=device)
        finally:
            set_default_precision(None)
        t0 = time.perf_counter()
        m.fit(imgs, masks, training_cycles=cycles, batch_size=SEG_BATCH,
              print_loss=cycles, mesh=mesh,
              filename=os.path.join(tmp, name))
        torch.cuda.synchronize(device)
        return m, time.perf_counter() - t0

    step, _ = fit(data_mesh, "seg_step", 1, full=True)
    box = []
    busy = busy_share(lambda: box.append(
        fit(data_mesh, "seg_mesh", MESH_SEG_CYCLES)), device)
    meshed, seconds = box[0]
    out = {"mesh": list(meshed.mesh.shape), "seconds": seconds,
           "busy_share": busy, "loss": meshed.loss_acc,
           "step_loss": step.loss_acc,
           "state": {k: v.cpu() for k, v in meshed.net.state_dict().items()}}
    if not plain:
        return meshed, out
    one_step, _ = fit(False, "seg_step_plain", 1, full=True)
    d1 = _seg_run_diff(step, one_step)
    d1["first_loss_rel"] = abs(step.loss_acc["train_loss"][0] /
                               one_step.loss_acc["train_loss"][0] - 1)
    check(d1["first_loss_rel"] <= TOL_MESH_SEG_STEP["first_loss_rel"] and
          d1["stats_rel"] <= TOL_MESH_SEG_STEP["stats_rel"] and
          d1["param_abs"] <= TOL_MESH_SEG_STEP["param_abs"],
          f"config A's split float32 step off the plain step: {d1}")
    plains = [fit(False, f"seg_plain{i}", MESH_SEG_CYCLES)
              for i in range(SPREAD_FITS)]
    bounds = {"loss_rel": TOL_REMAT_LOSS_REL,
              "param_abs": 2 * 1e-3 * MESH_SEG_CYCLES}
    held = hold_to_spread("config A on the mesh", meshed,
                          [m for m, _ in plains], _seg_run_diff, bounds,
                          ("loss_rel",))
    out.update(plain_seconds=plains[0][1], step_mesh_vs_plain=d1,
               mesh_vs_plain=held, bounds=bounds,
               step_bounds=TOL_MESH_SEG_STEP)
    return meshed, out


def _mesh_predict(device, net, data_mesh):
    """The sharded ``SegPredictor.run`` on config A's frames: one labeller
    launch a rank, the labeller's labels and fused sums on the sharded
    maps equal to its plain version's, the maps against one process's."""
    import torch
    from atomai_tpu_torch.predictors import SegPredictor
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, _, _ = make_lattice_stack(**MAIN)
    p = SegPredictor(net, nb_classes=1, verbose=False, mesh=data_mesh)
    zero_counters()
    t0 = time.perf_counter()
    maps, coords = p.run(imgs)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = counted("labeller.launches")
    check(launches == 1, f"the sharded predict launched the labeller "
          f"{launches} times")
    check(maps.shape == (64, 256, 256, 1) and len(coords) == 64,
          "bad sharded predict output")
    lab = labeller_on(p.predict_device(imgs), device, timed=False)
    plain = SegPredictor(net, nb_classes=1, verbose=False,
                         mesh=False).predict(imgs)
    err = float(np.abs(maps - plain).max())
    check(err <= TOL_MESH_MAPS, f"sharded maps {err} off one process's")
    return {"mesh": list(p.mesh.shape), "seconds": seconds,
            "labeller_launches": launches, "labeller": lab,
            "maps_max_abs_err": err}


@contextlib.contextmanager
def first_backward_inputs(box):
    """Keeps a copy of the inputs and output gradient of the first launch
    of the spatial-MLP backward kernel in the block (the forward kernel's
    inputs of the same step) in ``box``."""
    from atomai_tpu_torch.ops import spatial_mlp as sm
    launch = sm.spatial_mlp_backward_cuda

    def keep(*args, **kwargs):
        if not box:
            box.extend(a.detach().clone() for a in args)
        return launch(*args, **kwargs)

    sm.spatial_mlp_backward_cuda = keep
    try:
        yield
    finally:
        sm.spatial_mlp_backward_cuda = launch


def _mesh_rvae(device, data_mesh, tmp, plain):
    """Config C's rVAE on the data mesh and, where ``plain``, with
    ``mesh=False``: the ELBOs, the spatial-MLP launches of this rank (one
    forward and one backward a step, on its rows), and both kernels held
    against their plain versions on the inputs of this rank's first
    step."""
    import torch
    from atomai_tpu_torch.models import rVAE
    X = config_c_patches()
    runs, step_inputs = {}, []
    for name, mesh in (("mesh", data_mesh), ("plain", False))[:1 + plain]:
        m = rVAE((32, 32), latent_dim=2, device=device)
        check(m.decoder_net.fused(), "the rVAE's decoder does not route to "
              "the kernels")
        zero_counters()
        t0 = time.perf_counter()
        with first_backward_inputs(step_inputs):
            m.fit(X, training_cycles=MESH_VAE_EPOCHS, batch_size=RVAE_BATCH,
                  mesh=mesh, verbose=False, filename=os.path.join(tmp, name))
        torch.cuda.synchronize(device)
        runs[name] = {"elbo": list(m.loss_history["train_loss"]),
                      "launches": mlp_steps(),
                      "seconds": time.perf_counter() - t0,
                      "mesh": None if m.mesh is None else list(m.mesh.shape)}
    steps = MESH_VAE_EPOCHS * (len(X) // RVAE_BATCH)
    rows = RVAE_BATCH // list(data_mesh.shape)[0]
    check(bool(np.isfinite(runs["mesh"]["elbo"]).all()),
          "non-finite ELBOs on the mesh")
    check(runs["mesh"]["launches"] == [steps, steps],
          f"{steps} steps launched the kernels {runs['mesh']['launches']} "
          "times")
    check(step_inputs[0].shape[0] == rows, f"the kernels saw "
          f"{step_inputs[0].shape[0]} rows, not this rank's {rows}")
    out = {"steps": steps, "rows_a_rank": rows, **runs,
           "kernels": mlp_kernels_on(step_inputs[:8], step_inputs[8],
                                     device)}
    if plain:
        rel = float(np.abs(np.asarray(runs["mesh"]["elbo"]) /
                           np.asarray(runs["plain"]["elbo"]) - 1).max())
        check(rel <= TOL_REMAT_ELBO_REL,
              f"rVAE ELBOs on the mesh {rel} off the plain fit's")
        out["elbo_rel"] = rel
    return out


def _mesh_ensemble(device, model_mesh, tmp, plain):
    """Config D's 4 members over the model axis and, where ``plain``, with
    ``mesh=False`` (``SPREAD_FITS`` times, for the card's own spread);
    then the ``EnsemblePredictor`` of the members on the model axis
    against one process's."""
    import torch
    from atomai_tpu_torch.predictors import EnsemblePredictor
    from atomai_tpu_torch.trainers import EnsembleTrainer
    from atomai_tpu_torch.transforms import seg_augmentor
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, masks, _ = make_lattice_stack(**ENS_DATA)
    aug = seg_augmentor(1, **AUG)

    def fit(mesh, name, layout="map", augment_fn=aug):
        et = EnsembleTrainer("Unet", 1, device=device)
        et.compile_ensemble_trainer(training_cycles=MESH_ENS_CYCLES,
                                    batch_size=ENS_BATCH, swa=True,
                                    filename=os.path.join(tmp, name),
                                    mesh=mesh, member_layout=layout)
        t0 = time.perf_counter()
        net, ens = et.train_ensemble_from_scratch(
            imgs, masks, n_models=ENS_MODELS, augment_fn=augment_fn)
        torch.cuda.synchronize(device)
        return et, net, ens, time.perf_counter() - t0

    def diff(a, b):
        la, lb = (np.asarray(e.loss_acc["train_loss"]) for e in (a[0], b[0]))
        w = max(float((a[2][i][k] - b[2][i][k]).abs().max())
                for i in b[2] for k in b[2][i]
                if b[2][i][k].is_floating_point())
        return {"loss_rel": float(np.abs(la / lb - 1).max()), "abs": w}

    meshed = fit(model_mesh, "em")
    vmapped = fit(model_mesh, "ev", "vmap")
    out = {"mesh": list(model_mesh.shape)}
    for name, run in (("map", meshed), ("vmap", vmapped)):
        check(len(run[2]) == ENS_MODELS, f"{name} members missing on this "
              "rank")
        out[name] = {"seconds": run[3],
                     "loss": list(run[0].loss_acc["train_loss"]),
                     "members": {i: {k: v.cpu() for k, v in s.items()}
                                 for i, s in run[2].items()}}
    if plain:
        # each layout against one process's fits of the same layout (phase
        # 31 holds the layouts to each other). The member axis computes a
        # loop's member as one process does; a vmap over a rank's 2
        # members runs grouped convs of 2 groups, not 4, which cuDNN may
        # round in another order, so two of the vmap's plain fits sum
        # their batches in other orders too (``frames_reordered``)
        bounds = {"loss_rel": TOL_REMAT_LOSS_REL,
                  "abs": 2 * 1e-3 * MESH_ENS_CYCLES}
        out["bounds"] = bounds
        for layout, run, key in (("map", meshed, "mesh_vs_plain"),
                                 ("vmap", vmapped, "vmap_mesh_vs_plain")):
            plains = [fit(False, f"ep{layout}{i}", layout,
                          frames_reordered(aug, i) if layout == "vmap" and
                          i else aug)
                      for i in range(SPREAD_FITS)]
            out[key] = hold_to_spread(
                f"config D's {layout} layout on the member axis", run,
                plains, diff, bounds, bounds)
            out[layout]["plain_seconds"] = plains[0][3]
    net, ens = meshed[1], meshed[2]
    p = EnsemblePredictor(net, ens, nb_classes=1, verbose=0,
                          mesh=model_mesh)
    t0 = time.perf_counter()
    mean, var = p.predict(imgs, num_batches=4)
    torch.cuda.synchronize(device)
    predict_s = time.perf_counter() - t0
    mean1, var1 = EnsemblePredictor(net, ens, nb_classes=1, verbose=0,
                                    mesh=False).predict(imgs, num_batches=4)
    err = max(float(np.abs(mean - mean1).max()),
              float(np.abs(var - var1).max()))
    check(err <= TOL_MESH_MEMBERS, f"ensemble predictor on the member axis "
          f"{err} off one process's")
    out.update(members_a_rank=len(p.members), predict_s=predict_s,
               predict_max_abs_err=err)
    return out


def _mesh_dkl(device, model_mesh, plain):
    """Config E's 4 x 2,048 independent outputs over the model axis and,
    where ``plain``, with ``mesh=False``: losses and the posterior."""
    import torch
    from atomai_tpu_torch.models import dklGPR
    rng = np.random.RandomState(0)
    X = rng.randn(GP_N_SMALL, GP_DIM).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.randn(GP_N_SMALL)).astype(np.float32)
    Y = np.stack([y, -y, X[:, 1], X[:, 0] + X[:, 1]])[:GP_OUTPUTS]
    runs = {}
    for name, mesh in (("mesh", model_mesh), ("plain", False))[:1 + plain]:
        m = dklGPR(GP_DIM, embedim=2, shared_embedding_space=False,
                   device=device)
        t0 = time.perf_counter()
        m.fit(X, Y, training_cycles=MESH_DKL_CYCLES,
              print_loss=MESH_DKL_CYCLES, mesh=mesh)
        torch.cuda.synchronize(device)
        mean, var = m.predict(X[:256])
        runs[name] = {"loss": list(m.train_loss), "mean": mean, "var": var,
                      "seconds": time.perf_counter() - t0}
    out = {"mesh": list(model_mesh.shape), "outputs": GP_OUTPUTS,
           "n": GP_N_SMALL, "loss": runs["mesh"]["loss"],
           "seconds": runs["mesh"]["seconds"]}
    check(bool(np.isfinite(runs["mesh"]["loss"]).all()) and
          bool(np.isfinite(runs["mesh"]["mean"]).all()),
          "non-finite DKL losses or posterior on the output axis")
    if plain:
        rel = float(np.abs(np.asarray(runs["mesh"]["loss"]) /
                           np.asarray(runs["plain"]["loss"]) - 1).max())
        post = max(float(np.abs(runs["mesh"][k] - runs["plain"][k]).max())
                   for k in ("mean", "var"))
        check(rel <= TOL_MESH_DKL_REL and bool(np.isfinite(post)),
              f"independent DKL on the output axis: losses {rel} off")
        out.update(loss_rel=rel, posterior_max_abs=post,
                   plain_seconds=runs["plain"]["seconds"])
    return out


def mesh_path_rank(rank, world, parts, net_state=None):
    """Phase 30's work in one rank of a world of ``world`` on the card:
    ``parts`` of "seg", "predict", "vae", "ens", "dkl", each on an
    explicit mesh of the whole world (data (world, 1), model (1, world)),
    rank 0 holding it against ``mesh=False`` in its process, and
    "dryrun", the dryrun's four paths on their meshes. ``net_state``: the
    Unet "predict" serves when "seg" is not run."""
    import torch
    from atomai_tpu_torch.core.mesh import get_mesh
    from atomai_tpu_torch.nets import init_fcnn_model
    from atomai_tpu_torch.parallel.dryrun import paths
    device = torch.device("cuda", torch.cuda.current_device())
    data_mesh = get_mesh(n_data=world, n_model=1)
    model_mesh = get_mesh(n_data=1, n_model=world)
    plain = rank == 0
    out = {"rank": rank, "device": str(device)}
    net = None
    with tempfile.TemporaryDirectory() as tmp, quiet():
        if "seg" in parts:
            meshed, out["seg"] = _mesh_seg(device, data_mesh, tmp, plain)
            net = meshed.net
        if "predict" in parts:
            if net is None:
                net = init_fcnn_model("Unet", 1)[0]
                net.load_state_dict(net_state)
                net.to(device).eval()
            out["predict"] = _mesh_predict(device, net, data_mesh)
        if "vae" in parts:
            out["vae"] = _mesh_rvae(device, data_mesh, tmp, plain)
        if "ens" in parts:
            out["ens"] = _mesh_ensemble(device, model_mesh, tmp, plain)
        if "dkl" in parts:
            out["dkl"] = _mesh_dkl(device, model_mesh, plain)
    if "dryrun" in parts:
        out["dryrun"] = paths(world, "cuda")
    return out


def _ranks_agree(ranks):
    """Every rank ended with rank 0's model on each path: the same losses
    and ELBOs, Unet weights and statistics, and ensemble members."""
    import torch
    r0 = ranks[0]
    for r in ranks[1:]:
        check(r["seg"]["loss"] == r0["seg"]["loss"] and
              r["seg"]["step_loss"] == r0["seg"]["step_loss"] and
              all(torch.equal(v, r0["seg"]["state"][k])
                  for k, v in r["seg"]["state"].items()),
              f"rank {r['rank']}'s config A fit differs from rank 0's")
        check(r["vae"]["mesh"]["elbo"] == r0["vae"]["mesh"]["elbo"],
              f"rank {r['rank']}'s ELBOs differ from rank 0's")
        for layout in ("map", "vmap"):
            got, want = r["ens"][layout], r0["ens"][layout]
            check(got["loss"] == want["loss"] and
                  all(torch.equal(v, want["members"][i][k])
                      for i, s in got["members"].items()
                      for k, v in s.items()),
                  f"rank {r['rank']}'s {layout} members differ from rank "
                  "0's")
        check(r["dkl"]["loss"] == r0["dkl"]["loss"],
              f"rank {r['rank']}'s DKL losses differ from rank 0's")
        check(r["dryrun"] == r0["dryrun"],
              f"rank {r['rank']}'s dryrun differs from rank 0's")
    for r in ranks:
        del r["seg"]["state"], r["ens"]["map"]["members"], \
            r["ens"]["vmap"]["members"]


def phase_mesh_path(device):
    """The device mesh on the card (``core.mesh``, ``parallel``): ranks
    started by ``parallel.launch`` run the production paths on explicit
    meshes. World 2 with both ranks on the one card over gloo (NCCL
    refuses two ranks on one card: "Duplicate GPU detected"): configs A,
    C, D, E at full width and both sharded predictors, rank 0 holding
    each against ``mesh=False``, every rank holding rank 0's model at the
    end, and the dryrun's four paths held against one process; each
    rank's spatial-MLP kernels held against their plain versions on its
    rows. World 1 on NCCL: the sharded predict and the rVAE, to check
    that NCCL and the rank's card start up. Where the host has several
    cards, the dryrun at that world size on NCCL. Launches of the
    labeller and the spatial-MLP kernels a rank."""
    import torch
    from atomai_tpu_torch.parallel import launch
    from atomai_tpu_torch.parallel.dryrun import dryrun_multichip, paths
    t0 = time.perf_counter()
    two = launch(mesh_path_rank, 2, "cuda", backend="gloo",
                 args=(2, ("seg", "predict", "vae", "ens", "dkl", "dryrun")),
                 timeout=MESH_COLLECTIVE_S, deadline=MESH_LAUNCH_S)
    world2_s = time.perf_counter() - t0
    net_state = two[0]["seg"]["state"]
    _ranks_agree(two)
    dry = two[0]["dryrun"]
    ref = paths(2, "cuda", mesh=False)
    dry_rel = {k: [float(abs(dry[k][0] / ref[k][0] - 1)),
                   float(np.abs(np.asarray(dry[k]) / np.asarray(ref[k]) - 1)
                         .max())] for k in TOL_MESH_DRYRUN_REL}
    for k, (first, every) in TOL_MESH_DRYRUN_REL.items():
        check(dry_rel[k][0] <= first and dry_rel[k][1] <= every,
              f"dryrun {k} at world 2 {dry_rel[k]} off one process's")
    t0 = time.perf_counter()
    (one,) = launch(mesh_path_rank, 1, "cuda", args=(1, ("predict", "vae"),
                                                     net_state),
                    timeout=MESH_COLLECTIVE_S, deadline=MESH_LAUNCH_S)
    world1_s = time.perf_counter() - t0
    nccl = None
    count = torch.cuda.device_count()
    if count > 1:
        with quiet():
            nccl = dryrun_multichip(count, "cuda", deadline=MESH_LAUNCH_S)
    emit("mesh_path", world2_gloo_one_card=two, world1=one,
         dryrun_world2=dry, dryrun_one_process=ref, dryrun_rel=dry_rel,
         dryrun_nccl=nccl, world1_s=world1_s, world2_s=world2_s,
         busy_share_world2_seg=sum(r["seg"]["busy_share"] for r in two),
         cycles={"seg": MESH_SEG_CYCLES, "vae_epochs": MESH_VAE_EPOCHS,
                 "ens": MESH_ENS_CYCLES, "dkl": MESH_DKL_CYCLES},
         tolerances={"maps": TOL_MESH_MAPS, "members": TOL_MESH_MEMBERS,
                     "dkl_loss_rel": TOL_MESH_DKL_REL,
                     "elbo_rel": TOL_REMAT_ELBO_REL,
                     "mlp_scaled": TOL_MLP_SCALED,
                     "seg_step": TOL_MESH_SEG_STEP,
                     "dryrun": TOL_MESH_DRYRUN_REL,
                     "noise_factor": REMAT_NOISE_FACTOR})
    ranks = two + [one]
    lab = {"launches_per_rank": [r["predict"]["labeller_launches"]
                                 for r in ranks],
           "world_sizes": [2, 2, 1],
           "max_abs_err": max(r["predict"]["labeller"]["max_abs_err"]
                              for r in ranks),
           "blobs": two[0]["predict"]["labeller"]["blobs"]}
    mlp = [{"launches_per_rank": [r["vae"]["mesh"]["launches"][i]
                                  for r in ranks],
            "steps_per_rank": [r["vae"]["steps"] for r in ranks],
            "rows_a_rank": [r["vae"]["rows_a_rank"] for r in ranks],
            "world_sizes": [2, 2, 1],
            "max_abs_err": max(r["vae"]["kernels"][key] for r in ranks),
            "scaled_err": max(v for r in ranks for n, v in
                              r["vae"]["kernels"]["scaled_err"].items()
                              if n in names)}
           for i, (key, names) in enumerate((
               ("max_abs_err_fwd", ["y"]),
               ("max_abs_err_bwd", MLP_NAMES)))]
    return lab, mlp[0], mlp[1]

def _ens_diff(a, b):
    """How far two config D fits ((trainer, net, members)) are apart: the
    members' mean losses of each cycle (relative), their weights
    (absolute) and running statistics (of their scale)."""
    la, lb = (np.asarray(e[0].loss_acc["train_loss"]) for e in (a, b))
    w, stats = 0.0, 0.0
    for i, sb in b[2].items():
        for k, v in sb.items():
            d = float((a[2][i][k].float() - v.float()).abs().max())
            if ".running_" in k:
                stats = max(stats, d / float(v.abs().max()))
            elif v.is_floating_point():
                w = max(w, d)
    return {"loss_rel": float(np.abs(la / lb - 1).max()), "abs": w,
            "stats_rel": stats}


def autocast_in_vmap_dtypes(device):
    """{op: (dtype under autocast, dtype vmapped under autocast with
    ``autocast_in_vmap``)} for ops of each of autocast's lists on the card
    (lower precision, float32, neither)."""
    import torch
    import torch.nn.functional as F
    from torch.func import vmap
    from atomai_tpu_torch.nets.functional_bn import autocast_in_vmap
    x = torch.randn(2, 3, 4, 8, 8, device=device)
    w = torch.randn(2, 5, 4, 3, 3, device=device)
    ops = {"conv2d": lambda a, b: F.conv2d(a, b, padding=1),
           "interpolate": lambda a, b: F.interpolate(
               F.conv2d(a, b), scale_factor=2, mode="bilinear"),
           "softmax": lambda a, b: torch.softmax(F.conv2d(a, b), 1),
           "leaky_relu": lambda a, b: F.leaky_relu(F.conv2d(a, b))}
    out = {}
    with torch.autocast(device.type, dtype=torch.bfloat16):
        for name, op in ops.items():
            with autocast_in_vmap():
                vmapped = vmap(op)(x, w).dtype
            out[name] = (str(op(x[0], w[0]).dtype), str(vmapped))
    return out


def phase_ensemble_vmap_path(device, basenet):
    """Config D with ``member_layout="vmap"`` held to the "map" loop,
    timed both ways, then served: ``basenet`` (phase 10's trained Unet) is
    the baseline the served members are fine-tuned from."""
    import torch
    from scipy.spatial import cKDTree
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.predictors import EnsemblePredictor, ensemble_locate
    from atomai_tpu_torch.trainers import EnsembleTrainer
    from atomai_tpu_torch.transforms import seg_augmentor
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs, masks, true_xy = make_lattice_stack(**ENS_DATA)
    n, size = ENS_DATA["n_images"], ENS_DATA["size"]
    aug = seg_augmentor(1, **AUG)
    dtypes = autocast_in_vmap_dtypes(device)
    check(all(a == b for a, b in dtypes.values()),
          f"autocast inside the vmap differs from autocast: {dtypes}")
    out = {"frames": list(imgs.shape), "members": ENS_MODELS,
           "cycles": ENS_CYCLES, "batch": ENS_BATCH,
           "autocast_dtypes": dtypes}
    with tempfile.TemporaryDirectory() as tmp, quiet():
        def fit(layout, cycles=ENS_CYCLES, f32=False, measure=None,
                augment_fn=aug):
            """(trainer, net, members) of a config D fit from scratch;
            with ``measure`` (a dict), its seconds, images/s and peak
            bytes above the resting allocation go there."""
            et = EnsembleTrainer("Unet", 1, device=device)
            if f32:
                et.precision = Precision.full()
            et.compile_ensemble_trainer(
                training_cycles=cycles, batch_size=ENS_BATCH, swa=not f32,
                member_layout=layout, filename=os.path.join(tmp, layout))
            run = lambda: et.train_ensemble_from_scratch(   # noqa: E731
                imgs, masks, n_models=ENS_MODELS,
                augment_fn=None if f32 else augment_fn)
            if measure is None:
                return (et,) + run()
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            seconds, (net, ens) = timed_result(run, device)
            measure.update(
                seconds=seconds,
                images_per_s=cycles * ENS_BATCH * ENS_MODELS / seconds,
                fit_peak_bytes_above_resting=torch.cuda.max_memory_allocated(
                    device) - base)
            return et, net, ens

        # one float32 cycle: a priori bounds against every "map" run
        f32_plains = [fit("map", 1, f32=True) for _ in range(SPREAD_FITS)]
        out["f32_one_cycle"] = hold_to_spread(
            "config D's vmap layout, one float32 cycle",
            fit("vmap", 1, f32=True), f32_plains, _ens_diff,
            TOL_ENS_VMAP_F32, ())
        # 30 bf16 cycles with the augmentation (the second run of each
        # layout warm, and timed), then the card's busy share over 10
        # cycles of each
        speed = {"map": {}, "vmap": {}}
        plains = [fit("map", augment_fn=frames_reordered(aug, 0)),
                  fit("map", measure=speed["map"]),
                  fit("map", augment_fn=frames_reordered(
                      aug, ENS_BATCH // 2))]
        vmapped = fit("vmap")
        fit("vmap", measure=speed["vmap"])
        for layout, measured in speed.items():
            measured["busy_share_10_cycles"] = busy_share(
                lambda: fit(layout, BUSY_CYCLES), device)
        out["bf16_30_cycles"] = hold_to_spread(
            "config D's vmap layout, 30 bf16 cycles", vmapped, plains,
            _ens_diff, TOL_ENS_VMAP_BF16, TOL_ENS_VMAP_BF16)
        out["speed"] = speed
        out["loss_first_last"] = [vmapped[0].loss_acc["train_loss"][i]
                                  for i in (0, -1)]
        # served: members fine-tuned from phase 10's net in the vmap layout
        et = EnsembleTrainer("Unet", 1, device=device)
        et.compile_ensemble_trainer(batch_size=ENS_BATCH, swa=True,
                                    member_layout="vmap",
                                    filename=os.path.join(tmp, "served"))
        net, ens = et.train_ensemble_from_baseline(
            imgs, masks, basemodel=basenet, n_models=ENS_MODELS,
            training_cycles_ensemble=ENS_CYCLES, augment_fn=aug)
    check(bool(np.isfinite(et.loss_acc["train_loss"]).all()),
          "non-finite losses of the vmap fine-tune")
    pred = EnsemblePredictor(net, ens, nb_classes=1, verbose=0)
    maps = torch.from_numpy(pred.ensemble_forward(
        pred.preprocess(imgs), num_batches=n)).to(device)
    check(bool(torch.isfinite(maps).all()) and tuple(maps.shape) ==
          (ENS_MODELS, n, size, size, 1), f"member maps {maps.shape}")
    zero_counters()
    c_mean, _ = ensemble_locate(maps, eps=ENS_EPS,
                                min_samples=ENS_MIN_SAMPLES)
    torch.cuda.synchronize(device)
    launches = counted("labeller.launches")
    check(launches == 1, f"ensemble_locate launched the labeller "
          f"{launches} times")
    errs, found = [], 0
    for i in range(n):
        found += len(c_mean[i])
        if len(c_mean[i]):
            errs.append(cKDTree(true_xy[i] + MASK_OFFSET).query(
                c_mean[i][:, :2])[0])
    lab = labeller_on(maps.reshape((-1,) + tuple(maps.shape[2:])), device)
    locate_ms = cuda_ms(lambda: ensemble_locate(
        maps, eps=ENS_EPS, min_samples=ENS_MIN_SAMPLES), 3, device)
    out.update(tolerances={"f32": TOL_ENS_VMAP_F32,
                           "bf16": TOL_ENS_VMAP_BF16,
                           "noise_factor": REMAT_NOISE_FACTOR},
               served={"loss_first_last": [et.loss_acc["train_loss"][i]
                                           for i in (0, -1)],
                       "member_maps": list(maps.shape), "launches": launches,
                       "clusters": found, "median_err_px": float(np.median(
                           np.concatenate(errs))) if errs else None,
                       "locate_ms": locate_ms, "labeller": lab})
    emit("ensemble_vmap_path", **out)
    return {"launches": launches, "ms": lab["kernel_ms"],
            "plain_ms": lab["kernel_plain_ms"], "bound_ms": lab["bound_ms"],
            "bound_by": lab["bound_by"],
            "share_of_bound": lab["share_of_bound"],
            "max_abs_err": lab["max_abs_err"], "blobs": lab["blobs"],
            "tiled_mask": lab["tiled_mask"], "locate_ms": locate_ms}


@contextlib.contextmanager
def predictor_graphs(max_pixels):
    """``EnsemblePredictor``'s graph rule with another size limit (0: every
    chunk eager) for the enclosed code."""
    from atomai_tpu_torch.predictors import epredictor
    saved, epredictor.GRAPH_MAX_PIXELS = epredictor.GRAPH_MAX_PIXELS, \
        max_pixels
    try:
        yield
    finally:
        epredictor.GRAPH_MAX_PIXELS = saved


def graph_predictor(device, layout="map"):
    """Config D's predictor: 4 default Unets from seeds 0-3."""
    import torch
    from atomai_tpu_torch.nets import Unet
    from atomai_tpu_torch.predictors import EnsemblePredictor
    members = {}
    for k in range(ENS_MODELS):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(k)
            members[k] = Unet(nb_classes=1).state_dict()
    skeleton = Unet(nb_classes=1).to(device)
    return EnsemblePredictor(skeleton, members, nb_classes=1, verbose=0,
                             member_layout=layout)


def graphed_member_outputs(p, x, calls=4):
    """Whether each of ``calls`` calls of ``p._member_outputs(x)`` (the
    signature's eager sighting, its capture, then replays) equals the
    eager forward bit for bit, and the counters of those calls."""
    import torch
    with torch.inference_mode():
        want = p._forward(x)
        zero_counters()
        got = [p._member_outputs(x) for _ in range(calls)]
    return (all(torch.equal(g, want) for g in got),
            counted("predictor.eager_forward", "predictor.graph_capture",
                    "predictor.graph_replay"))


def replay_memory(p, x, device, calls=ENS_GRAPH_CALLS):
    """The card's reserved bytes and allocations (``cudaMalloc`` /
    ``cudaFree``) over ``calls`` replays of an already captured chunk."""
    import torch

    def reading():
        torch.cuda.synchronize(device)
        ms = torch.cuda.memory_stats(device)
        return (torch.cuda.memory_reserved(device),
                ms.get("num_device_alloc", ms["segment.all.allocated"]),
                ms.get("num_device_free", ms["segment.all.freed"]))
    with torch.inference_mode():
        p._member_outputs(x)
        before = reading()
        for _ in range(calls):
            p._member_outputs(x)
        after = reading()
    return {"reserved_before": before[0], "reserved_after": after[0],
            "device_allocs": after[1] - before[1],
            "device_frees": after[2] - before[2]}


def graph_sweep(p, frames, device):
    """For each chunk of ``ENS_GRAPH_SWEEP`` frames: the host's ms issuing
    the eager forward (median of 5, the card idle at each start), the
    card's ms running it (queued behind a sleep kernel), the eager chunk's
    ms by CUDA events, and the graphed chunk's (every size graphed)."""
    import torch
    rows = {}
    for n in ENS_GRAPH_SWEEP:
        x = p.preprocess(frames[:n])
        with torch.inference_mode(), predictor_graphs(max_pixels=1 << 62):
            host = []
            for _ in range(5):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                p._forward(x)
                host.append((time.perf_counter() - t0) * 1e3)
            dev = [device_ms(lambda: p._forward(x), 1, device)
                   for _ in range(3)]
            eager = cuda_ms(lambda: p._forward(x), 5, device)
            reserved = torch.cuda.memory_reserved(device)
            p._member_outputs(x)
            p._member_outputs(x)
            torch.cuda.synchronize(device)
            pool = torch.cuda.memory_reserved(device) - reserved
            graphed = cuda_ms(lambda: p._member_outputs(x), 5, device)
        rows[n] = {"host_ms": float(np.median(host)),
                   "device_ms": float(np.median(dev)), "eager_ms": eager,
                   "graphed_ms": graphed, "graph_reserved_mb": pool / 2**20}
    return rows


def phase_ensemble_graph(device):
    from atomai_tpu_torch.predictors import epredictor
    from atomai_tpu_torch.utils import make_lattice_stack
    imgs = make_lattice_stack(**dict(ENS_DATA, n_images=max(
        ENS_GRAPH_SWEEP)))[0]
    out = {"max_pixels": epredictor.GRAPH_MAX_PIXELS}
    for n in ENS_GRAPH_FRAMES:
        frames = imgs[:n]
        p = graph_predictor(device)
        x = p.preprocess(frames)
        exact, counts = graphed_member_outputs(p, x)
        check(exact, f"graphed member outputs of {n} frames differ from "
              f"the eager forward")
        check(counts == (1, 1, 2), f"counters {counts}, not one eager "
              f"sighting, one capture, two replays")
        mem = replay_memory(p, x, device)
        check(mem["reserved_after"] == mem["reserved_before"]
              and mem["device_allocs"] == 0,
              f"replays of {n} frames allocate on the card: {mem}")
        with predictor_graphs(max_pixels=0):
            want = p.predict(frames), p.ensemble_forward(x)
        got = [(p.predict(frames), p.ensemble_forward(x)) for _ in range(3)]
        same = all(np.array_equal(g[0][0], want[0][0])
                   and np.array_equal(g[0][1], want[0][1])
                   and np.array_equal(g[1], want[1]) for g in got)
        check(same, f"graphed predict or ensemble_forward of {n} frames "
              f"differs from the eager one")
        vmap_exact, vmap_counts = graphed_member_outputs(
            graph_predictor(device, "vmap"), x)
        check(vmap_exact and vmap_counts == (1, 1, 2),
              f"the vmap layout's graph of {n} frames differs from its "
              f"eager forward, or counted {vmap_counts}")
        out[n] = {"member_outputs_exact": exact, "counters": counts,
                  "memory": mem, "predict_exact": same,
                  "vmap_exact": vmap_exact, "vmap_counters": vmap_counts}
    sweep = graph_sweep(graph_predictor(device), imgs, device)
    host_bound = [n for n, r in sweep.items()
                  if r["host_ms"] > r["device_ms"]]
    emit("ensemble_graph", **{str(k): v for k, v in out.items()},
         sweep=sweep, host_bound_frames=host_bound)


def spd_problem(n, b, device, seed, noise=0.05):
    """(K, r, g_q, g_h) of phase 33, float64 on the card."""
    import torch
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(b, n, 2, generator=g, dtype=torch.float64) * 2 - 1
    K = torch.exp(-2.0 * ((X[:, :, None] - X[:, None]) ** 2).sum(-1)) \
        + noise * torch.eye(n, dtype=torch.float64)
    r = torch.randn(b, n, generator=g, dtype=torch.float64)
    gq, gh = torch.rand(2, b, generator=g, dtype=torch.float64) + 0.5
    return tuple(t.to(device) for t in (K, r, gq, gh))


def library_mll_grads(K, r, gq, gh):
    """(q, h, dK, dr) of the library route: ``gptrainer``'s factor and
    solve under autograd, as ``neg_mll`` takes them above the limit."""
    import torch
    from atomai_tpu_torch.trainers.gptrainer import _cholesky, _tri
    K = K.detach().requires_grad_()
    r = r.detach().requires_grad_()
    L = _cholesky(K)
    v = _tri(L, r[..., None])[..., 0]
    q = (v * v).sum(-1)
    h = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    (gq * q + gh * h).sum().backward()
    return q.detach(), h.detach(), 0.5 * (K.grad + K.grad.mT), r.grad


def kernel_mll_grads(K, r, gq, gh):
    from atomai_tpu_torch.ops import spd_mll
    q, h, _, W = spd_mll.mll_forward_cuda(K, r)
    return (q, h) + spd_mll.mll_backward_cuda(W, K.shape[-1], gq, gh)


def plain_mll_grads(K, r, gq, gh):
    from atomai_tpu_torch.ops import spd_mll
    q, h, _, W = spd_mll.mll_factor_reference(K, r)
    return (q, h) + spd_mll.mll_grad_reference(W, K.shape[-1], gq, gh)


def spd_gap(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


def spd_check(n, b, device, seed):
    """The kernels, the float32 plain version and the library route of one
    case against the float64 plain version; the gates of phase 33."""
    import torch
    K, r, gq, gh = spd_problem(n, b, device, seed)
    exact = plain_mll_grads(K, r, gq, gh)
    f32 = [t.float() for t in (K, r, gq, gh)]
    runs = {"kernel": kernel_mll_grads(*f32), "plain": plain_mll_grads(*f32),
            "library": library_mll_grads(*f32)}
    names = ("q", "h", "dK", "dr")
    out = {"n": n, "b": b}
    for name, got in runs.items():
        out[name] = {k: spd_gap(x, y) for k, x, y in zip(names, got, exact)}
    for other in ("plain", "library"):
        out[f"kernel_to_{other}"] = {
            k: spd_gap(x, y) for k, x, y in zip(names, runs["kernel"],
                                                runs[other])}
    for k in names:
        bound = SPD_FACTOR * max(out["library"][k], out["plain"][k]) \
            + SPD_FLOOR
        check(out["kernel"][k] <= bound and out["kernel_to_plain"][k] <= bound
              and out["kernel_to_library"][k] <= bound + out["library"][k],
              f"spd_mll kernels at n={n}, b={b}, {k}: {out}")
    dK = runs["kernel"][2]
    check(torch.equal(dK, dK.mT), f"spd_mll dK not symmetric at n={n}")
    return out


def spd_nan_check(device):
    """One output of three has a negative pivot: NaN in its q, h, dK and
    dr on the kernels where the library route gives NaN, finite
    elsewhere."""
    import torch
    K, r, gq, gh = (t.float() for t in spd_problem(70, 3, device, 7))
    K[1, 40, 40] = -1.0
    got = kernel_mll_grads(K, r, gq, gh)
    want = library_mll_grads(K, r, gq, gh)
    for x, y in zip(got, want):
        nan_x = torch.isnan(x.reshape(3, -1)).any(-1)
        check(torch.equal(nan_x, torch.isnan(y.reshape(3, -1)).any(-1))
              and nan_x.tolist() == [False, True, False],
              f"spd_mll NaN: {nan_x.tolist()}")
    return True


def spd_concurrent_check(device, n=1024, calls=SPD_CONCURRENT_CALLS):
    """Forwards of two problems queued on two streams at once, each grid
    a block an SM (its launch is cooperative, so a grid starts only once
    all its blocks can be resident): each stream's outputs equal the same
    problem's forward alone, bit for bit."""
    import torch
    from atomai_tpu_torch.ops import spd_mll
    problems = [tuple(t.float() for t in spd_problem(n, 1, device, seed)[:2])
                for seed in (11, 12)]
    alone = [spd_mll.mll_forward_cuda(K, r) for K, r in problems]
    streams = [torch.cuda.Stream(device) for _ in problems]
    main = torch.cuda.current_stream(device)
    runs = [[] for _ in problems]
    for s in streams:
        s.wait_stream(main)
    for _ in range(calls):
        for (K, r), s, out in zip(problems, streams, runs):
            with torch.cuda.stream(s):
                out.append(spd_mll.mll_forward_cuda(K, r))
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize(device)
    ok = all(torch.equal(x, y) for want, out in zip(alone, runs)
             for got in out for x, y in zip(got, want))
    check(ok, "spd_mll forwards on two streams differ from one alone")
    return ok


def spd_route_times(n, b, device, reps=20):
    """Device ms of the forward and the backward kernel and of the library
    route (forward and backward) at dkl64-like conditioning (phase 33's K
    with 1e-3 on the diagonal), b outputs; with the problem."""
    from atomai_tpu_torch.ops import spd_mll
    K, r, gq, gh = (t.float() for t in spd_problem(n, b, device, 3, 1e-3))
    W = spd_mll.mll_forward_cuda(K, r)[3]
    out = {"n": n, "b": b,
           "forward_ms": device_ms(lambda: spd_mll.mll_forward_cuda(K, r),
                                   reps, device),
           "backward_ms": device_ms(
               lambda: spd_mll.mll_backward_cuda(W, n, gq, gh), reps, device),
           "library_ms": device_ms(lambda: library_mll_grads(K, r, gq, gh),
                                   reps, device)}
    out["pair_ms"] = out["forward_ms"] + out["backward_ms"]
    return out, (K, r, gq, gh)


def spd_times(n, device):
    """Both routes' device ms (``spd_route_times``, one output) beside the
    kernels' bounds, the plain version's and ``torch.cholesky_inverse``'s."""
    import torch
    from atomai_tpu_torch.ops import spd_mll
    out, (K, r, gq, gh) = spd_route_times(n, 1, device)
    fwd_flops, bwd_flops = spd_mll.mll_flops(n)
    out.update(
        tile=spd_mll.MLL_TILE,
        forward_flop_bound_ms=1e3 * fwd_flops / 67e12,
        backward_flop_bound_ms=1e3 * bwd_flops / 67e12,
        forward_pivot_chain_ms=1e3 * spd_mll.padded_size(n)
        * SPD_PIVOT_CYCLES / SM_HZ,
        plain_ms=device_ms(lambda: plain_mll_grads(K, r, gq, gh), 3, device),
        cholesky_inverse_ms=device_ms(
            lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(K)[0]),
            20, device))
    return out


def spd_sweep(device):
    """Both routes over ``SPD_SWEEP`` at each of ``SPD_SWEEP_B`` outputs;
    per b, the largest N up to which the kernels' pair is faster than the
    library route at every swept size."""
    import torch
    rows, wins_to = [], {}
    for b in SPD_SWEEP_B:
        wins, wins_to[b] = True, 0
        for n in SPD_SWEEP:
            row = spd_route_times(n, b, device, reps=10)[0]
            rows.append(row)
            wins = wins and row["pair_ms"] < row["library_ms"]
            if wins:
                wins_to[b] = n
            torch.cuda.empty_cache()
    return rows, wins_to


def phase_spd_mll(device):
    """The exact MLL's kernel pair against the plain version and the
    library route, NaN where the factor fails, forwards on two streams at
    once, a graphed dklGPR fit on each route bit for bit its eager steps,
    the counters, times and the routes' sweep."""
    import torch
    from atomai_tpu_torch.ops import spd_mll
    from atomai_tpu_torch.trainers import gptrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    sizes = sorted(set(SPD_SIZES) | {spd_mll.MLL_KERNEL_MAX_N})
    cases = [spd_check(n, b, device, 100 * n + b) for n in sizes
             for b in (1, 3)]
    nan_ok = spd_nan_check(device)
    concurrent_ok = spd_concurrent_check(device)
    rng = np.random.RandomState(5)
    X = rng.randn(SPD_GRAPH_N, GP_DIM).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.randn(SPD_GRAPH_N)).astype(np.float32)
    names = ("gp.mll_kernel", "gp.mll_library", "spd_mll.forward_launches",
             "spd_mll.backward_launches")
    cycles = GP_FIRST + GP_WARM
    # the graphed fit's eager steps and its capture, then the eager fit's
    launches = gptrainer.GRAPH_WARMUP + 1 + cycles
    graph_equal, counts = {}, {}
    for route, limit, want in (
            ("kernel", spd_mll.MLL_KERNEL_MAX_N,
             (2 * cycles, 0, launches, launches)),
            ("library", 0, (0, 2 * cycles, 0, 0))):
        saved, spd_mll.MLL_KERNEL_MAX_N = spd_mll.MLL_KERNEL_MAX_N, limit
        try:
            zero_counters()
            graph_equal[route] = graphed_fit_is_eager(X, y, device)
            counts[route] = dict(zip(names, counted(*names)))
        finally:
            spd_mll.MLL_KERNEL_MAX_N = saved
        check(graph_equal[route], f"a graphed fit on the {route} route "
              "differs from its eager steps")
        check(counts[route] == dict(zip(names, want)),
              f"spd_mll counters, {route} route: {counts[route]}")
    times = [spd_times(n, device) for n in SPD_TIMED]
    sweep, wins_to = spd_sweep(device)
    emit("spd_mll", tile=spd_mll.MLL_TILE,
         max_n=spd_mll.MLL_KERNEL_MAX_N, cases=cases, nan_ok=nan_ok,
         concurrent_ok=concurrent_ok, graphed_fit_equal=graph_equal, graph_n=SPD_GRAPH_N,
         counters=counts, times=times, sweep=sweep,
         kernels_win_to=wins_to,
         gate={"factor": SPD_FACTOR, "floor": SPD_FLOOR})
    return times


# vae_graph: the benchmark's rvae48.fit shapes (AtomAI's widths, 48² windows
# around the atoms of a 2048² frame, batch 100). A graphed epoch replays
# the eager steps' kernels in the same order on the same inputs: bit for
# bit expected, gated at float32 rounding of the ELBO and a hundredth of
# Adam's step (lr 1e-4) on any weight
VAE_GRAPH_FRAME = dict(n_images=1, size=2048, spacing=16, seed=11)
VAE_GRAPH_WINDOW = 48
VAE_GRAPH_BATCH = 100
VAE_GRAPH_EPOCHS = 2
TOL_VAE_GRAPH = {"elbo_rel": 1e-6, "weights_abs": 1e-6}


def rvae48_windows():
    """The 48² windows around the atoms of one 2048² lattice frame (the
    port's ``extract_subimages``), as the benchmark's cell makes them."""
    from atomai_tpu_torch.utils import extract_subimages, make_lattice_stack
    imgs, _, xy = make_lattice_stack(**VAE_GRAPH_FRAME)
    return extract_subimages(imgs[0], xy[0], VAE_GRAPH_WINDOW)[0][..., 0]


def phase_vae_graph(device):
    """Two rVAE epochs on the graphed route against the same two epochs
    all eager, the counters, both routes' epoch times, and the kernels at
    these shapes."""
    import torch
    from atomai_tpu_torch.models import rVAE
    from atomai_tpu_torch.ops import roofline
    from atomai_tpu_torch.ops import spatial_mlp as sm
    from atomai_tpu_torch.trainers import vitrainer
    X = rvae48_windows()
    steps = len(X) // VAE_GRAPH_BATCH
    total = VAE_GRAPH_EPOCHS * steps
    names = ("vae.eager_step", "vae.graph_capture", "vae.graph_replay")

    def epochs(warmup):
        m = rVAE((VAE_GRAPH_WINDOW,) * 2, latent_dim=2, seed=5,
                 device=device)
        m.dx_prior = 0.1
        m.kdict_["phi_prior"] = np.pi / 2
        m.compile_trainer((X, None), training_cycles=VAE_GRAPH_EPOCHS,
                          batch_size=VAE_GRAPH_BATCH)
        check(m._graphed(), "the rVAE's fit does not take the graphed route")
        saved, vitrainer.GRAPH_WARMUP = vitrainer.GRAPH_WARMUP, warmup
        try:
            zero_counters()
            runs = [timed_result(m.train_epoch_lazy, device)
                    for _ in range(VAE_GRAPH_EPOCHS)]
        finally:
            vitrainer.GRAPH_WARMUP = saved
        return m, [float(e) for _, e in runs], [t for t, _ in runs], \
            counted(*names)

    g, g_elbo, g_s, g_counts = epochs(vitrainer.GRAPH_WARMUP)
    e, e_elbo, e_s, e_counts = epochs(10 ** 9)
    w = vitrainer.GRAPH_WARMUP
    check(g_counts == (w, 1, total - w - 1), f"graphed counters {g_counts}")
    check(e_counts == (total, 0, 0), f"eager counters {e_counts}")
    elbo_rel = max(abs(a / b - 1) for a, b in zip(g_elbo, e_elbo))
    weights_abs = max(float((p.detach() - q.detach()).abs().max())
                      for p, q in zip(g.parameters(), e.parameters()))
    bitwise = g_elbo == e_elbo and all(
        torch.equal(p, q) for p, q in zip(g.parameters(), e.parameters()))
    check(elbo_rel <= TOL_VAE_GRAPH["elbo_rel"] and weights_abs <=
          TOL_VAE_GRAPH["weights_abs"], f"graphed epochs off the eager "
          f"ones: ELBO {elbo_rel}, weights {weights_abs}")

    # the kernels at these shapes, on the fitted model's decoder inputs
    x = torch.from_numpy(X[:VAE_GRAPH_BATCH]).to(device)
    args = decoder_args(g, x, device)
    gy = torch.randn((VAE_GRAPH_BATCH, 1, VAE_GRAPH_WINDOW ** 2),
                     generator=torch.Generator(device).manual_seed(0),
                     device=device) * 1e-2
    fwd_ms, fwd_plain_ms, bwd_ms, bwd_plain_ms, y_err = mlp_kernel_ms(
        args, gy, device)
    pipelined = check_pipelined(args, gy)
    dims = (VAE_GRAPH_BATCH, VAE_GRAPH_WINDOW ** 2, args[2].shape[1],
            args[4].shape[0])
    flops = sm.spatial_mlp_flops(*dims)
    bounds = [roofline.bound(f, b)
              for f, b in zip(flops, sm.spatial_mlp_bytes(*dims))]
    emit("vae_graph", windows=list(X.shape), batch=VAE_GRAPH_BATCH,
         steps_per_epoch=steps, elbo_graphed=g_elbo, elbo_eager=e_elbo,
         elbo_rel=elbo_rel, weights_abs=weights_abs, bitwise=bitwise,
         counters={"graphed": g_counts, "eager": e_counts},
         epoch_s={"graphed": g_s, "eager": e_s},
         fwd_kernel_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
         bwd_kernel_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
         fwd_bound_ms=bounds[0][0], bwd_bound_ms=bounds[1][0],
         fwd_share_of_bound=bounds[0][0] / fwd_ms,
         bwd_share_of_bound=bounds[1][0] / bwd_ms,
         flops={"fwd": flops[0], "bwd": flops[1]}, bwd_pipelined=pipelined,
         path_inputs_scaled_err=y_err, tolerance=TOL_VAE_GRAPH)
    rows = [{"shape": list(dims), "ms": ms, "plain_ms": plain,
             "bound_ms": b[0], "bound_by": b[1], "share_of_bound": b[0] / ms}
            for ms, plain, b in ((fwd_ms, fwd_plain_ms, bounds[0]),
                                 (bwd_ms, bwd_plain_ms, bounds[1]))]
    rows[1]["pipelined"] = pipelined
    return rows


JRVAE_GRAPH_KW = dict(latent_dim=2, discrete_dim=[2], skip=True)
JRVAE_GRAPH_FIT = dict(temperature=0.67, cont_capacity=[5.0, 25000, 30],
                       disc_capacity=[5.0, 25000, 30])
MLP_SKIP = ("spatial_mlp.skip_forward_launches",
            "spatial_mlp.skip_backward_launches")


def phase_jrvae_graph(device):
    """The skip kernels against their plain version, then two jrVAE (skip
    decoder) epochs on the graphed route against the same two epochs all
    eager, the counters, and the skip kernels timed at these shapes."""
    import torch
    from atomai_tpu_torch.core import Precision
    from atomai_tpu_torch.models import jrVAE
    from atomai_tpu_torch.ops import roofline
    from atomai_tpu_torch.ops import spatial_mlp as sm
    from atomai_tpu_torch.trainers import vitrainer
    rows = []
    for i, (B, n, H, L) in enumerate(MLP_SHAPES):
        args, gy = mlp_inputs(B, n, H, L, 200 + i, device)
        zero_counters()
        with Precision.full().scope(device):
            y = sm.spatial_mlp_forward_cuda(*args, skip=True)
            grads = sm.spatial_mlp_backward_cuda(*args, gy, skip=True)
            again = sm.spatial_mlp_backward_cuda(*args, gy, skip=True)
            torch.cuda.synchronize(device)
            y_ref = sm.spatial_mlp_reference(*args, skip=True)
            g_ref = sm.spatial_mlp_backward_reference(*args, gy, skip=True)
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"skip spatial_mlp {(B, n, H, L)}: two backward runs differ")
        check(counted(*MLP_SKIP) == (1, 2), f"skip spatial_mlp "
              f"{(B, n, H, L)}: launches {counted(*MLP_SKIP)}")
        errs = {"y": scaled_err(y, y_ref)}
        errs.update({name: scaled_err(a, b) for name, a, b in
                     zip(MLP_NAMES, grads, g_ref) if b.numel()})
        worst = max(errs, key=errs.get)
        check(errs[worst] <= TOL_MLP_SCALED, f"skip spatial_mlp "
              f"{(B, n, H, L)}: {worst} off by {errs[worst]} of its scale")
        rows.append({"shape": [B, n, H, L], "worst": worst,
                     "scaled_err": errs[worst]})

    X = rvae48_windows()
    steps = len(X) // VAE_GRAPH_BATCH
    total = VAE_GRAPH_EPOCHS * steps
    names = ("vae.eager_step", "vae.graph_capture", "vae.graph_replay",
             "vae.decoder_fused_step")

    def epochs(warmup):
        m = jrVAE((VAE_GRAPH_WINDOW,) * 2, seed=5, device=device,
                  **JRVAE_GRAPH_KW)
        m.dx_prior = 0.1
        m.kdict_.update(phi_prior=np.pi / 2, **JRVAE_GRAPH_FIT)
        m.compile_trainer((X, None), training_cycles=VAE_GRAPH_EPOCHS,
                          batch_size=VAE_GRAPH_BATCH)
        check(m._graphed() and m.decoder_net.fused(), "the jrVAE's fit "
              "does not take the graphed route and the skip kernels")
        saved, vitrainer.GRAPH_WARMUP = vitrainer.GRAPH_WARMUP, warmup
        try:
            zero_counters()
            runs = [timed_result(m.train_epoch_lazy, device)
                    for _ in range(VAE_GRAPH_EPOCHS)]
        finally:
            vitrainer.GRAPH_WARMUP = saved
        return m, [float(e) for _, e in runs], [t for t, _ in runs], \
            counted(*names)

    g, g_elbo, g_s, g_counts = epochs(vitrainer.GRAPH_WARMUP)
    e, e_elbo, e_s, e_counts = epochs(10 ** 9)
    w = vitrainer.GRAPH_WARMUP
    check(g_counts == (w, 1, total - w - 1, total),
          f"graphed counters {g_counts}")
    check(e_counts == (total, 0, 0, total), f"eager counters {e_counts}")
    elbo_rel = max(abs(a / b - 1) for a, b in zip(g_elbo, e_elbo))
    weights_abs = max(float((p.detach() - q.detach()).abs().max())
                      for p, q in zip(g.parameters(), e.parameters()))
    bitwise = g_elbo == e_elbo and all(
        torch.equal(p, q) for p, q in zip(g.parameters(), e.parameters()))
    check(elbo_rel <= TOL_VAE_GRAPH["elbo_rel"] and weights_abs <=
          TOL_VAE_GRAPH["weights_abs"], f"graphed jrVAE epochs off the "
          f"eager ones: ELBO {elbo_rel}, weights {weights_abs}")

    # the skip kernels at these shapes, on the fitted model's decoder
    # inputs (its discrete latents' softmax in place of their samples)
    x = torch.from_numpy(X[:VAE_GRAPH_BATCH]).to(device)
    args = decoder_args(g, x, device)
    gy = torch.randn((VAE_GRAPH_BATCH, 1, VAE_GRAPH_WINDOW ** 2),
                     generator=torch.Generator(device).manual_seed(0),
                     device=device) * 1e-2
    with Precision.full().scope(device):
        fwd_ms = device_ms(
            lambda: sm.spatial_mlp_forward_cuda(*args, skip=True), 50, device)
        bwd_ms = device_ms(
            lambda: sm.spatial_mlp_backward_cuda(*args, gy, skip=True), 50,
            device)
        y_err = scaled_err(sm.spatial_mlp_forward_cuda(*args, skip=True),
                           sm.spatial_mlp_reference(*args, skip=True))
    check(y_err <= TOL_MLP_SCALED, f"skip kernel off by {y_err} at the "
          "path's own decoder inputs")
    dims = (VAE_GRAPH_BATCH, VAE_GRAPH_WINDOW ** 2, args[2].shape[1],
            args[4].shape[0])
    bounds = [roofline.bound(f, b) for f, b in
              zip(sm.spatial_mlp_flops(*dims), sm.spatial_mlp_bytes(*dims))]
    emit("jrvae_graph", skip_cases=rows, tolerance_scaled=TOL_MLP_SCALED,
         windows=list(X.shape), steps_per_epoch=steps, elbo_graphed=g_elbo,
         elbo_eager=e_elbo, elbo_rel=elbo_rel, weights_abs=weights_abs,
         bitwise=bitwise, counters={"graphed": g_counts, "eager": e_counts},
         epoch_s={"graphed": g_s, "eager": e_s},
         skip_fwd_kernel_ms=fwd_ms, skip_bwd_kernel_ms=bwd_ms,
         fwd_share_of_bound=bounds[0][0] / fwd_ms,
         bwd_share_of_bound=bounds[1][0] / bwd_ms,
         path_inputs_scaled_err=y_err, tolerance=TOL_VAE_GRAPH)


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
    kernels[0]["trained_masks"], trained_net = phase_seg_path(device)
    phase_iou_protocol(device)
    phase_augment(device)
    phase_refine_fixture(device)
    phase_imspec_path(device)
    kernels[0]["ensemble_locate"] = phase_ensemble_path(device, trained_net)
    phase_gp_fixture(device)
    phase_dkl_path(device)
    phase_reconstruct(device)
    phase_zoo_fixture(device)
    kernels[0]["zoo_seg_path"] = phase_zoo_seg_path(device)
    phase_denoiser_path(device)
    phase_reg_cls_path(device)
    phase_jvae_fixture(device)
    for record, jrvae in zip(kernels[1:], phase_jvae_path(device, mlp_errs)):
        record["jrvae_path"] = jrvae
    phase_aoi_fixture(device)
    kernels[0]["served_from_jax"], kernels[1]["served_from_jax"] = \
        phase_served_from_jax(device)
    kernels[0]["stat_path"] = phase_stat_path(device, trained_net)
    kernels[0]["graph_path"] = phase_graph_path(device, trained_net)
    (kernels[0]["remat_path"], kernels[1]["remat_path"],
     kernels[2]["remat_path"]) = phase_remat_path(device)
    (kernels[0]["mesh_path"], kernels[1]["mesh_path"],
     kernels[2]["mesh_path"]) = phase_mesh_path(device)
    kernels[0]["ensemble_vmap_path"] = phase_ensemble_vmap_path(device,
                                                                trained_net)
    phase_ensemble_graph(device)
    phase_spd_mll(device)
    kernels[1]["vae_graph"], kernels[2]["vae_graph"] = \
        phase_vae_graph(device)
    phase_jrvae_graph(device)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
