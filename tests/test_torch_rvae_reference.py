"""The port's rVAE against the benchmark's plain reference
(``benchmark/reference/rvae.py``, imported by its path) at AtomAI's
published widths (encoder and spatial decoder 2 x 128 tanh, 2 + 3
latents) from seeded weights, on the CPU at 12² windows and batch 8: the
ELBO, every layer's gradient and one Adam step of the step the card's CUDA
graph replays (``viBaseTrainer._graph_step``). Then the fit loop: its
epoch method (``BaseVAE._fit_epochs``) gives the loss history, the
metrics log and the checkpoints of the loop as it was before the method
was split out; the VAE trainer's spans and counters; which models draw
their noise up front and may take the graphed route; and the import of
the port loads no JAX and no kernel library.

Stated tolerances: the ELBO 1e-5 relative and each layer's gradient 1e-4
relative L2 (the same float32 arithmetic in another order: the port sums
the decoder's pixels in one product, the reference layer by layer;
measured at most 3e-7 and 4e-6); Adam's step 1e-6 absolute on every
weight (a hundredth of the step lr = 1e-4: the step is lr * m / (sqrt(v)
+ 1e-8) of gradients that agree to 1e-4).
"""

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import atomai_tpu_torch as aoi
from atomai_tpu_torch.core import checkpoint, profiling
from atomai_tpu_torch.core.checkpoint import flush_async_checkpoints
from atomai_tpu_torch.core.mlog import open_metrics_log

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
IN_DIM, BATCH = (12, 12), 8
TOL_ELBO, TOL_GRAD, TOL_ADAM = 1e-5, 1e-4, 1e-6


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(BENCH, *rel.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("bench_reference_rvae", "reference/rvae.py")


def _adam_class():
    """``benchmark/weights.py``'s Adam (that module imports the reference
    package by name, so the benchmark's directory is on the path while it
    loads)."""
    sys.path.insert(0, BENCH)
    try:
        return _load("bench_weights", "weights.py").Adam
    finally:
        sys.path.remove(BENCH)


def _model(seed, rotation_prior, translation_prior=0.1):
    """A port rVAE on the CPU carrying the reference's seeded weights."""
    m = aoi.models.rVAE(IN_DIM, latent_dim=2, device="cpu")
    p = ref.init_params(IN_DIM, generator=torch.Generator().manual_seed(seed))
    for part, net in (("encoder", m.encoder_net), ("decoder", m.decoder_net)):
        net.load_state_dict({k.split(".", 1)[1]: v for k, v in p.items()
                             if k.startswith(part + ".")}, strict=True)
    m.dx_prior = translation_prior
    m.kdict_["phi_prior"] = rotation_prior
    return m, p


def _batch(seed):
    g = torch.Generator().manual_seed(seed + 100)
    return torch.rand((BATCH,) + IN_DIM, generator=g), \
        torch.randn(BATCH, 5, generator=g)


def _port_grads(m):
    return {f"{part}.{k}": q.grad.detach().clone() for part, net in
            (("encoder", m.encoder_net), ("decoder", m.decoder_net))
            for k, q in net.named_parameters()}


CASES = [(0, math.pi / 2, 0.1), (1, 0.1, 0.1), (2, math.pi / 2, 0.5)]


@pytest.mark.parametrize("seed,rotation_prior,translation_prior", CASES)
def test_elbo_and_gradients_match_the_reference(seed, rotation_prior,
                                                translation_prior):
    m, p = _model(seed, rotation_prior, translation_prior)
    x, eps = _batch(seed)
    m.optimizer = None
    m.encoder_net.zero_grad()
    m.decoder_net.zero_grad()
    with m.precision.scope(m.device):
        elbo = m.forward_compute_elbo(x, None, 0, eps=eps)
    (-elbo).backward()
    got = _port_grads(m)
    pr = {k: v.clone().requires_grad_() for k, v in p.items()}
    loss = ref.loss(pr, x, eps, ref.grid(IN_DIM), translation_prior,
                    rotation_prior)
    want = dict(zip(pr, torch.autograd.grad(loss, list(pr.values()))))
    assert abs(float(elbo.detach()) + float(loss)) <= \
        TOL_ELBO * abs(float(loss))
    assert set(got) == set(want)
    for layer in ref.layer_names():
        keys = [k for k in want if k.rsplit(".", 1)[0] == layer]
        g = torch.cat([got[k].reshape(-1) for k in keys])
        w = torch.cat([want[k].reshape(-1) for k in keys])
        assert float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) <= \
            TOL_GRAD, layer


@pytest.mark.parametrize("seed,rotation_prior,translation_prior", CASES)
def test_graph_step_is_the_references_adam_step(seed, rotation_prior,
                                                translation_prior):
    """The step the card's graph replays, run eagerly on the CPU: one Adam
    step from the same weights on the same batch and noise."""
    m, p = _model(seed, rotation_prior, translation_prior)
    x, eps = _batch(seed)
    m.compile_trainer((x.numpy(), None), training_cycles=1,
                      batch_size=BATCH)
    idx = torch.arange(BATCH)
    elbo = m._graph_step(idx, eps)
    pr = {k: v.clone().requires_grad_() for k, v in p.items()}
    loss = ref.loss(pr, x, eps, ref.grid(IN_DIM), translation_prior,
                    rotation_prior)
    grads = dict(zip(pr, torch.autograd.grad(loss, list(pr.values()))))
    _adam_class()(pr, lr=1e-4).step(grads)
    assert abs(float(elbo) + float(loss)) <= TOL_ELBO * abs(float(loss))
    for part, net in (("encoder", m.encoder_net), ("decoder", m.decoder_net)):
        for k, q in net.named_parameters():
            gap = float((q.detach() - pr[f"{part}.{k}"].detach()).abs().max())
            assert gap <= TOL_ADAM, (part, k, gap)


def test_reference_counts_the_published_parameters():
    cfg = json.load(open(os.path.join(BENCH, "configs", "rvae48.json")))
    p = ref.init_params(tuple(cfg["model"]["in_dim"]))
    m = aoi.models.rVAE(tuple(cfg["model"]["in_dim"]), latent_dim=2,
                        device="cpu")
    n = sum(v.numel() for v in p.values())
    assert n == cfg["model"]["parameters"] == sum(
        q.numel() for q in m.parameters())


# ------------------------------------------------------------ the fit loop
def _old_fit_loop(self, X_train, y_train, X_test, y_test, loss, **kwargs):
    """``BaseVAE._fit_loop`` as it was before its epoch body became
    ``_fit_epochs``."""
    self.compile_trainer((X_train, y_train), (X_test, y_test), **kwargs)
    self.loss = loss
    if self.loss == "ce":
        self.sigmoid_out = True
        self.metadict["sigmoid_out"] = True
    self.recording = kwargs.get("recording", False)
    record = self.recording and self.z_dim in (3, 5)
    epd = 1 if record else max(1, int(kwargs.get("epochs_per_dispatch", 1)))
    verbose = kwargs.get("verbose", True)
    mlog = open_metrics_log(kwargs.get("metrics_log"))
    try:
        e = 0
        while e < self.training_cycles:
            k = min(epd, self.training_cycles - e)
            self.current_epoch = e + k - 1
            elbos, elbos_t = self.train_epochs_lazy(k)
            self.loss_history["train_loss"].extend(elbos.unbind())
            if elbos_t is not None:
                self.loss_history["test_loss"].extend(elbos_t.unbind())
            if mlog is not None or verbose:
                tr = elbos.cpu().numpy()
                ts = None if elbos_t is None else elbos_t.cpu().numpy()
                if mlog is not None:
                    mlog.log_many(e, train_elbo=tr, test_elbo=ts)
                if verbose:
                    for i in range(k):
                        self.print_statistics(
                            e + i, tr[i], None if ts is None else ts[i])
            self.update_metadict()
            self.save_model(self.filename, async_write=True)
            e += k
    finally:
        self._finalize_loss_history()
        flush_async_checkpoints()
        if mlog is not None:
            mlog.close()
    self._sync_replicas()
    self.save_model(self.filename)


def _patches(n=48, size=12):
    imgs, _, _ = aoi.utils.make_lattice_stack(n_images=2, size=48,
                                              spacing=12, seed=3)
    return np.concatenate([aoi.utils.extract_patches_2d(
        p, (size, size), n // 2, i) for i, p in enumerate(imgs)])


FITS = {
    "rVAE": (lambda: aoi.models.rVAE((12, 12), numhidden_encoder=32,
                                     numhidden_decoder=32, device="cpu"),
             dict(rotation_prior=math.pi / 2)),
    "VAE-test-set-epd2": (lambda: aoi.models.VAE(
        (12, 12), numhidden_encoder=32, numhidden_decoder=32, device="cpu"),
        dict(epochs_per_dispatch=2, test=True)),
    "jrVAE": (lambda: aoi.models.jrVAE(
        (12, 12), discrete_dim=[3], numhidden_encoder=32,
        numhidden_decoder=32, device="cpu"), dict()),
}


def _fit(tmp_path, name, loop, capsys):
    make, opts = FITS[name]
    X = _patches()
    opts = dict(opts)
    test = opts.pop("test", False)
    m = make()
    if loop is not None:
        m._fit_loop = loop.__get__(m)
    fname = str(tmp_path / f"{name}-{loop is None}")
    log = fname + ".jsonl"
    m.fit(X[:32], None, X[32:] if test else None, None, training_cycles=3,
          batch_size=8, filename=fname, metrics_log=log, **opts)
    out = capsys.readouterr().out
    meta, arrays = checkpoint.load_checkpoint(fname)
    records = [{k: v for k, v in json.loads(line).items() if k != "wall_s"}
               for line in open(log)]
    return m.loss_history, out, records, meta, arrays


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_epochs_keeps_the_loop(tmp_path, capsys, name):
    """The same seed through the split loop and through the loop as it
    was: the same loss history, prints, metrics log (but its wall-clock
    seconds) and checkpoint."""
    new = _fit(tmp_path, name, None, capsys)
    old = _fit(tmp_path, name, _old_fit_loop, capsys)
    assert new[0] == old[0] and len(new[0]["train_loss"]) == 3
    assert new[1] == old[1] and new[2] == old[2] and new[3] == old[3]
    for part in ("encoder", "decoder"):
        for k, v in old[4]["params"][part].items():
            assert torch.equal(new[4]["params"][part][k], v), (part, k)


# ---------------------------------------------------- spans and counters
def test_fit_records_its_spans_and_counts_its_eager_steps(tmp_path):
    X = _patches()
    m = aoi.models.rVAE((12, 12), numhidden_encoder=32, numhidden_decoder=32,
                        device="cpu")
    before = profiling.summary()["counters"].get("vae.eager_step", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        m.fit(X, training_cycles=2, batch_size=8, verbose=True,
              filename=str(tmp_path / "r"))
    s = profiling.summary()
    spans = {k: v["count"] for k, v in s["spans"].items()
             if k.startswith("vae.")}
    assert spans == {"vae.fit": 1, "vae.epoch": 2, "vae.fetch": 2,
                     "vae.checkpoint": 2, "vae.checkpoint.fetch": 2}
    assert s["counters"]["vae.eager_step"] - before == 2 * (len(X) // 8)
    for name in ("vae.graph_capture", "vae.graph_replay"):
        assert s["counters"].get(name, 0) == 0
    roots = {r.name for r in profiling.spans() if r.parent is None
             and r.name.startswith("vae.")}
    assert roots == {"vae.fit"}


@pytest.mark.parametrize("make,static", [
    (lambda: aoi.models.rVAE((12, 12), device="cpu"), True),
    (lambda: aoi.models.VAE((12, 12), device="cpu"), True),
    (lambda: aoi.models.VAE((12, 12), capacity=[5.0, 100, 30],
                            device="cpu"), True),
    (lambda: aoi.models.jVAE((12, 12), discrete_dim=[3], device="cpu"),
     True),
    (lambda: aoi.models.jrVAE((12, 12), discrete_dim=[3], device="cpu"),
     True),
])
def test_models_that_draw_their_noise_up_front(make, static):
    """Every model of the family has an ELBO that reads its batch, its
    draws and its step count alone, so may draw up front and be graphed,
    but only on a card: on the CPU nothing is drawn up front."""
    m = make()
    m.compile_trainer((_patches(), None), batch_size=8)
    assert m._static_draws() is static
    assert not m._noise_up_front() and not m._graphed()
    g = torch.Generator().manual_seed(0)
    perm, eps = m._epoch_draws(g, 48, 8, 6)
    assert perm.shape == (6, 8) and eps is None
    assert m._uniform_draws(g, 6, 8) is None


def test_import_loads_no_jax_and_no_kernel_library():
    code = ("import sys\n"
            "import atomai_tpu_torch\n"
            "from atomai_tpu_torch.ops import cc_kernel, spatial_mlp, "
            "spd_mll\n"
            "assert not {'jax', 'atomai_tpu'} & set(sys.modules)\n"
            "assert cc_kernel._lib is None and spatial_mlp._lib is None\n"
            "assert spd_mll._lib is None\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
