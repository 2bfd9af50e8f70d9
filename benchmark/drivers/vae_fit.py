"""An rVAE fit, one epoch a request: AtomAI's rVAE (README: ``rVAE(in_dim,
latent_dim=2)``, ``fit(X, training_cycles, batch_size=100,
rotation_prior=np.pi / 2)``) on the windows around every atom of one
frame (a frozen copy of the port's ``extract_subimages``). Set-up starts
the fit through ``rVAE.fit`` (its first epoch takes the step through its
CUDA graph's capture, then the rest of the warm-up epochs replay it
through the epoch method); each request is one further epoch through
the fit's own epoch method (``_fit_epochs``): a fresh permutation, every
step, the epoch's ELBO fetched and printed as a verbose fit prints it,
and an asynchronous checkpoint under ``.bench_cache/``.

After the window, on the program's own state:
- ``elbo_gap``: for a seeded sample of the window's epochs (their draws
  observed when the sample took them), the program's batch ELBO at the
  weights the epoch left, for the epoch's first batch and noise, against
  the reference's, relative;
- the program's epoch from the state its fit's first epoch left (its
  weights and Adam's moments, saved at set-up and put back in place), run
  again after the window through the same epoch method and graph, judged
  at that state, where the fit still moves: later in a fit a step's
  gradients are sums that cancel to a tenth of their terms and an
  epoch's fall is below its rounding (measured on sound runs by epoch
  300: 0.24 and 0.63 on the numbers below), so that neither tells
  rounding from a fault there:
  - ``grad_gap``: its first step's gradients against the reference's at
    the program's own activations (the decoder and the loss from the
    program's encoder outputs, then the encoder's backward of their
    gradient), the largest of each layer's relative L2. The kernels'
    backward takes its gradients in bfloat16, and a layer's gradient is
    a sum over 230,400 rows (the encoder's, through the latents' sums
    over each window's 2,304) that cancels to a twentieth of its terms
    and less: sound runs read 0.05-0.15 here, each decoder weight's error
    0.1-0.5% of the size of the terms it sums, the rounding of bfloat16;
  - ``fitted_elbo_gap``: the epoch against the reference's own epoch of
    the same batches and noise from the same state: the reference's mean
    loss over the epoch's batches at the program's weights less at its
    own, over the reference epoch's fall. An epoch that leaves the state
    unchanged reads 1.
"""

import math
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

import lattice
import roofline_vae
from harness import REPO, seeds
from reference import rvae as ref
from weights import Adam

RATE = "serve_samples_per_s"
LATENCY = "call_p95_ms"
CHECKS = ("elbo_gap", "grad_gap", "fitted_elbo_gap")
COUNTERS = ("vae.graph_replay", "vae.graph_capture", "vae.eager_step")


class State:
    pass


class Sample:
    """A uniform sample of ``k`` of the window's calls (Algorithm R), each
    call's place decided before it runs, so that a kept call's starting
    state can be saved."""

    def __init__(self, k: int, seed: int):
        self.k, self.n = k, 0
        self.items: List = []
        self.rng = np.random.default_rng(seed)

    def slot(self) -> Optional[int]:
        """Where the next call goes if kept, or None."""
        self.n += 1
        if len(self.items) < self.k:
            return len(self.items)
        j = int(self.rng.integers(0, self.n))
        return j if j < self.k else None

    def put(self, slot: int, item) -> None:
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item


def windows(cfg: dict, seed: int) -> np.ndarray:
    """The configuration's frame and the windows of ``in_dim`` centred at
    its atoms' rounded positions, those wholly inside the frame, in the
    atoms' order: (m, h, w) float32. A frozen copy of the port's
    ``extract_subimages`` on one frame, so that a later change to the
    program cannot change the inputs."""
    spec = cfg["data"]["frame"]
    s = int(np.random.SeedSequence(seed).generate_state(1)[0])
    imgs, _, coords = lattice.make_lattice_stack(
        n_images=1, size=spec["size"], spacing=spec["spacing"],
        jitter=spec["jitter"], noise=spec["noise"], seed=s)
    img, r = imgs[0], cfg["model"]["in_dim"][0]
    lo = np.around(coords[0]).astype(np.int64) - r // 2
    lo = lo[(lo >= 0).all(1) & (lo + r <= np.array(img.shape)).all(1)]
    rows = lo[:, 0, None] + np.arange(r)
    cols = lo[:, 1, None] + np.arange(r)
    return np.ascontiguousarray(img[rows[:, :, None], cols[:, None, :]],
                                np.float32)


def _names(m) -> List[str]:
    return [f"{part}.{k}" for part, net in
            (("encoder", m.encoder_net), ("decoder", m.decoder_net))
            for k, _ in net.named_parameters()]


def _params(m) -> Dict[str, torch.Tensor]:
    return dict(zip(_names(m), (p.detach().clone()
                                for p in m.parameters())))


def _adam(m) -> dict:
    """The program's Adam moments and step count, by parameter name."""
    state = m.optimizer.state
    out = {"m": {}, "v": {}, "t": 0}
    for name, p in zip(_names(m), m.parameters()):
        s = state.get(p, {})
        if "exp_avg" in s:
            out["m"][name] = s["exp_avg"].detach().clone()
            out["v"][name] = s["exp_avg_sq"].detach().clone()
            out["t"] = int(s["step"])
    return out


class Record:
    """What a kept epoch needs for its judgement: the state it started
    from, the draws it made (observed through the program's own draws:
    ``_epoch_draws``, whose noise is drawn up front on a card, else each
    eager step's batch and noise) and the weights it left."""

    def __init__(self, m):
        self.m = m
        self.W0, self.adam0 = _params(m), _adam(m)
        self.perm = self.eps = None
        self.xs, self.noise = [], []
        draws = m._epoch_draws

        def recorded_draws(*a):
            self.perm, self.eps = draws(*a)
            return self.perm, self.eps
        reparameterize = m.reparameterize

        def recorded_noise(z_mean, z_sd, generator=None, eps=None):
            if eps is None:
                eps = torch.randn(z_mean.shape, generator=generator,
                                  device=z_mean.device, dtype=z_mean.dtype)
            self.noise.append(eps.detach().clone())
            return reparameterize(z_mean, z_sd, generator, eps)
        m._epoch_draws, m.reparameterize = recorded_draws, recorded_noise
        self.hook = m.encoder_net.register_forward_pre_hook(
            lambda mod, inp: self.xs.append(inp[0].detach().clone()))

    def finish(self) -> "Record":
        m = self.m
        del m._epoch_draws, m.reparameterize
        self.hook.remove()
        self.W1 = _params(m)
        if self.eps is not None:       # up front: the batches by index
            self.batches = [(m.X_train[i], e)
                            for i, e in zip(self.perm, self.eps)]
        else:
            self.batches = list(zip(self.xs, self.noise))
        del self.m, self.xs, self.noise, self.perm, self.eps
        return self


def step_flops(model: dict, batch: int) -> int:
    """FLOPs of one training step of the reference at the configuration's
    shapes (forward and autograd backward, counted by torch's
    FlopCounterMode on meta tensors: matrix products only)."""
    from torch.utils.flop_counter import FlopCounterMode
    h, w = model["in_dim"]
    p = {k: v.to("meta").requires_grad_()
         for k, v in ref.init_params((h, w), model["latent_dim"],
                                     model["coord"],
                                     model["numhidden_decoder"],
                                     model["numlayers_decoder"]).items()}
    x = torch.zeros((batch, h, w), device="meta")
    eps = torch.zeros((batch, model["latent_dim"] + model["coord"]),
                      device="meta")
    with FlopCounterMode(display=False) as counter:
        loss = ref.loss(p, x, eps, ref.grid((h, w), "meta"), 0.1, 0.1,
                        model["numlayers_decoder"])
        loss.backward()
    return int(counter.get_total_flops())


def setup(run):
    from atomai_tpu_torch.models import rVAE
    if not hasattr(rVAE, "_fit_epochs"):
        raise RuntimeError("the program's rVAE has no epoch method "
                           "(_fit_epochs): this cell cannot run")
    cfg, mix, st = run.config, run.traffic, State()
    model, fit = cfg["model"], cfg["fit"]
    s_frame, s_model, s_check = seeds(run.seed, 3)
    st.X = windows(cfg, s_frame)
    run.mark("inputs")
    st.dir = os.path.join(REPO, ".bench_cache", "vae_fit", str(os.getpid()))
    os.makedirs(st.dir, exist_ok=True)
    st.model = rVAE(tuple(model["in_dim"]), latent_dim=model["latent_dim"],
                    translation=model["translation"],
                    numlayers_encoder=model["numlayers_encoder"],
                    numhidden_encoder=model["numhidden_encoder"],
                    numlayers_decoder=model["numlayers_decoder"],
                    numhidden_decoder=model["numhidden_decoder"],
                    seed=s_model, device=run.device)
    st.model.fit(st.X, training_cycles=1, batch_size=fit["batch_size"],
                 loss=fit["loss"], rotation_prior=fit["rotation_prior"],
                 translation_prior=fit["translation_prior"],
                 filename=os.path.join(st.dir, "rvae"))
    st.saved = _params(st.model), _adam(st.model)
    for e in range(1, mix["warmup_epochs"]):
        st.model._fit_epochs(e, 1, verbose=True)
    st.epoch = mix["warmup_epochs"]
    run.mark("warmup")
    B, (h, w) = fit["batch_size"], model["in_dim"]
    st.nb = len(st.X) // B
    run.constants["flops_per_step"] = step_flops(model, B)
    run.constants["fwd_bound_s"], run.constants["bwd_bound_s"] = \
        roofline_vae.bound_s(B, h * w, model["numhidden_decoder"],
                             model["numlayers_decoder"])
    st.kept = Sample(mix["check_calls"], s_check)
    return st


def _counters() -> Dict[str, int]:
    from atomai_tpu_torch.core.profiling import summary
    c = summary()["counters"]
    return {k: c[k] for k in COUNTERS if k in c}


def request(run, st, i):
    m = st.model
    slot = st.kept.slot()
    rec = Record(m) if slot is not None else None
    before = _counters()
    m._fit_epochs(st.epoch, 1, verbose=True)
    st.epoch += 1
    if rec is not None:
        st.kept.put(slot, rec.finish())
    after = _counters()
    counts = {"samples": 1, "steps": st.nb}
    for k, v in after.items():
        counts[k.replace(".", "_")] = v - before.get(k, 0)
    return counts


def _priors(m) -> dict:
    return {"dx_prior": m.dx_prior, "phi_prior": m.kdict_["phi_prior"]}


def _ref_loss(p, x, eps, xy, pri, num_layers, quant=None):
    return ref.loss(p, x, eps, xy, pri["dx_prior"], pri["phi_prior"],
                    num_layers, quant)


def _rel(a: float, b: float) -> float:
    v = abs(a - b) / abs(b)
    return v if math.isfinite(v) else math.inf


def _grad_gap(got: dict, want: dict, layers: List[str]) -> float:
    """The largest relative L2 gap of a layer's gradients (weight and bias
    together)."""
    worst = 0.0
    for layer in layers:
        keys = [k for k in want if k.rsplit(".", 1)[0] == layer]
        g = torch.cat([got[k].reshape(-1) for k in keys])
        w = torch.cat([want[k].reshape(-1) for k in keys])
        v = float(torch.linalg.norm(g - w) / torch.linalg.norm(w))
        worst = max(worst, v if math.isfinite(v) else math.inf)
    return worst


def _stage_grads(p, x, z_mean, z_logsd, eps, xy, pri, num_layers,
                 quant=None) -> dict:
    """The reference's gradients of -ELBO at the given encoder outputs:
    the decoder's and the latents' from the loss, then the encoder's
    backward of the latents' gradient at ``x``."""
    p = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    zm = z_mean.detach().clone().requires_grad_()
    zl = z_logsd.detach().clone().requires_grad_()
    dec = [k for k in p if k.startswith("decoder.")]
    enc = [k for k in p if k.startswith("encoder.")]
    with ref.exact():
        loss = ref.loss_from_latents(p, x, zm, zl, eps, xy, pri["dx_prior"],
                                     pri["phi_prior"], num_layers, quant)
        g = torch.autograd.grad(loss, [p[k] for k in dec] + [zm, zl])
        out = dict(zip(dec, g[:len(dec)]))
        em, el = ref.encode(p, x, num_layers, quant)
        out.update(zip(enc, torch.autograd.grad(
            (em, el), [p[k] for k in enc], g[len(dec):])))
    return out


def _epoch(p0: dict, adam0: dict, batches, xy, pri, num_layers, lr,
           quant=None):
    """The reference's own epoch from (p0, Adam's state adam0): one Adam
    step a (batch, noise) pair; (the weights, Adam's state) it leaves."""
    p = {k: v.detach().clone().requires_grad_() for k, v in p0.items()}
    opt = Adam(p, lr)
    for k in adam0["m"]:
        opt.m[k], opt.v[k] = adam0["m"][k].clone(), adam0["v"][k].clone()
    opt.t = adam0["t"]
    for x, eps in batches:
        with ref.exact():
            loss = _ref_loss(p, x, eps, xy, pri, num_layers, quant)
            grads = torch.autograd.grad(loss, list(p.values()))
        opt.step(dict(zip(p, grads)))
    return ({k: v.detach() for k, v in p.items()},
            {"m": opt.m, "v": opt.v, "t": opt.t})


@torch.no_grad()
def _mean_loss(p, batches, xy, pri, num_layers) -> float:
    with ref.exact():
        return float(sum(_ref_loss(p, x, e, xy, pri, num_layers)
                         for x, e in batches)) / len(batches)


def _fitted_gap(p_got, p_ref, p0, batches, xy, pri, num_layers) -> float:
    l0, l_ref, l_got = (_mean_loss(p, batches, xy, pri, num_layers)
                        for p in (p0, p_ref, p_got))
    v = abs(l_got - l_ref) / abs(l0 - l_ref)
    return v if math.isfinite(v) else math.inf


def _worst(gaps: dict, **values) -> None:
    for name, v in values.items():
        gaps[name] = max(gaps[name], v if math.isfinite(v) else math.inf)


def _load(m, p: dict, adam: Optional[dict] = None) -> None:
    """The weights ``p`` (and Adam's state ``adam``) into the program's
    tensors, in place, where its graph reads them."""
    with torch.no_grad():
        for name, q in zip(_names(m), m.parameters()):
            q.copy_(p[name])
            if adam is not None and name in adam["m"]:
                s = m.optimizer.state[q]
                s["exp_avg"].copy_(adam["m"][name])
                s["exp_avg_sq"].copy_(adam["v"][name])
                s["step"].fill_(adam["t"])


def _program_grads(m, x, eps):
    """The program's gradients of -ELBO of the batch at its weights, and
    its encoder's outputs there."""
    seen = []
    hook = m.encoder_net.register_forward_hook(
        lambda mod, inp, out: seen.append(out))
    try:
        m.optimizer.zero_grad(set_to_none=True)
        with m.precision.tf32_scope():
            with m.precision.scope(m.device):
                elbo = m.forward_compute_elbo(x, None, 0, eps=eps)
            (-elbo).backward()
    finally:
        hook.remove()
    grads = {k: p.grad.detach().clone() if p.grad is not None
             else torch.zeros_like(p)
             for k, p in zip(_names(m), m.parameters())}
    return grads, seen[0][0], seen[0][1]


@torch.no_grad()
def _program_elbo(m, x, eps) -> float:
    with m.precision.scope(m.device):
        return float(m.forward_compute_elbo(x, None, 0, eps=eps))


def check(run, st):
    if not st.kept.items:
        return {}
    m, model = st.model, run.config["model"]
    L = model["numlayers_decoder"]
    xy = ref.grid(tuple(model["in_dim"]), run.device)
    pri = _priors(m)
    gaps = dict.fromkeys(CHECKS, 0.0)
    # the program's epoch from the state its first epoch left
    _load(m, *st.saved)
    rec = Record(m)
    m._fit_epochs(st.epoch, 1, verbose=False)
    rec.finish()
    for r in st.kept.items + [rec]:
        if len(r.batches) != st.nb:
            _worst(gaps, **dict.fromkeys(CHECKS, math.inf))
            return gaps
    for r in st.kept.items:
        x, eps = r.batches[0]
        _load(m, r.W1)
        with ref.exact(), torch.no_grad():
            want = -float(_ref_loss(r.W1, x, eps, xy, pri, L))
        _worst(gaps, elbo_gap=_rel(_program_elbo(m, x, eps), want))
    x, eps = rec.batches[0]
    _load(m, rec.W0)
    got, z_mean, z_logsd = _program_grads(m, x, eps)
    want = _stage_grads(rec.W0, x, z_mean, z_logsd, eps, xy, pri, L)
    p_ref, _ = _epoch(rec.W0, rec.adam0, rec.batches, xy, pri, L,
                      run.config["fit"]["lr"])
    _worst(gaps, grad_gap=_grad_gap(got, want, ref.layer_names(L)),
           fitted_elbo_gap=_fitted_gap(rec.W1, p_ref, rec.W0, rec.batches,
                                       xy, pri, L))
    shutil.rmtree(st.dir, ignore_errors=True)
    return gaps


def control_readings(run, compute_dtype=None, coord_dtype=None) -> dict:
    """The numbers of :func:`check` with the reference put in the program's
    place one precision below the configuration's (``compute_dtype``, the
    float8 of the bf16 products: the hidden layers' and the decoder's; and
    ``coord_dtype``, the bfloat16 of the float32 heads), against the
    float32 reference, on the run's windows: the reference's first epoch
    from seeded weights, then ``check_calls`` epochs, each judged as a run
    judges the program's: the ELBO at the weights it leaves, the first
    step's gradients and the epoch from the state it starts at."""
    cfg, mix = run.config, run.traffic
    model, fit = cfg["model"], cfg["fit"]
    dev = run.device
    quant = (compute_dtype or torch.float8_e4m3fn,
             coord_dtype or torch.bfloat16)
    s_frame, s_model, s_check = seeds(run.seed, 3)
    X = torch.from_numpy(windows(cfg, s_frame)).to(dev)
    L, B = model["numlayers_decoder"], fit["batch_size"]
    xy = ref.grid(tuple(model["in_dim"]), dev)
    pri = {"dx_prior": fit["translation_prior"],
           "phi_prior": fit["rotation_prior"]}
    p = ref.init_params(tuple(model["in_dim"]), model["latent_dim"],
                        model["coord"], model["numhidden_decoder"], L,
                        torch.Generator().manual_seed(s_model), dev)
    adam = {"m": {}, "v": {}, "t": 0}
    g = torch.Generator(device=dev).manual_seed(s_check)
    gaps = dict.fromkeys(CHECKS, 0.0)
    nb = len(X) // B
    z = model["latent_dim"] + model["coord"]
    for e in range(1 + mix["check_calls"]):
        perm = torch.randperm(len(X), generator=g, device=dev)
        eps = torch.randn((nb, B, z), generator=g, device=dev)
        batches = [(X[i], n) for i, n in zip(perm[:nb * B].view(nb, B), eps)]
        p1 = _epoch(p, adam, batches, xy, pri, L, fit["lr"])
        if e:
            q1, _ = _epoch(p, adam, batches, xy, pri, L, fit["lr"], quant)
            x, n = batches[0]
            with ref.exact(), torch.no_grad():
                a = -float(_ref_loss(p1[0], x, n, xy, pri, L, quant))
                b = -float(_ref_loss(p1[0], x, n, xy, pri, L))
                zq, zx = ref.encode(p, x, L, quant), ref.encode(p, x, L)
            got = _stage_grads(p, x, *zq, n, xy, pri, L, quant)
            want = _stage_grads(p, x, *zx, n, xy, pri, L)
            _worst(gaps, elbo_gap=_rel(a, b),
                   grad_gap=_grad_gap(got, want, ref.layer_names(L)),
                   fitted_elbo_gap=_fitted_gap(q1, p1[0], p, batches, xy,
                                               pri, L))
        p, adam = p1
    return gaps
