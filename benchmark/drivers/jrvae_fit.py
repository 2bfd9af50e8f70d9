"""A jrVAE fit with the generative-skip decoder, one epoch a request:
AtomAI's joint rotationally invariant VAE (``jrVAE(in_dim, latent_dim=2,
discrete_dim=[2], translation=True, skip=True)``, ``fit(X,
training_cycles, batch_size=100, rotation_prior=np.pi / 2,
temperature=0.67, cont_capacity=[5, 25000, 30], disc_capacity=[5, 25000,
30])``) on the windows around every atom of one frame, the windows of
``vae_fit.py``, whose helpers this driver shares. Set-up starts the fit
through ``jrVAE.fit`` and runs the warm-up epochs through the fit's epoch
method; each request is one further epoch through it (``_fit_epochs``): a
fresh permutation, every step, the epoch's ELBO fetched and printed as a
verbose fit prints it, and an asynchronous checkpoint under
``.bench_cache/``.

The reference (``reference/jrvae.py``) derives each step's count itself:
the epochs the driver has run times the steps of an epoch, plus the
step's place. After the window, on the program's own state:
- ``elbo_gap``: for a seeded sample of the window's epochs (their draws
  observed when the sample took them: the permutation, the Gaussian noise
  and each discrete latent's uniforms, drawn up front or by each eager
  step), the program's batch ELBO at the weights the epoch left, for the
  epoch's first batch and draws at its first step's count, against the
  reference's at the program's own encoder outputs (the Gumbel samples,
  grid, skip decoder and loss from them), relative. Not against the
  reference's whole forward: once the capacities reach their maxima, the
  capacity terms multiply the rounding of the bf16 encoder's KL by gamma
  = 30 while the ELBO falls to ~10, and the whole forward of sound runs
  reads 0.5-2.5% off the float32 reference there (on an H100), as far
  off as the control's at its early epochs; the encoder is judged by the
  next number and by ``grad_gap``. The whole forward's gap goes to the
  run's ``bench.info`` as ``elbo_gap_whole_forward``;
- ``alpha_gap``: on the same batches and weights, the largest absolute
  gap of the discrete latents' softmax (``alpha``), the encoder's heads
  that a collapsed discrete latent leaves uniform;
- the program's epoch from the state its fit's first epoch left (its
  weights and Adam's moments, saved at set-up and put back in place), run
  again after the window through the same epoch method, at the step
  counts where the window left the fit (past the capacities' 25,000
  steps, so both capacity terms at their maxima pull against the fit),
  judged at that state as ``vae_fit.py`` judges the rVAE's:
  - ``grad_gap``: its first step's gradients against the reference's at
    the program's own activations (the decoder and the loss from the
    program's encoder outputs, the alphas among them, then the encoder's
    backward of their gradient), the largest of each layer's relative L2;
  - ``fitted_elbo_gap``: the epoch against the reference's own epoch of
    the same batches, draws and step counts from the same state: the
    reference's mean loss over the epoch's batches at the program's
    weights less at its own, over the reference epoch's fall. A step
    count frozen, or a draw other than the one recorded, moves it.
"""

import math
import os
import shutil
from typing import Dict, List

import torch

import harness
import roofline_vae
from harness import REPO, seeds
from reference import jrvae as ref
from weights import Adam

vae_fit = harness.load_module("drivers", "vae_fit")

RATE = vae_fit.RATE
LATENCY = vae_fit.LATENCY
CHECKS = ("elbo_gap", "grad_gap", "fitted_elbo_gap", "alpha_gap")
COUNTERS = vae_fit.COUNTERS + ("vae.decoder_fused_step",
                               "vae.decoder_layerwise_step")


class Record(vae_fit.Record):
    """``vae_fit.Record`` with each discrete latent's uniforms (drawn up
    front where the program has ``_uniform_draws``, else by each eager
    step) and the epochs done before the recorded one; ``batches`` holds
    (x, eps, [u of each head])."""

    def __init__(self, m, epochs_done: int):
        super().__init__(m)
        self.epochs_done = epochs_done
        self.heads = len(m.discrete_dim)
        self.u, self.us = None, []
        if hasattr(m, "_uniform_draws"):
            uniform = m._uniform_draws

            def recorded_uniforms(*a):
                self.u = uniform(*a)
                return self.u
            m._uniform_draws = recorded_uniforms
        discrete = m.reparameterize_discrete

        def recorded_discrete(alpha, tau, generator=None, u=None):
            if u is None:
                u = torch.rand(alpha.shape, generator=generator,
                               device=alpha.device)
            self.us.append(u.detach().clone())
            return discrete(alpha, tau, generator, u)
        m.reparameterize_discrete = recorded_discrete

    def finish(self) -> "Record":
        m = self.m
        m.__dict__.pop("_uniform_draws", None)
        del m.reparameterize_discrete
        super().finish()
        k = self.heads
        if self.u is not None:
            steps = [list(s) for s in zip(*self.u)]
        else:
            steps = [self.us[i:i + k] for i in range(0, len(self.us) - k + 1,
                                                     k)]
        self.batches = [(x, e, u) for (x, e), u in zip(self.batches, steps)]
        del self.u, self.us
        return self


def fit_kw(cfg: dict) -> dict:
    """The reference's fit options from the configuration."""
    fit = cfg["fit"]
    return {k: fit[k] for k in ("translation_prior", "rotation_prior",
                                "temperature", "cont_capacity",
                                "disc_capacity")}


def _ref_params(model: dict, generator=None, device="cpu") -> dict:
    return ref.init_params(tuple(model["in_dim"]), model["latent_dim"],
                           model["coord"], model["discrete_dim"],
                           model["numhidden_decoder"],
                           model["numlayers_decoder"], generator, device)


def step_flops(cfg: dict, batch: int) -> int:
    """FLOPs of one training step of the reference at the configuration's
    shapes (forward and autograd backward, counted by torch's
    FlopCounterMode on meta tensors: matrix products only)."""
    from torch.utils.flop_counter import FlopCounterMode
    model = cfg["model"]
    h, w = model["in_dim"]
    p = {k: v.to("meta").requires_grad_()
         for k, v in _ref_params(model).items()}
    x = torch.zeros((batch, h, w), device="meta")
    eps = torch.zeros((batch, model["latent_dim"] + model["coord"]),
                      device="meta")
    u = [torch.full((batch, k), 0.5, device="meta")
         for k in model["discrete_dim"]]
    with FlopCounterMode(display=False) as counter:
        loss = ref.loss(p, x, eps, u, ref.grid((h, w), "meta"), fit_kw(cfg),
                        0, model["numlayers_decoder"])
        loss.backward()
    return int(counter.get_total_flops())


def setup(run):
    from atomai_tpu_torch.models import jrVAE
    if not hasattr(jrVAE, "_fit_epochs"):
        raise RuntimeError("the program's jrVAE has no epoch method "
                           "(_fit_epochs): this cell cannot run")
    cfg, mix, st = run.config, run.traffic, vae_fit.State()
    model, fit = cfg["model"], cfg["fit"]
    s_frame, s_model, s_check = seeds(run.seed, 3)
    st.X = vae_fit.windows(cfg, s_frame)
    run.mark("inputs")
    st.dir = os.path.join(REPO, ".bench_cache", "jrvae_fit", str(os.getpid()))
    os.makedirs(st.dir, exist_ok=True)
    st.model = jrVAE(tuple(model["in_dim"]), latent_dim=model["latent_dim"],
                     discrete_dim=list(model["discrete_dim"]),
                     translation=model["translation"], skip=model["skip"],
                     numlayers_encoder=model["numlayers_encoder"],
                     numhidden_encoder=model["numhidden_encoder"],
                     numlayers_decoder=model["numlayers_decoder"],
                     numhidden_decoder=model["numhidden_decoder"],
                     seed=s_model, device=run.device)
    if not st.model.decoder_net.fused():
        raise RuntimeError(
            "the program runs the skip decoder layer by layer, with the "
            "grid, h0 and the residual sums rounded to bfloat16: the "
            "configuration's decoder is the spatial-MLP kernels' residual "
            "variant with a float32 grid, so this cell cannot run")
    st.model.fit(st.X, training_cycles=1, batch_size=fit["batch_size"],
                 loss=fit["loss"], rotation_prior=fit["rotation_prior"],
                 translation_prior=fit["translation_prior"],
                 temperature=fit["temperature"],
                 cont_capacity=list(fit["cont_capacity"]),
                 disc_capacity=list(fit["disc_capacity"]),
                 filename=os.path.join(st.dir, "jrvae"))
    st.saved = vae_fit._params(st.model), vae_fit._adam(st.model)
    for e in range(1, mix["warmup_epochs"]):
        st.model._fit_epochs(e, 1, verbose=True)
    st.epoch = mix["warmup_epochs"]
    run.mark("warmup")
    B, (h, w) = fit["batch_size"], model["in_dim"]
    st.nb = len(st.X) // B
    run.constants["flops_per_step"] = step_flops(cfg, B)
    run.constants["fwd_bound_s"], run.constants["bwd_bound_s"] = \
        roofline_vae.bound_s(B, h * w, model["numhidden_decoder"],
                             model["numlayers_decoder"])
    st.kept = vae_fit.Sample(mix["check_calls"], s_check)
    return st


def _counters() -> Dict[str, int]:
    from atomai_tpu_torch.core.profiling import summary
    c = summary()["counters"]
    return {k: c[k] for k in COUNTERS if k in c}


def request(run, st, i):
    m = st.model
    slot = st.kept.slot()
    rec = Record(m, st.epoch) if slot is not None else None
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


def _stage_grads(p, x, latents, eps, u, xy, fit, t, num_layers,
                 quant=None) -> dict:
    """The reference's gradients of -ELBO at the given encoder outputs
    (z_mean, z_logsd, alphas...): the decoder's and the latents' from the
    loss, then the encoder's backward of the latents' gradient at ``x``."""
    p = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    lat = [v.detach().float().clone().requires_grad_() for v in latents]
    dec = [k for k in p if k.startswith("decoder.")]
    enc = [k for k in p if k.startswith("encoder.")]
    with ref.exact():
        loss = ref.loss_from_latents(p, x, lat[0], lat[1], lat[2:], eps, u,
                                     xy, fit, t, num_layers, quant)
        g = torch.autograd.grad(loss, [p[k] for k in dec] + lat)
        out = dict(zip(dec, g[:len(dec)]))
        em, el, ea = ref.encode(p, x, num_layers, quant)
        out.update(zip(enc, torch.autograd.grad(
            [em, el] + ea, [p[k] for k in enc], g[len(dec):])))
    return out


def _epoch(p0: dict, adam0: dict, batches, xy, fit, t0: int, num_layers,
           lr, quant=None):
    """The reference's own epoch from (p0, Adam's state adam0): one Adam
    step a (batch, noise, uniforms) triple, the i-th at step count t0 + i;
    (the weights, Adam's state) it leaves."""
    p = {k: v.detach().clone().requires_grad_() for k, v in p0.items()}
    opt = Adam(p, lr)
    for k in adam0["m"]:
        opt.m[k], opt.v[k] = adam0["m"][k].clone(), adam0["v"][k].clone()
    opt.t = adam0["t"]
    for i, (x, eps, u) in enumerate(batches):
        with ref.exact():
            loss = ref.loss(p, x, eps, u, xy, fit, t0 + i, num_layers, quant)
            grads = torch.autograd.grad(loss, list(p.values()))
        opt.step(dict(zip(p, grads)))
    return ({k: v.detach() for k, v in p.items()},
            {"m": opt.m, "v": opt.v, "t": opt.t})


@torch.no_grad()
def _mean_loss(p, batches, xy, fit, t0, num_layers) -> float:
    with ref.exact():
        return float(sum(ref.loss(p, x, e, u, xy, fit, t0 + i, num_layers)
                         for i, (x, e, u) in enumerate(batches))) \
            / len(batches)


def _fitted_gap(p_got, p_ref, p0, batches, xy, fit, t0, num_layers) -> float:
    l0, l_ref, l_got = (_mean_loss(p, batches, xy, fit, t0, num_layers)
                        for p in (p0, p_ref, p_got))
    v = abs(l_got - l_ref) / abs(l0 - l_ref)
    return v if math.isfinite(v) else math.inf


def _alpha_gap(got: List[torch.Tensor], want: List[torch.Tensor]) -> float:
    if len(got) != len(want):
        return math.inf
    v = max(float((a.float() - b).abs().max()) for a, b in zip(got, want))
    return v if math.isfinite(v) else math.inf


def _program_grads(m, x, eps, u, t):
    """The program's gradients of -ELBO of the batch at its weights and
    step count ``t``, and its encoder's outputs there."""
    seen = []
    hook = m.encoder_net.register_forward_hook(
        lambda mod, inp, out: seen.append(out))
    try:
        m.optimizer.zero_grad(set_to_none=True)
        with m.precision.tf32_scope():
            with m.precision.scope(m.device):
                elbo = m.forward_compute_elbo(x, None, t, eps=eps, u=u)
            (-elbo).backward()
    finally:
        hook.remove()
    grads = {k: p.grad.detach().clone() if p.grad is not None
             else torch.zeros_like(p)
             for k, p in zip(vae_fit._names(m), m.parameters())}
    return grads, list(seen[0])


@torch.no_grad()
def _program_elbo(m, x, eps, u, t):
    """The program's ELBO of the batch at its weights and step count
    ``t``, and its encoder's outputs there."""
    seen = []
    hook = m.encoder_net.register_forward_hook(
        lambda mod, inp, out: seen.append(out))
    try:
        with m.precision.scope(m.device):
            elbo = float(m.forward_compute_elbo(x, None, t, eps=eps, u=u))
    finally:
        hook.remove()
    return elbo, [v.float() for v in seen[0]]


def check(run, st):
    if not st.kept.items:
        return {}
    m, model, fit = st.model, run.config["model"], run.config["fit"]
    L, nb = model["numlayers_decoder"], st.nb
    xy = ref.grid(tuple(model["in_dim"]), run.device)
    kw = fit_kw(run.config)
    gaps = dict.fromkeys(CHECKS, 0.0)
    # the program's epoch from the state its first epoch left
    vae_fit._load(m, *st.saved)
    rec = Record(m, st.epoch)
    m._fit_epochs(st.epoch, 1, verbose=False)
    rec.finish()
    for r in st.kept.items + [rec]:
        if len(r.batches) != nb:
            vae_fit._worst(gaps, **dict.fromkeys(CHECKS, math.inf))
            return gaps
    whole = 0.0
    for r in st.kept.items:
        x, eps, u = r.batches[0]
        t = ref.step_count(r.epochs_done, nb, 0)
        vae_fit._load(m, r.W1)
        got, lat = _program_elbo(m, x, eps, u, t)
        with ref.exact(), torch.no_grad():
            want = -float(ref.loss_from_latents(
                r.W1, x, lat[0], lat[1], lat[2:], eps, u, xy, kw, t, L))
            whole = max(whole, vae_fit._rel(got, -float(
                ref.loss(r.W1, x, eps, u, xy, kw, t, L))))
            alphas = ref.encode(r.W1, x, L)[2]
        vae_fit._worst(gaps, elbo_gap=vae_fit._rel(got, want),
                       alpha_gap=_alpha_gap(lat[2:], alphas))
    run.info["elbo_gap_whole_forward"] = whole
    x, eps, u = rec.batches[0]
    t0 = ref.step_count(st.epoch, nb, 0)
    vae_fit._load(m, rec.W0)
    got, latents = _program_grads(m, x, eps, u, t0)
    want = _stage_grads(rec.W0, x, latents, eps, u, xy, kw, t0, L)
    p_ref, _ = _epoch(rec.W0, rec.adam0, rec.batches, xy, kw, t0, L,
                      fit["lr"])
    vae_fit._worst(
        gaps, grad_gap=vae_fit._grad_gap(got, want, ref.layer_names(
            L, len(model["discrete_dim"]))),
        fitted_elbo_gap=_fitted_gap(rec.W1, p_ref, rec.W0, rec.batches, xy,
                                    kw, t0, L))
    shutil.rmtree(st.dir, ignore_errors=True)
    return gaps


def control_readings(run, compute_dtype=None, coord_dtype=None) -> dict:
    """The numbers of :func:`check` with the reference put in the program's
    place one precision below the configuration's (``compute_dtype``, the
    float8 of the bf16 products: the hidden layers' and the decoder's; and
    ``coord_dtype``, the bfloat16 of the float32 heads), against the
    float32 reference, on the run's windows: the reference's first epoch
    from seeded weights, then ``check_calls`` epochs, each judged as a run
    judges the program's, at its own step counts: the ELBO and the alphas
    at the weights it leaves, the first step's gradients and the epoch
    from the state it starts at (the ELBO at its own encoder outputs, as a
    run's)."""
    cfg, mix = run.config, run.traffic
    model, fit = cfg["model"], cfg["fit"]
    dev = run.device
    quant = (compute_dtype or torch.float8_e4m3fn,
             coord_dtype or torch.bfloat16)
    s_frame, s_model, s_check = seeds(run.seed, 3)
    X = torch.from_numpy(vae_fit.windows(cfg, s_frame)).to(dev)
    L, B = model["numlayers_decoder"], fit["batch_size"]
    xy = ref.grid(tuple(model["in_dim"]), dev)
    kw = fit_kw(cfg)
    p = _ref_params(model, torch.Generator().manual_seed(s_model), dev)
    adam = {"m": {}, "v": {}, "t": 0}
    g = torch.Generator(device=dev).manual_seed(s_check)
    gaps = dict.fromkeys(CHECKS, 0.0)
    nb = len(X) // B
    z = model["latent_dim"] + model["coord"]
    for e in range(1 + mix["check_calls"]):
        perm = torch.randperm(len(X), generator=g, device=dev)
        eps = torch.randn((nb, B, z), generator=g, device=dev)
        us = [torch.rand((nb, B, k), generator=g, device=dev)
              for k in model["discrete_dim"]]
        batches = [(X[i], n, list(u)) for i, n, u in
                   zip(perm[:nb * B].view(nb, B), eps, zip(*us))]
        t0 = ref.step_count(e, nb, 0)
        p1 = _epoch(p, adam, batches, xy, kw, t0, L, fit["lr"])
        if e:
            q1, _ = _epoch(p, adam, batches, xy, kw, t0, L, fit["lr"], quant)
            x, n, u = batches[0]
            with ref.exact(), torch.no_grad():
                lq = ref.encode(p1[0], x, L, quant)
                a = -float(ref.loss_from_latents(p1[0], x, lq[0], lq[1], lq[2],
                                                 n, u, xy, kw, t0, L, quant))
                b = -float(ref.loss_from_latents(p1[0], x, lq[0], lq[1], lq[2],
                                                 n, u, xy, kw, t0, L))
                aq, ax = lq[2], ref.encode(p1[0], x, L)[2]
                zq, zx = ref.encode(p, x, L, quant), ref.encode(p, x, L)
            got = _stage_grads(p, x, [zq[0], zq[1]] + zq[2], n, u, xy, kw,
                               t0, L, quant)
            want = _stage_grads(p, x, [zx[0], zx[1]] + zx[2], n, u, xy, kw,
                                t0, L)
            vae_fit._worst(
                gaps, elbo_gap=vae_fit._rel(a, b),
                alpha_gap=_alpha_gap(aq, ax),
                grad_gap=vae_fit._grad_gap(got, want, ref.layer_names(
                    L, len(model["discrete_dim"]))),
                fitted_elbo_gap=_fitted_gap(q1, p1[0], p, batches, xy, kw,
                                            t0, L))
        p, adam = p1
    return gaps
