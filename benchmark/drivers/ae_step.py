"""An active-learning step loop: each request is one step of AtomAI's
autonomous experiment (README: ``dklGPR(indim, embedim=2)``, ``fit(X, y,
training_cycles=200)``, ``thompson(X_candidates)``): a fresh, seeded
``dklGPR`` fitted on the patches measured so far, then one posterior draw
over every candidate patch, whose argmax is the next probe position.

The run's experiment states (a frame's patches, a target a patch, a
seeded measured set and the noise of its draw) are made at set-up; calls
cycle through them. After the window a seeded sample of the calls is
judged stage by stage on the program's own inputs, since a draw over
candidates this dense (a covariance whose condition is about 1e10) cannot
be compared element by element across different embeddings:
- ``embed_gap``: the program's scaled embeddings of the measured and the
  candidate patches against the reference extractor on its weights;
- ``fit_gap``: the program's first step (its loss and the gradients of the
  GP's and the extractor's parameters, at its initial parameters) and its
  loss at the fitted parameters, against the reference's stage by stage
  at the program's own activations (the GP's loss and gradients at the
  extractor's output, then the extractor's backward of that gradient):
  losses and GP gradients relative, each extractor layer's gradients
  over the size of the terms they sum;
- ``fitted_loss_gap``: the fit of the call against the reference's own
  fit of as many Adam cycles from the same initial parameters: the
  reference's loss at the call's fitted parameters less its loss at its
  own, over the reference fit's fall in loss. A fit that leaves the state
  unchanged reads 1; half or one and a half times the step size about 0.5;
- ``draw_gap``: the program's draw against the reference's float64 draw
  from the program's embeddings, hyperparameters and noise, over the
  posterior standard deviation;
- ``index_gap``: 0 where the draw is finite and its index its argmax.
"""

import math
from typing import List

import numpy as np
import torch

import inputs
import roofline_gp
from harness import seeds
from reference import dkl as ref
from weights import Adam

RATE = "serve_samples_per_s"
LATENCY = "call_p95_ms"
CHECKS = ("embed_gap", "fit_gap", "fitted_loss_gap", "draw_gap",
          "index_gap")


class State:
    pass


class Experiment:
    """One experiment state: measured inputs and targets, candidates, the
    draw's noise and the seed of its model."""

    def __init__(self, X, y, Xc, eps, seed):
        self.X, self.y, self.Xc, self.eps, self.seed = X, y, Xc, eps, seed


def patches(frame: np.ndarray, size: int, stride: int) -> np.ndarray:
    """Every ``size`` x ``size`` patch at ``stride``, flattened: (P, size^2)
    float32."""
    w = np.lib.stride_tricks.sliding_window_view(frame, (size, size))
    return np.ascontiguousarray(
        w[::stride, ::stride].reshape(-1, size * size), np.float32)


def offsets(P: np.ndarray, size: int) -> np.ndarray:
    """The intensity-weighted x offset of each patch's mass from its
    centre, weighting by the patch less its minimum."""
    w = P.reshape(-1, size, size).astype(np.float64)
    w = w - w.min((1, 2), keepdims=True)
    x = np.arange(size) - (size - 1) / 2
    return (w.sum(1) * x).sum(1) / np.maximum(w.sum((1, 2)), 1e-12)


def _inputs(run) -> State:
    """The run's experiment states, made from its seed."""
    cfg, mix, st = run.config, run.traffic, State()
    s_frame, s_noise, st.s_check, *s_states = seeds(run.seed,
                                                    3 + mix["states"])
    frame = inputs.frames(cfg["data"]["frame"], s_frame)[0][0]
    pc = cfg["patches"]
    P = patches(frame, pc["size"], pc["stride"])
    off = offsets(P, pc["size"])
    y = (off + pc["target_noise"] * off.std() *
         np.random.default_rng(s_noise).standard_normal(len(off))
         ).astype(np.float32)
    sizes = np.linspace(mix["n_min"], mix["n_max"], mix["states"])
    st.states = []
    for n, s in zip(np.rint(sizes).astype(int), s_states):
        rng = np.random.default_rng(s)
        meas = np.sort(rng.choice(len(P), int(n), replace=False))
        cand = np.setdiff1d(np.arange(len(P)), meas)
        eps = rng.standard_normal((1, 1, len(cand))).astype(np.float32)
        st.states.append(Experiment(P[meas], y[meas], P[cand],
                                    torch.from_numpy(eps),
                                    int(rng.integers(2 ** 31))))
    run.mark("states")
    return st


def setup(run):
    import atomai_tpu_torch as aoi
    st = _inputs(run)
    st.dklGPR = aoi.models.dklGPR
    st.kept = inputs.Reservoir(0, st.s_check)
    for i in range(run.traffic["warmup_calls"]):
        request(run, st, i)
    run.mark("warmup")
    st.kept = inputs.Reservoir(run.traffic["check_calls"], st.s_check)
    return st


def _model(run, st, s):
    model = run.config["model"]
    return st.dklGPR(model["indim"], embedim=model["embedim"],
                     device=run.device, seed=s.seed)


def request(run, st, i):
    k = i % len(st.states)
    s = st.states[k]
    fit = run.config["fit"]
    with run.span("fit"):
        m = _model(run, st, s)
        m.fit(s.X, s.y, training_cycles=fit["training_cycles"],
              print_loss=fit["print_loss"])
    with run.span("thompson"):
        draw, idx = m.thompson(s.Xc, eps=s.eps)
    if not np.isfinite(draw).all():
        raise RuntimeError(f"the draw over {len(s.Xc)} candidates is not "
                           f"finite")
    st.kept.offer(lambda: (k, m, draw, idx))
    return {"samples": 1,
            "draw_flops": roofline_gp.draw_flops(
                len(s.X), len(s.Xc), run.config["model"]["embedim"])}


def _weights(m) -> List:
    """The program's extractor weights as the reference's (w, b) list."""
    return [(layer.weight.detach(), layer.bias.detach())
            for layer in m.fe.layers]


def _gp(m) -> dict:
    """The program's raw GP hyperparameters, without the output axis."""
    return {k: v.detach()[0] for k, v in m.gp_params.items()}


def _program_forward(m, fn):
    """``fn()``'s result and what the program's extractor saw in it: each
    layer's input, and the extractor's output."""
    seen = []
    hooks = [layer.register_forward_hook(
        lambda mod, inp, out: seen.append((inp[0].detach(), out.detach())))
        for layer in m.fe.layers]
    try:
        result = fn()
    finally:
        for h in hooks:
            h.remove()
    return result, [x for x, _ in seen], seen[-1][1]


def _grad(p) -> torch.Tensor:
    """A parameter's gradient, zeros where none came."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _stage_grads(W, gp, y, z, inputs, quant=None):
    """The reference's loss, GP gradients and extractor gradients (a (w, b)
    pair a layer) of one step, stage by stage at the activations under
    judgement (``inputs`` each layer's, ``z`` the extractor's output): the
    GP's loss and gradients at ``z``, then the extractor's backward of that
    gradient at those activations (its operands rounded to ``quant`` for
    the control), in float32 with TF32 off. Judged at the program's own
    activations, a ReLU that the forward's rounding switched, or a point it
    made extreme under the scaling, moves both sides alike. Also each
    layer's scale of rounding: the norms of |D|^T |X| and of the summed
    |D| (D the gradient at the layer's output, X its input), the size of
    the terms each gradient sums, which cancel."""
    zr = z.detach().clone().requires_grad_()
    gp = {k: v.clone().requires_grad_() for k, v in gp.items()}
    with ref.exact():
        loss = ref.gp_loss(zr, gp, y)
        loss.backward()
        g_fe, ds = ref.extract_grads(W, inputs, zr.grad, quant)
        scales = [(float(torch.linalg.norm(d.abs().T @ x.abs())),
                   float(torch.linalg.norm(d.abs().sum(0))))
                  for d, x in zip(ds, inputs)]
    g_gp = torch.cat([gp[k].grad.reshape(-1) for k in sorted(gp)])
    return float(loss.detach()), g_gp, g_fe, scales


def _fe_gap(got, want, scales) -> float:
    """The largest gap of a layer's weight or bias gradient over its scale
    of rounding (:func:`_stage_grads`)."""
    return max(float(torch.linalg.norm(g - w)) / s
               for gl, wl, sl in zip(got, want, scales)
               for g, w, s in zip(gl, wl, sl))


def _loss_gap(a: float, b: float) -> float:
    return abs(a - b) / (1.0 + abs(b))


@torch.no_grad()
def _ref_embed(W, X, Xc, quant=None):
    """The reference's scaled embeddings of the measured and candidate
    inputs, scaled by the measured ones' bounds."""
    with ref.exact():
        z_t = ref.extract(W, X, quant)
        stats = ref.bounds(z_t)
        return ref.scale(z_t, stats), ref.scale(ref.extract(W, Xc, quant),
                                                stats)


def _fitted_loss_gap(W, gp, W0, gp0, fitted, X, y) -> float:
    """``fitted_loss_gap`` of fitted parameters (W, gp) against the
    reference's own fit ``fitted`` (its (W, gp)) from (W0, gp0)."""
    W_r, gp_r = fitted
    with ref.exact(), torch.no_grad():
        l0, l_r, l_got = (float(ref.neg_mll(w, g, X, y))
                          for w, g in ((W0, gp0), (W_r, gp_r), (W, gp)))
    return abs(l_got - l_r) / abs(l0 - l_r)


def _max_gap(pairs) -> float:
    return max(float(torch.max(torch.abs(a - b))) for a, b in pairs)


def _worst(gaps: dict, **values) -> None:
    """Keeps the largest reading of each number, NaN as infinite."""
    for name, v in values.items():
        gaps[name] = max(gaps[name], v if math.isfinite(v) else math.inf)


def _draw_gap(draw, idx, z_t, y, z_c, gp, eps) -> dict:
    """``draw_gap`` and ``index_gap`` of a program's draw and index
    against the reference's float64 draw at the given embeddings."""
    mean, cov = ref.posterior(z_t, y, z_c, gp, torch.float64)
    want, sd = ref.draw(mean, cov, eps.reshape(-1))
    del cov
    draw = torch.as_tensor(np.asarray(draw, np.float64)).reshape(-1)
    gap = float(torch.max(torch.abs(draw.to(want.device) - want) / sd))
    ok = bool(np.isfinite(draw.numpy()).all()) and \
        int(np.ravel(idx)[0]) == int(torch.argmax(draw))
    return {"draw_gap": gap if math.isfinite(gap) else math.inf,
            "index_gap": 0.0 if ok else math.inf}


def check(run, st):
    if not st.kept.items:
        return {}
    dev = run.device
    gaps = dict.fromkeys(CHECKS, 0.0)
    for k, m, draw, idx in st.kept.items:
        s = st.states[k]
        X, Xc = (torch.from_numpy(a).to(dev) for a in (s.X, s.Xc))
        y = torch.from_numpy(s.y).to(dev)
        W, gp = _weights(m), _gp(m)
        # (a) the embeddings
        z_t = torch.from_numpy(m.embed(s.X)).to(dev)
        z_c = torch.from_numpy(m.embed(s.Xc)).to(dev)
        embed = _max_gap(zip((z_t, z_c), _ref_embed(W, X, Xc)))
        # (b) the fit: the program's first step, and its fitted loss, each
        # judged at the program's own activations
        m0 = _model(run, st, s)
        m0.compile_trainer(s.X, s.y, training_cycles=1)
        W0, gp0 = _weights(m0), _gp(m0)
        m0.optimizer.zero_grad(set_to_none=False)
        loss0, inputs0, z0 = _program_forward(m0, m0._loss_backward)
        g_gp = torch.cat([_grad(m0.gp_params[k]).reshape(-1)
                          for k in sorted(m0.gp_params)])
        g_fe = [(_grad(layer.weight), _grad(layer.bias))
                for layer in m0.fe.layers]
        r_loss0, r_gp, r_fe, scales = _stage_grads(W0, gp0, y, z0, inputs0)
        with torch.no_grad():
            loss_fit, _, z_fit = _program_forward(m, m._loss_fn)
            with ref.exact():
                r_loss_fit = float(ref.gp_loss(z_fit, gp, y))
        fit_gap = max(_loss_gap(float(loss0.detach()), r_loss0),
                      _rel(g_gp, r_gp), _fe_gap(g_fe, r_fe, scales),
                      _loss_gap(float(loss_fit), r_loss_fit))
        # (c) the call's fit against the reference's from m0's start
        fit = run.config["fit"]
        fitted = _fitted_loss_gap(W, gp, W0, gp0, _ref_fit(
            W0, gp0, X, y, fit["training_cycles"], fit["lr"]), X, y)
        _worst(gaps, embed_gap=embed, fit_gap=fit_gap,
               fitted_loss_gap=fitted,
               **_draw_gap(draw, idx, z_t, y, z_c, gp, s.eps.to(dev)))
    return gaps


def _ref_fit(W, gp, X, y, cycles: int, lr: float, quant=None):
    """The reference's own fit: ``cycles`` Adam steps of all parameters
    from (W, gp), in float32 with TF32 off, its extractor rounded to
    ``quant``."""
    params = {}
    for i, (w, b) in enumerate(W):
        params[f"w{i}"] = w.clone().requires_grad_()
        params[f"b{i}"] = b.clone().requires_grad_()
    params.update({k: v.clone().requires_grad_() for k, v in gp.items()})
    opt = Adam(params, lr)
    n = len(W)
    for _ in range(cycles):
        Wt = [(params[f"w{i}"], params[f"b{i}"]) for i in range(n)]
        with ref.exact():
            loss = ref.neg_mll(Wt, {k: params[k] for k in gp}, X, y, quant)
            grads = torch.autograd.grad(loss, list(params.values()))
        opt.step(dict(zip(params, grads)))
    return ([(params[f"w{i}"].detach(), params[f"b{i}"].detach())
             for i in range(n)], {k: params[k].detach() for k in gp})


def control_readings(run, compute_dtype=None, coord_dtype=None) -> dict:
    """The numbers of :func:`check` with the reference put in the program's
    place one precision below the configuration's: its extractor's layers
    on inputs and weights rounded to bfloat16 and the draw's posterior
    formed and factorised in float32 (the configuration's ``control``;
    the float8 and bfloat16 of the Unet cells' controls, passed in as
    ``compute_dtype`` and ``coord_dtype``, do not apply), on as many of the
    run's states as a check compares, after the reference's own fit. The
    fit's control is the extractor's backward on rounded operands at the
    control's activations (its loss at the fitted parameters, the same
    code on the same output, reads 0 and is left out), and the reference's
    fit with that extractor against its exact one."""
    st = _inputs(run)
    dev, cfg = run.device, run.config
    model, fit = cfg["model"], cfg["fit"]
    q = torch.bfloat16
    gaps = dict.fromkeys(CHECKS, 0.0)
    for s in st.states[:run.traffic["check_calls"]]:
        X, Xc = (torch.from_numpy(a).to(dev) for a in (s.X, s.Xc))
        y = torch.from_numpy(s.y).to(dev)
        W0 = ref.init_weights(model["indim"], model["embedim"],
                              torch.Generator().manual_seed(s.seed),
                              model["hidden_dim"], dev)
        gp0 = ref.init_gp(model["embedim"], dev)
        W, gp = _ref_fit(W0, gp0, X, y, fit["training_cycles"], fit["lr"])
        z_t, z_c = _ref_embed(W, X, Xc)
        embed = _max_gap(zip(_ref_embed(W, X, Xc, q), (z_t, z_c)))
        inputs0 = []
        with ref.exact(), torch.no_grad():
            q0 = ref.extract(W0, X, q, inputs0)
        l0, g_gp, g_fe, _ = _stage_grads(W0, gp0, y, q0, inputs0, q)
        r0, r_gp, r_fe, scales = _stage_grads(W0, gp0, y, q0, inputs0)
        fit_gap = max(_loss_gap(l0, r0), _rel(g_gp, r_gp),
                      _fe_gap(g_fe, r_fe, scales))
        Wq, gpq = _ref_fit(W0, gp0, X, y, fit["training_cycles"], fit["lr"],
                           q)
        fitted = _fitted_loss_gap(Wq, gpq, W0, gp0, (W, gp), X, y)
        eps = s.eps.to(dev).reshape(-1)
        with ref.exact():
            mean, cov = ref.posterior(z_t, y, z_c, gp, torch.float32)
            draw, _ = ref.draw(mean, cov, eps)
        del cov
        draw = draw.double().cpu().numpy()
        idx = np.array([int(np.argmax(draw))]) if np.isfinite(draw).all() \
            else np.array([0])
        _worst(gaps, embed_gap=embed, fit_gap=fit_gap,
               fitted_loss_gap=fitted,
               **_draw_gap(draw, idx, z_t, y, z_c, gp, eps))
    return gaps
