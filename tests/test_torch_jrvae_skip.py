"""The port's jrVAE with the generative-skip decoder (``jrVAE(...,
skip=True)``) against the benchmark's plain reference
(``benchmark/reference/jrvae.py``, imported by its path), on the CPU at
12² windows, hidden width 32 and depth 2, from the reference's seeded
weights; then what lets its training step replay from a CUDA graph on a
card: the capacity schedules on a device step count, the draws made up
front from one generator, and the graph's step function against the eager
loop on the same draws.

- The decoder's fused route (one ``spatial_mlp(..., skip=True)`` call: the
  plain version on the CPU, the kernels' residual variant on a card)
  against its layer-by-layer route and the reference: the ELBO 1e-5
  relative, each layer's gradient 1e-4 relative L2 (the same float32
  arithmetic in other orders, as ``test_torch_rvae_reference.py``'s);
- ``infocapacity`` with a 0-d tensor step count equal, to the bit, to its
  number path (the JAX package's), up to and past both maxima;
- a joint model's up-front draws (:meth:`_epoch_draws`,
  :meth:`_uniform_draws`): the permutation, the Gaussian noise, then each
  head's uniforms, in that order from the epoch's generator;
- an epoch of the eager loop on up-front draws and the same epoch as the
  graph's step function (``_graph_step``, a tensor step count) give the
  same weights, to the bit;
- the training steps are counted by the decoder's route.
"""

import importlib.util
import math
import os
import sys

import pytest
import torch

import atomai_tpu_torch as aoi
from atomai_tpu_torch.core import profiling
from atomai_tpu_torch.losses_metrics import vi_losses as tl

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
IN_DIM, BATCH, HIDDEN, LAYERS = (12, 12), 8, 32, 2
TOL_ELBO, TOL_GRAD = 1e-5, 1e-4


def _reference():
    """``benchmark/reference/jrvae.py`` (it imports ``reference.rvae``, so
    the benchmark's directory is on the path while it loads)."""
    sys.path.insert(0, BENCH)
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_reference_jrvae",
            os.path.join(BENCH, "reference", "jrvae.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.remove(BENCH)


ref = _reference()


def _fit(schedule=(5.0, 25000, 30)):
    return {"translation_prior": 0.1, "rotation_prior": math.pi / 2,
            "temperature": 0.67, "cont_capacity": list(schedule),
            "disc_capacity": list(schedule)}


def _model(seed, discrete_dim=(2,), fit=None):
    """A port jrVAE (skip decoder) on the CPU carrying the reference's
    seeded weights and the fit's options."""
    fit = fit or _fit()
    m = aoi.models.jrVAE(IN_DIM, latent_dim=2, discrete_dim=list(discrete_dim),
                         skip=True, numhidden_encoder=HIDDEN,
                         numhidden_decoder=HIDDEN, numlayers_encoder=LAYERS,
                         numlayers_decoder=LAYERS, device="cpu")
    p = ref.init_params(IN_DIM, 2, 3, discrete_dim, HIDDEN, LAYERS,
                        torch.Generator().manual_seed(seed))
    for part, net in (("encoder", m.encoder_net), ("decoder", m.decoder_net)):
        net.load_state_dict({k.split(".", 1)[1]: v for k, v in p.items()
                             if k.startswith(part + ".")}, strict=True)
    m.dx_prior = fit["translation_prior"]
    m.kdict_.update(phi_prior=fit["rotation_prior"],
                    temperature=fit["temperature"],
                    cont_capacity=fit["cont_capacity"],
                    disc_capacity=fit["disc_capacity"])
    return m, p


def _batch(seed, discrete_dim=(2,)):
    g = torch.Generator().manual_seed(seed + 100)
    return (torch.rand((BATCH,) + IN_DIM, generator=g),
            torch.randn(BATCH, 5, generator=g),
            [torch.rand(BATCH, k, generator=g) for k in discrete_dim])


def _port(m, x, eps, u, t):
    m.encoder_net.zero_grad(set_to_none=True)
    m.decoder_net.zero_grad(set_to_none=True)
    elbo = m.forward_compute_elbo(x, None, t, eps=eps, u=u)
    (-elbo).backward()
    return float(elbo.detach()), {
        f"{part}.{k}": q.grad.detach().clone() for part, net in
        (("encoder", m.encoder_net), ("decoder", m.decoder_net))
        for k, q in net.named_parameters()}


def _layer_gaps(got, want, heads):
    gaps = {}
    for layer in ref.layer_names(LAYERS, heads):
        keys = [k for k in want if k.rsplit(".", 1)[0] == layer]
        g = torch.cat([got[k].reshape(-1) for k in keys])
        w = torch.cat([want[k].reshape(-1) for k in keys])
        gaps[layer] = float(torch.linalg.norm(g - w) / torch.linalg.norm(w))
    return gaps


@pytest.mark.parametrize("seed,t,discrete_dim", [
    (0, 0, (2,)), (1, 3466, (2,)), (2, 40000, (2, 3))])
def test_fused_and_layerwise_skip_routes_match_the_reference(seed, t,
                                                             discrete_dim):
    """The ELBO and every layer's gradient at a step count before, at and
    past the capacities' maxima."""
    m, p = _model(seed, discrete_dim)
    assert m.decoder_net.fused() and m.decoder_net.skip
    x, eps, u = _batch(seed, discrete_dim)
    fused = _port(m, x, eps, u, t)
    m.decoder_net.fused = lambda: False
    layerwise = _port(m, x, eps, u, t)
    q = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    with ref.exact():
        loss = ref.loss(q, x, eps, u, ref.grid(IN_DIM), _fit(), t, LAYERS)
        grads = dict(zip(q, torch.autograd.grad(loss, list(q.values()))))
    for elbo, got in (fused, layerwise):
        assert abs(elbo + float(loss.detach())) <= \
            TOL_ELBO * abs(float(loss.detach()))
        gaps = _layer_gaps(got, grads, len(discrete_dim))
        assert max(gaps.values()) <= TOL_GRAD, gaps


def test_rvae_skip_takes_the_fused_route():
    """``test_torch_vae.py``'s ``rvae_skip`` case (held there to the JAX
    package's layer-by-layer skip decoder) runs the fused route."""
    m = aoi.models.rVAE((8, 8), skip=True, numhidden_decoder=16,
                        device="cpu")
    assert m.decoder_net.skip and m.decoder_net.fused()


@pytest.mark.parametrize("schedule", [(5.0, 25000, 30), (0.5, 7, 3.0)])
def test_infocapacity_takes_a_tensor_step_count(schedule):
    kl_c, kl_d = torch.tensor(2.7), torch.tensor(0.4)
    for t in (0, 1, 2, 7, 155, 156, 3465, 3466, 3467, 24999, 25000, 25001,
              123456, 10 ** 7):
        want = tl.infocapacity(kl_c, list(schedule), kl_d, list(schedule),
                               [2, 3], t)
        got = tl.infocapacity(kl_c, list(schedule), kl_d, list(schedule),
                              [2, 3], torch.tensor(t))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == torch.float32
            assert torch.equal(a, b), (t, a, b)
    cont = tl.infocapacity(kl_c, list(schedule), num_iter=torch.tensor(99))
    assert torch.equal(cont, tl.infocapacity(kl_c, list(schedule),
                                             num_iter=99))


def _up_front(m, monkeypatch):
    """The card's draws on the CPU: up front, on the eager route."""
    monkeypatch.setattr(m, "_noise_up_front", lambda: True)
    monkeypatch.setattr(m, "_graphed", lambda: False)


def test_up_front_draws_come_from_one_generator_in_order(monkeypatch):
    m, _ = _model(0, (2, 3))
    assert m._static_draws()
    _up_front(m, monkeypatch)
    N, bs, nb = 50, 8, 6
    g = torch.Generator().manual_seed(7)
    perm, eps = m._epoch_draws(g, N, bs, nb)
    u = m._uniform_draws(g, nb, bs)
    h = torch.Generator().manual_seed(7)
    assert torch.equal(perm, torch.randperm(N, generator=h)[:nb * bs]
                       .view(nb, bs))
    assert torch.equal(eps, torch.randn((nb, bs, 5), generator=h))
    assert [tuple(t.shape) for t in u] == [(nb, bs, 2), (nb, bs, 3)]
    for t, k in zip(u, (2, 3)):
        assert torch.equal(t, torch.rand((nb, bs, k), generator=h))


def _short_capacity_model(kind):
    """A model whose ELBO reads its step count, on a 6-step capacity
    schedule: the skip jrVAE, and a VAE and an rVAE with ``capacity``."""
    if kind == "jrVAE":
        return _model(5, fit=_fit((2.0, 6, 30.0)))[0]
    m = getattr(aoi.models, kind)(IN_DIM, capacity=[2.0, 6, 30.0], seed=5,
                                  numhidden_encoder=HIDDEN,
                                  numhidden_decoder=HIDDEN, device="cpu")
    if kind == "rVAE":
        m.dx_prior = 0.1
        m.kdict_["phi_prior"] = math.pi / 2
    return m


@pytest.mark.parametrize("kind", ["jrVAE", "VAE", "rVAE"])
def test_graph_step_is_the_eager_loop_on_up_front_draws(monkeypatch, kind):
    """An epoch on the eager route (Python step counts) and the same
    epoch as ``_graph_step`` calls (tensor step counts, the draws as the
    graph's inputs), from the same state and draws, at step counts across
    a short capacity schedule's maxima: the same weights, to the bit."""
    X = torch.rand((4 * BATCH,) + IN_DIM,
                   generator=torch.Generator().manual_seed(3)).numpy()
    models = []
    for _ in range(2):
        m = _short_capacity_model(kind)
        assert m._static_draws()
        _up_front(m, monkeypatch)
        m.compile_trainer((X, None), training_cycles=1, batch_size=BATCH)
        m.num_iter = 3
        models.append(m)
    eager, graph = models
    g = torch.Generator().manual_seed(11)
    perm, eps = eager._epoch_draws(g, len(X), BATCH, 4)
    u = eager._uniform_draws(g, 4, BATCH)
    assert (u is None) == (kind != "jrVAE")
    eager.encoder_net.train()
    eager.decoder_net.train()
    eager._train_epoch_eager(perm, eps, u, g)
    graph.encoder_net.train()
    graph.decoder_net.train()
    for i in range(4):
        graph._graph_step(perm[i], eps[i], torch.tensor(3 + i),
                          *([t[i] for t in u] if u else []))
    for a, b in zip(eager.parameters(), graph.parameters()):
        assert torch.equal(a, b)


def test_training_steps_are_counted_by_decoder_route(tmp_path):
    X = torch.rand((3 * BATCH,) + IN_DIM,
                   generator=torch.Generator().manual_seed(4)).numpy()
    names = ("vae.decoder_fused_step", "vae.decoder_layerwise_step")
    for fused in (True, False):
        m, _ = _model(1)
        if not fused:
            m.decoder_net.fused = lambda: False
        before = [profiling.summary()["counters"].get(k, 0) for k in names]
        m.fit(X, training_cycles=2, batch_size=BATCH, verbose=False,
              filename=str(tmp_path / f"j{fused}"))
        after = [profiling.summary()["counters"].get(k, 0) for k in names]
        steps = 2 * (len(X) // BATCH)
        assert [b - a for a, b in zip(before, after)] == \
            ([steps, 0] if fused else [0, steps])
