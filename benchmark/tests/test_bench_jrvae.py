"""The jrVAE fit cell (``jrvae48.fit``) at a small size on the CPU: a sound
run is correct and reads its per-layer metrics; planted faults in the
program come out not correct (the step count frozen at the value a graph
would capture, one discrete latent's uniforms reused for every step, the
skip decoder's residual dropped after its first layer, h0 given a tanh);
the control fails a number; the reference's step counts the hand count;
the new reader gives its number on a synthetic context and None where its
counters are absent; the cell's plain modules import nothing of the
program. ``-m card`` runs the control at full size.

At full size the window runs past the capacities' 25,000 steps, so the
check's epoch runs with both capacities at their maxima; the small cell's
few steps reach them only on a schedule as short as its epochs (25 steps
here), which the step-count fault needs to show."""

import copy
import math

import pytest
import torch

import controls
import harness
import tracing
from conftest import tiny
from test_bench_rvae import _ctx, _imports

CELL = "jrvae48.fit"
SHORT = [5.0, 25, 30]


def tiny_jrvae(bench):
    """The cell on a 160² frame's 12² windows (64 of them, 8 steps of 8
    an epoch) at the published widths, on a 25-step capacity schedule:
    two warm-up epochs, two checked and two traced calls."""
    cell = tiny(harness.load_cell(bench, CELL))
    cfg = copy.deepcopy(cell.config)
    cfg["data"]["frame"].update(size=160)
    cfg["model"]["in_dim"] = [12, 12]
    cfg["fit"].update(batch_size=8, cont_capacity=SHORT, disc_capacity=SHORT)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, warmup_epochs=2, check_calls=2,
                        traced_requests=2)
    return cell


def _run(bench, trace=False):
    return harness.run_cell(tiny_jrvae(bench), 2 ** 31 + 17, 0.5, trace,
                            torch.device("cpu"), 0.0)["result"]


def test_sound_run_is_correct_and_reads_its_metrics(bench):
    res = _run(bench, trace=True)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["checks"]) == {"elbo_gap", "grad_gap", "fitted_elbo_gap",
                                  "alpha_gap"}
    m = res["metrics"]
    for name in ("vae_fit_mfu", "host_wait_ms"):
        assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0
    # on the CPU every step is eager, on the fused route's plain version
    assert m["vae_graph_share"]["value"] == 0.0
    assert m["decoder_kernel_share"]["value"] == 100.0
    assert "spatial_mlp_bwd_roofline" not in m


def _frozen_step_count(monkeypatch):
    from atomai_tpu_torch.trainers import vitrainer
    elbo = vitrainer.viBaseTrainer._elbo
    monkeypatch.setattr(
        vitrainer.viBaseTrainer, "_elbo",
        lambda self, x, y, num_iter, g, eps=None, u=None: elbo(
            self, x, y, vitrainer.GRAPH_WARMUP, g, eps, u))


def _reused_uniforms(monkeypatch):
    from atomai_tpu_torch.trainers import vitrainer
    draw = vitrainer.viBaseTrainer.reparameterize_discrete
    first = {}

    def reused(alpha, tau, generator=None, u=None):
        if u is None:
            u = torch.rand(alpha.shape, generator=generator,
                           device=alpha.device)
        return draw(alpha, tau, generator, first.setdefault("u", u))
    monkeypatch.setattr(vitrainer.viBaseTrainer, "reparameterize_discrete",
                        staticmethod(reused))


def _hidden_fault(monkeypatch, h0_tanh):
    from atomai_tpu_torch.ops import spatial_mlp as sm

    def hidden(xT, zb, Wc, bc, Ws, bs, skip=False):
        x = xT.transpose(1, 2)
        h0 = x @ Wc + bc + zb[:, None, :]
        h0 = torch.tanh(h0) if h0_tanh else h0
        hs, ts = [h0], []
        for l in range(Ws.shape[0]):
            ts.append(torch.tanh(hs[-1] @ Ws[l] + bs[l]))
            # the residual dropped after the first layer
            hs.append(ts[-1] if l == 0 and not h0_tanh else ts[-1] + h0)
        return x, hs, ts
    monkeypatch.setattr(sm, "_hidden", hidden)


@pytest.mark.parametrize("fault,number", [
    (_frozen_step_count, "fitted_elbo_gap"),
    (_reused_uniforms, "elbo_gap"),
    (lambda mp: _hidden_fault(mp, False), "elbo_gap"),
    (lambda mp: _hidden_fault(mp, True), "elbo_gap"),
])
def test_fault_is_not_correct(bench, monkeypatch, fault, number):
    fault(monkeypatch)
    res = _run(bench)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"]


def test_layerwise_skip_decoder_cannot_run_the_cell(bench, monkeypatch):
    """A program without the kernels' residual variant (its skip decoder
    not fused) stops before its fit, with no result."""
    from atomai_tpu_torch.models.dgm import jrvae
    from atomai_tpu_torch.nets import ed
    monkeypatch.setattr(ed.rDecoderNet, "fused", lambda self: False)
    monkeypatch.setattr(jrvae.jrVAE, "fit",
                        lambda *a, **k: pytest.fail("fit ran"))
    with pytest.raises(RuntimeError, match="cannot run"):
        _run(bench)


def test_control_fails_a_number_on_the_cpu(bench):
    c = tiny_jrvae(bench)
    got = controls.readings(c, 2 ** 31 + 7, "cpu")["control"]
    assert set(got) == set(c.limits)
    assert all(v >= 0 for v in got.values())
    assert any(got[k] > lim for k, lim in c.limits.items()), got


@pytest.mark.card
def test_control_fails_a_number(bench, card):
    c = harness.load_cell(bench, CELL)
    for seed in (11, 12, 13):
        got = controls.readings(c, seed, card)["control"]
        assert any(got[k] > lim for k, lim in c.limits.items()), (seed, got)


def test_reference_step_flops_are_the_hand_count(bench):
    """The reference's training step at the cell's shapes, forward and
    autograd backward: rvae48's count (``test_bench_rvae.py``) with the
    decoder's 4 latents (fc_latent 3 · 2·B·4·H) and the encoder's
    discrete head (fc13: 2·B·128·2 forward, weights' and inputs'
    gradients); the residual adds no product."""
    drv = harness.load_module("drivers", "jrvae_fit")
    M, H, L, B = 230_400, 128, 2, 100
    enc = 2 * B * (2304 * 128 + 128 * 128 + 2 * 128 * 5 + 128 * 2)
    want = (2 * M * (2 * H + L * H * H + H) + 2 * M * (6 * H + 2 * L * H * H)
            + 2 * (2 * M * 2 * 2) + 3 * (2 * B * 4 * H) + 2 * enc
            + 2 * B * (128 * 128 + 2 * 128 * 5 + 128 * 2))
    cfg = harness.load_cell(bench, CELL).config
    assert drv.step_flops(cfg, B) == want == 45_962_035_200


def test_decoder_kernel_share_reader():
    read = harness.load_module("metrics", "decoder_kernel_share").read
    trace = tracing.TraceSummary(window_s=1.0, busy_s=0.5, device_events=1,
                                 by_name={})
    ctx = _ctx({"steps": 30, "vae_decoder_fused_step": 30},
               {"steps": 10, "vae_decoder_fused_step": 10}, trace)
    assert read(ctx) == 100.0
    mixed = _ctx({"vae_decoder_fused_step": 30,
                  "vae_decoder_layerwise_step": 10},
                 {"vae_decoder_layerwise_step": 10})
    assert read(mixed) == 60.0
    assert read(_ctx({"steps": 5, "samples": 1}, {"steps": 5})) is None


@pytest.mark.parametrize("rel", ["reference/jrvae.py",
                                 "metrics/decoder_kernel_share.py"])
def test_plain_modules_import_nothing_of_the_program(rel):
    import os
    from conftest import BENCH
    got = set(_imports(os.path.join(BENCH, rel)))
    assert not got & {"atomai_tpu_torch", *harness.FORBIDDEN}, got
    if rel.startswith("reference"):
        assert got <= {"math", "typing", "numpy", "torch", "reference"}
