"""The active-learning cell (``dkl64.suggest``) at a small size on the
CPU: a sound run is correct and reads its per-layer metrics; planted
faults in the program come out not correct (a draw formed in float32, a
draw from the posterior variance alone, a fit without the extractor's
gradient, a fit whose steps leave the state unchanged or take half the
step size); the control fails the draw; the cell's plain modules import
nothing of the program. ``-m card`` runs the control at full size and
holds the draw's roofline to the kernels of a float64 Cholesky factor."""

import ast
import copy
import math
import os

import numpy as np
import pytest
import torch

import controls
import harness
from conftest import BENCH, tiny

CELL = "dkl64.suggest"


def tiny_dkl(bench):
    """The cell on a 40^2 frame (1,089 patches): two states of 48 and 96
    measured patches, five fit cycles, two warm-up and two checked calls."""
    cell = tiny(harness.load_cell(bench, CELL))
    cfg = copy.deepcopy(cell.config)
    cfg["data"]["frame"].update(size=40)
    cfg["fit"].update(training_cycles=5, print_loss=5)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, states=2, n_min=48, n_max=96,
                        warmup_calls=2, check_calls=2)
    return cell


def _run(bench, trace=False):
    return harness.run_cell(tiny_dkl(bench), 2 ** 31 + 13, 0.3, trace,
                            torch.device("cpu"), 0.0)["result"]


def test_sound_run_is_correct_and_reads_its_metrics(bench):
    res = _run(bench, trace=True)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["checks"]) == {"embed_gap", "fit_gap", "fitted_loss_gap",
                                  "draw_gap", "index_gap"}
    for name in ("dkl_fit_ms", "thompson_ms", "host_wait_ms"):
        v = res["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, name


def test_states_are_seeded(bench):
    drv = harness.load_module("drivers", "ae_step")
    cell = tiny_dkl(bench)
    a, b, c = (drv._inputs(harness.Run(cell, s, 0.0, False,
                                       torch.device("cpu"))).states
               for s in (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2))
    assert [len(s.X) for s in a] == [48, 96]
    assert all(len(s.X) + len(s.Xc) == 33 * 33 for s in a)
    assert all(np.array_equal(x.X, y.X) and torch.equal(x.eps, y.eps)
               for x, y in zip(a, b))
    assert not np.array_equal(a[0].X, c[0].X)


def _float32_draw(monkeypatch):
    from atomai_tpu_torch.models.dklgp import dklgpr
    monkeypatch.setattr(dklgpr, "DRAW_DTYPE", torch.float32)


def _variance_draw(monkeypatch):
    from atomai_tpu_torch.models import dklGPR
    orig = dklGPR._draw_posterior

    def diagonal(self, Xs):
        mean, cov = orig(self, Xs)
        return mean, torch.diag_embed(cov.diagonal(dim1=-2, dim2=-1))
    monkeypatch.setattr(dklGPR, "_draw_posterior", diagonal)


def _fit_without_extractor_grad(monkeypatch):
    from atomai_tpu_torch.trainers import gptrainer
    from atomai_tpu_torch.nets.gp import scale_to_bounds

    def loss_backward(self):
        with self.precision.tf32_scope():
            z = self._block_fe(self.X).detach()
        gp, y = self._block_gp()
        with gptrainer._FULL.tf32_scope():
            loss = self._gp_loss(gp, scale_to_bounds(z), y)
            loss.backward()
        return loss
    monkeypatch.setattr(gptrainer.dklGPTrainer, "_loss_backward",
                        loss_backward)


def _step_without_update(monkeypatch):
    from atomai_tpu_torch.trainers import gptrainer

    def step(self):
        self.optimizer.zero_grad(set_to_none=True)
        return self._loss_backward().detach()
    monkeypatch.setattr(gptrainer.GPTrainer, "_step", step)


def _half_step_size(monkeypatch):
    from atomai_tpu_torch.trainers import gptrainer
    reset = gptrainer.GPTrainer._reset_optimizer

    def halved(self):
        self.lr /= 2
        reset(self)
    monkeypatch.setattr(gptrainer.GPTrainer, "_reset_optimizer", halved)


@pytest.mark.parametrize("fault,number", [
    (_variance_draw, "draw_gap"),
    (_fit_without_extractor_grad, "fit_gap"),
    (_step_without_update, "fitted_loss_gap"),
    (_half_step_size, "fitted_loss_gap"),
])
def test_fault_is_not_correct(bench, monkeypatch, fault, number):
    fault(monkeypatch)
    res = _run(bench)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"]


def test_float32_draw_fails_the_run(bench, monkeypatch):
    """Formed in float32 the candidates' covariance does not factorise
    with its 1e-6 jitter even at this size: the program raises in the
    warm-up, so the run prints no result."""
    _float32_draw(monkeypatch)
    with pytest.raises(torch.linalg.LinAlgError, match="float32"):
        _run(bench)


def test_control_fails_the_draw_on_the_cpu(bench):
    c = tiny_dkl(bench)
    got = controls.readings(c, 2 ** 31 + 7, "cpu")["control"]
    assert set(got) == set(c.limits)
    assert got["draw_gap"] > c.limits["draw_gap"]
    assert all(v >= 0 for v in got.values())


@pytest.mark.card
def test_control_fails_the_draw(bench, card):
    c = harness.load_cell(bench, CELL)
    for seed in (11, 12, 13):
        got = controls.readings(c, seed, card)["control"]
        assert got["draw_gap"] > c.limits["draw_gap"], (seed, got)


@pytest.mark.card
def test_draw_roofline_selects_the_float64_factor(card):
    """On the card, the kernels of a float64 Cholesky factor (but torch's
    own elementwise ones and copies) are those the roofline's time sums:
    all but 1% of their time."""
    from torch.profiler import ProfilerActivity, profile
    m = harness.load_module("metrics", "draw_roofline")
    a = torch.randn(2048, 2048, dtype=torch.float64, device=card)
    a = a @ a.T + 2048 * torch.eye(2048, dtype=torch.float64, device=card)
    torch.linalg.cholesky_ex(a)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.linalg.cholesky_ex(a)
        torch.cuda.synchronize(card)
    times = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and "at::native" not in e.name \
                and not e.name.startswith("Mem"):
            times[e.name] = times.get(e.name, 0) + e.device_time_total
    chosen = sum(t for n, t in times.items() if m.is_f64_linalg(n))
    assert times and chosen >= 0.99 * sum(times.values()), times


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", ["reference/dkl.py", "roofline_gp.py"])
def test_plain_modules_import_nothing_of_the_program(rel):
    got = set(_imports(os.path.join(BENCH, rel)))
    assert not got & {"atomai_tpu_torch", *harness.FORBIDDEN}, got


def test_extract_grads_is_the_extractors_backward():
    from reference import dkl as ref
    g = torch.Generator().manual_seed(0)
    W = ref.init_weights(8, 2, g, (16, 12))
    X = torch.randn(20, 8, generator=g)
    Wr = [(w.clone().requires_grad_(), b.clone().requires_grad_())
          for w, b in W]
    inputs = []
    out = ref.extract(Wr, X, inputs=inputs)
    d = torch.randn(out.shape, generator=g)
    out.backward(d)
    grads, _ = ref.extract_grads(W, [x.detach() for x in inputs], d)
    for (gw, gb), (w, b) in zip(grads, Wr):
        torch.testing.assert_close(gw, w.grad)
        torch.testing.assert_close(gb, b.grad)


def test_draw_roofline_selects_float64_linear_algebra():
    m = harness.load_module("metrics", "draw_roofline")
    assert m.is_f64_linalg(
        "sm90_xmma_gemm_f64f64_f64f64_f64_nt_n_tilesize64x128x32_stage3")
    assert m.is_f64_linalg("void kernel<getrf_wo_pivot_params_<double, 0,"
                           " 256, 1, 64, 64, 68, 8, 1, 1> >(int)")
    assert not m.is_f64_linalg("void kernel<getrf_wo_pivot_params_<float,"
                               " 0, 256, 1, 64, 64, 68, 8, 1, 1> >(int)")
    assert not m.is_f64_linalg("void at::native::elementwise_kernel<128, 2,"
                               " CUDAFunctor_add<double> >")
    assert not m.is_f64_linalg("Memcpy HtoD (Pageable -> Device)")
