"""The rVAE fit cell (``rvae48.fit``) at a small size on the CPU: a sound
run is correct and reads its per-layer metrics; planted faults in the
program come out not correct (a decoder row dropped, the rotation's sign
flipped, a step skipped); the control fails a number; the frozen work
counts are the hand counts; each new reader gives its number on a
synthetic context and None where its counters or kernels are absent; the
cell's plain modules import nothing of the program. ``-m card`` runs the
control at full size."""

import ast
import copy
import math
import os

import pytest
import torch

import controls
import harness
import roofline
import roofline_vae
import tracing
from conftest import BENCH, tiny

CELL = "rvae48.fit"


def tiny_rvae(bench):
    """The cell on a 160² frame's 12² windows (64 of them, 8 steps of 8
    an epoch) at the published widths: two warm-up epochs, two checked and
    two traced calls."""
    cell = tiny(harness.load_cell(bench, CELL))
    cfg = copy.deepcopy(cell.config)
    cfg["data"]["frame"].update(size=160)
    cfg["model"]["in_dim"] = [12, 12]
    cfg["fit"]["batch_size"] = 8
    cell.config = cfg
    cell.traffic = dict(cell.traffic, warmup_epochs=2, check_calls=2,
                        traced_requests=2)
    return cell


def _run(bench, trace=False):
    return harness.run_cell(tiny_rvae(bench), 2 ** 31 + 17, 0.5, trace,
                            torch.device("cpu"), 0.0)["result"]


def test_sound_run_is_correct_and_reads_its_metrics(bench):
    res = _run(bench, trace=True)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["checks"]) == {"elbo_gap", "grad_gap", "fitted_elbo_gap"}
    m = res["metrics"]
    for name in ("vae_fit_mfu", "host_wait_ms"):
        assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0
    # on the CPU every step is eager, and no kernel of the card runs
    assert m["vae_graph_share"]["value"] == 0.0
    assert "spatial_mlp_fwd_roofline" not in m
    assert "spatial_mlp_bwd_roofline" not in m


def _dropped_row(monkeypatch):
    from atomai_tpu_torch.nets import ed
    orig = ed.spatial_mlp

    def dropped(*args, **kw):
        y = orig(*args, **kw).clone()
        y[:, :, 0] = 0.0
        return y
    monkeypatch.setattr(ed, "spatial_mlp", dropped)


def _rotation_sign(monkeypatch):
    from atomai_tpu_torch.models.dgm import vae
    orig = vae.transform_coordinates
    monkeypatch.setattr(vae, "transform_coordinates",
                        lambda coord, phi, dx=0: orig(coord, -phi, dx))


def _skipped_step(monkeypatch):
    orig = torch.optim.Adam.step
    calls = [0]

    def step(self, *a, **kw):
        calls[0] += 1
        if calls[0] % 3:
            return orig(self, *a, **kw)
    monkeypatch.setattr(torch.optim.Adam, "step", step)


@pytest.mark.parametrize("fault,number", [
    (_dropped_row, "elbo_gap"),
    (_rotation_sign, "elbo_gap"),
    (_skipped_step, "fitted_elbo_gap"),
])
def test_fault_is_not_correct(bench, monkeypatch, fault, number):
    fault(monkeypatch)
    res = _run(bench)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"]


def test_windows_are_seeded(bench):
    drv = harness.load_module("drivers", "vae_fit")
    cfg = tiny_rvae(bench).config
    a, b, c = (drv.windows(cfg, s) for s in (2 ** 33 + 1, 2 ** 33 + 1,
                                              2 ** 33 + 2))
    assert a.shape == (64, 12, 12) and (a == b).all() and not (a == c).all()


def test_control_fails_a_number_on_the_cpu(bench):
    c = tiny_rvae(bench)
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


def test_frozen_counts_are_the_hand_counts():
    """The spatial-MLP pair at the cell's shapes (B = 100, n = 2,304, H =
    128, L = 2: M = 230,400 rows), as the port counts them."""
    from atomai_tpu_torch.ops import spatial_mlp as sm
    M, H, L = 230_400, 128, 2
    fwd, bwd = roofline_vae.spatial_mlp_flops(100, 2304, H, L)
    assert fwd == 2 * M * (2 * H + L * H * H + H) == 15_276_441_600
    assert bwd == 2 * M * (8 * H + 3 * L * H * H) == 45_770_342_400
    assert roofline_vae.spatial_mlp_bytes(100, 2304, H, L) == \
        (2_950_148, 4_978_696)
    for shape in ((100, 2304, H, L), (8, 144, 64, 1), (128, 1024, 256, 3)):
        assert roofline_vae.spatial_mlp_flops(*shape) == \
            sm.spatial_mlp_flops(*shape)
        assert roofline_vae.spatial_mlp_bytes(*shape) == \
            sm.spatial_mlp_bytes(*shape)
    f, b = roofline_vae.bound_s(100, 2304, H, L)
    assert f == fwd / roofline.H100_BF16_FLOPS
    assert b == bwd / roofline.H100_BF16_FLOPS


def test_reference_step_flops_are_the_hand_count(bench):
    """The reference's training step at the cell's shapes, forward and
    autograd backward: the decoder's products 2M(2H + LH² + H) forward and
    2M(6H + 2LH²) backward (no recompute), the rotation's batched product
    2·M·2·2 each way, fc_latent's 2·B·2·H forward and twice that back, the
    encoder's 2B(2304·128 + 128·128 + 2·128·5) forward, as much for its
    weights' gradients and 2B(128·128 + 2·128·5) for its inputs'."""
    drv = harness.load_module("drivers", "vae_fit")
    M, H, L, B = 230_400, 128, 2, 100
    enc = 2 * B * (2304 * 128 + 128 * 128 + 2 * 128 * 5)
    want = (2 * M * (2 * H + L * H * H + H) + 2 * M * (6 * H + 2 * L * H * H)
            + 2 * (2 * M * 2 * 2) + 3 * (2 * B * 2 * H) + 2 * enc
            + 2 * B * (128 * 128 + 2 * 128 * 5))
    cfg = harness.load_cell(bench, CELL).config
    assert drv.step_flops(cfg["model"], B) == want == 45_961_728_000


def _ctx(untraced=None, traced=None, trace=None, constants=None):
    return harness.ReadContext(
        harness.Part(requests=3, seconds=2.0, counts=untraced or {}),
        harness.Part(requests=2, seconds=1.0, counts=traced or {}),
        trace, {}, constants or {})


KERNELS = {
    "void (anonymous namespace)::fwd_wgmma<128>(float const*, float "
    "const*, float const*)": 0.004,
    "void (anonymous namespace)::pack_kernel(float const*, __nv_bfloat16*, "
    "int, int, int)": 0.002,
    "void (anonymous namespace)::bwd_wgmma<128>(float const*, float "
    "const*)": 0.020,
    "void (anonymous namespace)::reduce_kernel(float const*, int, int, int, "
    "float*, float const*, int, int, int, float*)": 0.001,
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >"
    "(at::native::ReduceOp<float>)": 0.5,
    "Memcpy DtoH (Device -> Pageable)": 0.3,
}


def test_readers_on_a_synthetic_context():
    read = {n: harness.load_module("metrics", n).read for n in (
        "vae_fit_mfu", "spatial_mlp_fwd_roofline", "spatial_mlp_bwd_roofline",
        "vae_graph_share")}
    c = {"flops_per_step": 4e10, "fwd_bound_s": 1e-5, "bwd_bound_s": 4e-5}
    trace = tracing.TraceSummary(window_s=1.0, busy_s=0.5, device_events=9,
                                 by_name=dict(KERNELS))
    ctx = _ctx({"steps": 100, "vae_graph_replay": 100},
               {"steps": 20, "vae_graph_replay": 20}, trace, c)
    assert read["vae_fit_mfu"](ctx) == pytest.approx(
        100 * 4e10 * 100 / 2.0 / 989e12)
    assert read["spatial_mlp_fwd_roofline"](ctx) == pytest.approx(
        100 * 1e-5 * 20 / (0.004 + 0.001))
    assert read["spatial_mlp_bwd_roofline"](ctx) == pytest.approx(
        100 * 4e-5 * 20 / (0.020 + 0.001 + 0.001))
    assert read["vae_graph_share"](ctx) == 100.0
    mixed = _ctx({"vae_graph_replay": 30, "vae_eager_step": 10},
                 {"vae_graph_replay": 10})
    assert read["vae_graph_share"](mixed) == 80.0


def test_readers_give_none_without_their_inputs():
    c = {"flops_per_step": 4e10, "fwd_bound_s": 1e-5, "bwd_bound_s": 4e-5}
    no_kernels = tracing.TraceSummary(window_s=1.0, busy_s=0.5,
                                      device_events=2,
                                      by_name={"Memcpy DtoH (x)": 0.1})
    steps = {"steps": 5, "samples": 1}
    names = ("vae_fit_mfu", "spatial_mlp_fwd_roofline",
             "spatial_mlp_bwd_roofline", "vae_graph_share")
    cases = [(_ctx(), names),
             (_ctx(steps, steps, None, {}), names),
             (_ctx(steps, steps, no_kernels, c), names[1:])]
    for ctx, absent in cases:
        for name in absent:
            assert harness.load_module("metrics", name).read(ctx) is None, \
                name


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("rel", ["reference/rvae.py", "roofline_vae.py"])
def test_plain_modules_import_nothing_of_the_program(rel):
    got = set(_imports(os.path.join(BENCH, rel)))
    assert not got & {"atomai_tpu_torch", *harness.FORBIDDEN}, got
    if rel.startswith("reference"):
        assert got <= {"contextlib", "math", "typing", "numpy", "torch"}
