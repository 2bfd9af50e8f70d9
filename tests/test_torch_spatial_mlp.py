"""The port's fused spatial-decoder MLP against the JAX package's.

- The plain versions (forward and explicit backward) against the JAX
  reference forward and ``jax.grad`` of it, in float32: 1e-5 after
  dividing by each output's scale.
- The plain versions against the JAX Pallas kernel pair run in interpret
  mode, as `tests/ops/test_pallas_mlp.py` runs it: 5e-2 after dividing by
  each output's scale, since the kernel rounds its operands to bf16.
- The explicit backward against torch autograd of the plain forward.
- The wrapper's dispatch: a CPU tensor takes the plain version and counts
  no launch; the CUDA entry points raise on a CPU tensor.
- The decoder's routing, and its two routes computing one function.

The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py``.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from atomai_tpu.ops import pallas_mlp
from atomai_tpu_torch.core import profiling
from atomai_tpu_torch.nets import rDecoderNet
from atomai_tpu_torch.ops import spatial_mlp as sm

torch.set_num_threads(1)

NAMES = ["dx", "dzb", "dWc", "dbc", "dWs", "dbs", "dWo", "dbo"]
TIGHT = 1e-5     # float32 plain versions against float32 XLA
KERNEL = 5e-2    # against the bf16-operand Pallas kernel


def _inputs(B, n, H, L, seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (B, 2, n)).astype(np.float32),
            (rng.randn(B, H) * 0.3).astype(np.float32),
            (rng.randn(2, H) / 2).astype(np.float32),
            (rng.randn(1, H) * 0.1).astype(np.float32),
            (rng.randn(L, H, H) / np.sqrt(H)).astype(np.float32),
            (rng.randn(L, H) * 0.1).astype(np.float32),
            (rng.randn(H, 1) / np.sqrt(H)).astype(np.float32),
            (rng.randn(1, 1) * 0.1).astype(np.float32)], \
        (rng.randn(B, 1, n) * 0.1).astype(np.float32)


def _port(args, gy):
    t = [torch.from_numpy(a) for a in args]
    y = sm.spatial_mlp_reference(*t).numpy()
    grads = sm.spatial_mlp_backward_reference(*t, torch.from_numpy(gy))
    return y, [g.numpy() for g in grads]


def _jax_grads(fn, args, gy):
    def loss(*a):
        return jnp.sum(fn(*a) * gy)
    return [np.asarray(g) for g in
            jax.grad(loss, argnums=tuple(range(8)))(*map(jnp.asarray, args))]


def _assert_scaled(got, want, tol, name):
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol,
                               rtol=0, err_msg=name)


@pytest.mark.parametrize("B,n,H,L", [(3, 50, 32, 2), (2, 37, 16, 0),
                                     (2, 64, 48, 3)])
def test_plain_versions_match_jax_reference(B, n, H, L):
    args, gy = _inputs(B, n, H, L, seed=n)
    y, grads = _port(args, gy)
    with jax.default_matmul_precision("highest"):
        y_ref = np.asarray(pallas_mlp.spatial_mlp_reference(
            *map(jnp.asarray, args)))
        g_ref = _jax_grads(pallas_mlp.spatial_mlp_reference, args, gy)
    assert y.shape == (B, 1, n)
    _assert_scaled(y, y_ref, TIGHT, "y")
    for name, a, b in zip(NAMES, grads, g_ref):
        assert a.shape == b.shape, name
        if b.size:
            _assert_scaled(a, b, TIGHT, name)


@pytest.mark.parametrize("n", [512, 2560])
def test_plain_versions_match_pallas_kernel(n):
    """B = 4, H = 128, L = 2, as the JAX package's kernel test; n = 2560 is
    its tail case (n > MAX_TILE, not a multiple of it)."""
    args, gy = _inputs(4, n, 128, 2, seed=n + 1)
    y, grads = _port(args, gy)
    with pltpu.force_tpu_interpret_mode():
        y_k = np.asarray(pallas_mlp.spatial_mlp(*map(jnp.asarray, args)))
        g_k = _jax_grads(pallas_mlp.spatial_mlp, args, gy)
    _assert_scaled(y, y_k, KERNEL, "y")
    for name, a, b in zip(NAMES, grads, g_k):
        _assert_scaled(a, b, KERNEL, name)


@pytest.mark.parametrize("L", [0, 1, 3])
def test_backward_reference_matches_autograd(L):
    args, gy = _inputs(3, 40, 32, L, seed=L)
    t = [torch.from_numpy(a).double().requires_grad_() for a in args]
    gy_t = torch.from_numpy(gy).double()
    auto = torch.autograd.grad((sm.spatial_mlp_reference(*t) * gy_t).sum(),
                               t, allow_unused=True, materialize_grads=True)
    explicit = sm.spatial_mlp_backward_reference(
        *[a.detach() for a in t], gy_t)
    for name, a, b in zip(NAMES, explicit, auto):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)


def _launches():
    counters = profiling.summary()["counters"]
    return (counters.get("spatial_mlp.forward_launches", 0),
            counters.get("spatial_mlp.backward_launches", 0))


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    args, gy = _inputs(2, 30, 16, 1, seed=5)
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    before = _launches()
    y = sm.spatial_mlp(*t)
    (y * torch.from_numpy(gy)).sum().backward()
    assert _launches() == before
    torch.testing.assert_close(y.detach(), sm.spatial_mlp_reference(
        *[a.detach() for a in t]), rtol=0, atol=0)
    explicit = sm.spatial_mlp_backward_reference(
        *[a.detach() for a in t], torch.from_numpy(gy))
    for name, a, b in zip(NAMES, [a.grad for a in t], explicit):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


def test_cuda_entry_points_raise_on_cpu_tensors():
    args, gy = _inputs(2, 30, 16, 1, seed=6)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        sm.spatial_mlp_forward_cuda(*t)
    with pytest.raises(ValueError, match="CUDA"):
        sm.spatial_mlp_backward_cuda(*t, torch.from_numpy(gy))
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        sm.spatial_mlp(*[a.to("meta") for a in t])


@pytest.mark.parametrize("bad,match", [
    (lambda a: [a[0][:, :1]] + a[1:], "xT"),
    (lambda a: a[:1] + [a[1][:, :8]] + a[2:], "zb"),
    (lambda a: a[:4] + [a[4][:, :, :8]] + a[5:], "Ws"),
    (lambda a: a[:6] + [a[6].T] + a[7:], "Wo"),
])
def test_kernel_entry_points_check_shapes(bad, match):
    args, _ = _inputs(2, 30, 16, 1, seed=7)
    with pytest.raises(ValueError, match=match):
        sm.spatial_mlp_forward_cuda(*bad([torch.from_numpy(a)
                                          for a in args]))


@pytest.mark.parametrize("H,ok", [(16, True), (48, True), (128, True),
                                  (512, True), (8, False), (100, False),
                                  (528, False)])
def test_kernel_range(H, ok):
    assert sm.mlp_shapes_supported(H) is ok


@pytest.mark.parametrize("kwargs,fused", [
    ({}, True), ({"skip": True}, False), ({"hidden_dim": 100}, False),
    ({"out_dim": (8, 8, 2)}, False), ({"num_layers": 0}, True)])
def test_decoder_routes_by_shape_and_routes_agree(kwargs, fused):
    cfg = dict(out_dim=(8, 8), latent_dim=2, num_layers=2, hidden_dim=32)
    cfg.update(kwargs)
    net = rDecoderNet(**cfg)
    assert net.fused() is fused
    rng = np.random.RandomState(0)
    xc = torch.from_numpy(rng.uniform(-1, 1, (3, 64, 2)).astype(np.float32))
    z = torch.from_numpy(rng.randn(3, 2).astype(np.float32))
    with torch.no_grad():
        y = net(xc, z)
        # the per-layer route on the same parameters
        net.fused = lambda: False
        y_layers = net(xc, z)
    assert y.shape == (3,) + tuple(cfg["out_dim"])
    torch.testing.assert_close(y, y_layers, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,n,H,L,forward,backward", [
    # config C: M = 131,072 rows
    (128, 1024, 128, 2, 8_690_597_888, 26_038_239_232),
    # M = 10: h0 2·10·2·16 = 640, hidden 0, head 2·10·16 = 320; backward
    # recompute 640, head 640, hidden 0, dWc 640 and dx 640
    (2, 5, 16, 0, 960, 2_560),
])
def test_flop_counts_match_hand_counts(B, n, H, L, forward, backward):
    assert sm.spatial_mlp_flops(B, n, H, L) == (forward, backward)


def test_bytes_and_bound_at_config_c():
    from atomai_tpu_torch.ops import roofline
    fwd_bytes, bwd_bytes = sm.spatial_mlp_bytes(128, 1024, 128, 2)
    weights = 4 * (3 * 128 + 2 * 128 * 128 + 2 * 128 + 128 + 1)
    assert fwd_bytes == 4 * 128 * 1024 * 3 + 4 * 128 * 128 + weights
    # gy in for y out; dx, dzb and the weights' gradients out
    assert bwd_bytes == fwd_bytes + 4 * 128 * 1024 * 2 + 4 * 128 * 128 \
        + weights
    fwd_flops, bwd_flops = sm.spatial_mlp_flops(128, 1024, 128, 2)
    # compute-bound: 8.69 GFLOP / 989 TFLOP/s against 1.7 MB / 3.35 TB/s
    assert roofline.bound(fwd_flops, fwd_bytes) == (
        pytest.approx(8.787257e-3, rel=1e-6), "operations")
    assert roofline.bound_ms(bwd_flops, bwd_bytes) == pytest.approx(
        2.632784e-2, rel=1e-6)
    assert roofline.bound(0, 3.35e9) == (pytest.approx(1.0), "bytes")


# -- the backward's kernels, by name, against the benchmark's roofline reader

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "atomai_tpu_torch", "csrc", "spatial_mlp.cu")
_BENCH = os.path.join(os.path.dirname(_CSRC), "..", "..", "benchmark")


def _braced(src, start):
    """The text from the first ``{`` at or after ``start`` to its match."""
    i = src.index("{", start)
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i:j + 1]
    raise AssertionError("unbalanced braces")


def _function(src, name):
    m = re.search(r"^\w[\w\s\*]*\b" + name + r"\(", src, re.M)
    assert m, f"no function {name}"
    return _braced(src, m.end())


def _launched(body):
    return set(re.findall(r"\b(\w+)(?:<[^<>;]*>)?<<<", body))


def _fast_path_launches(src):
    """Kernels that ``spatial_mlp_backward`` launches when its plan takes
    the pipelined kernel: its body without the staged branch, plus the
    launches of the helpers it calls there."""
    body = _function(src, "spatial_mlp_backward")
    staged = body.index("{", body.index("} else {", body.index("if (p.runs)")) + 1)
    body = body[:staged] + body[staged + len(_braced(body, staged)):]
    launched = _launched(body)
    for helper in ("pack_weights",):
        assert helper + "(" in body
        launched |= _launched(_function(src, helper))
    return launched


def test_backward_fast_path_launches_only_the_measured_kernels():
    """The pipelined backward launches ``pack_kernel``, ``bwd_wgmma`` and
    ``reduce_kernel`` and nothing else, each a ``__global__`` of the
    anonymous namespace, and the benchmark's roofline reader
    (``spatial_mlp_bwd_roofline.BACKWARD`` and the forward reader's
    ``PACK``) matches each of them as the profiler names it."""
    with open(_CSRC) as f:
        src = f.read()
    launched = _fast_path_launches(src)
    assert launched == {"pack_kernel", "bwd_wgmma", "reduce_kernel"}
    anon = _braced(src, src.index("namespace {"))
    for name in launched:
        assert re.search(r"__global__[^;{]*\b" + name + r"\(", anon), name

    import importlib.util
    import sys
    sys.path.insert(0, os.path.abspath(_BENCH))
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_bwd_roofline_guard", os.path.join(
                _BENCH, "metrics", "spatial_mlp_bwd_roofline.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.abspath(_BENCH))
    profiled = {   # the demangled names a trace shows
        "bwd_wgmma": "void (anonymous namespace)::bwd_wgmma<128>(float "
                     "const*, float const*)",
        "reduce_kernel": "(anonymous namespace)::reduce_kernel(float const*, "
                         "int, int)",
        "pack_kernel": "(anonymous namespace)::pack_kernel(float const*, "
                       "__nv_bfloat16*, int, int, int)"}
    for name in ("bwd_wgmma", "reduce_kernel"):
        assert mod.BACKWARD.search(profiled[name]), name
    assert mod._fwd.PACK.search(profiled["pack_kernel"])
    assert not mod.BACKWARD.search(profiled["pack_kernel"])
