"""The exact MLL's kernel route (``ops/spd_mll.py``) on the CPU.

- The kernels' algorithm in plain torch (the augmented, padded factor in
  tile steps with its inverse swept along; the closed-form dK and dr from
  the inverse) against autograd through the library route of
  ``neg_mll``: the loss and the gradients of the GP's parameters and of
  the inputs. Float64 within 1e-10 relative. Float32 within ``F32``: both
  routes are backward-stable float32 factorisations, each within about
  N u kappa(K) of the float64 loss and gradients (u = 6e-8; at the initial
  parameters kappa(K) <= 1 + N outputscale / noise, 201 at N = 200), so
  their gaps are held to 8 times the library route's own gap from float64
  and an absolute floor of a few float32 roundings.
- The factor, the solve and the inverse against ``torch.linalg``, at the
  kernels' tile and at twice it, and NaN where ``_cholesky`` gives it.
- The router: CPU and float64 to the library, a float32 K on a card up to
  ``MLL_KERNEL_MAX_N`` to the kernels, above it to the library; the
  kernel route's wiring through ``ExactMLLTerms`` with the launchers
  replaced by the plain versions (a stubbed device check, no card).
- The trainer's route counters count replayed steps.

The CUDA kernels themselves are held against the plain versions and the
library route on the card by ``chip_smoke.py``'s ``spd_mll`` phase.
"""

import contextlib

import pytest
import torch

from atomai_tpu_torch.core import graphs, profiling
from atomai_tpu_torch.nets.gp import rbf_kernel
from atomai_tpu_torch.ops import spd_mll
from atomai_tpu_torch.trainers import gptrainer
from atomai_tpu_torch.trainers.gptrainer import GPTrainer, neg_mll

torch.set_num_threads(1)

SIZES = [1, 2, 63, 64, 65, 200]
F64 = 1e-10
F32_FACTOR, F32_FLOOR = 8.0, 1e-6


def _problem(n, b, dtype, seed=0):
    """Inputs (b, n, 2), targets (b, n) and raw GP parameters with an
    output axis, drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed + 97 * n + b)
    X = torch.rand(b, n, 2, generator=g, dtype=torch.float64) * 2 - 1
    y = torch.sin(3 * X[..., 0]) + 0.1 * torch.randn(
        b, n, generator=g, dtype=torch.float64)
    params = {"raw_lengthscale": 0.3 * torch.randn(b, 2, generator=g,
                                                   dtype=torch.float64),
              "raw_outputscale": 0.3 * torch.randn(b, generator=g,
                                                   dtype=torch.float64),
              "raw_noise": 0.3 * torch.randn(b, generator=g,
                                             dtype=torch.float64),
              "mean_const": 0.1 * torch.randn(b, generator=g,
                                              dtype=torch.float64)}
    return X.to(dtype), y.to(dtype), {k: v.to(dtype)
                                      for k, v in params.items()}


def _loss_and_grads(X, y, params):
    X = X.clone().requires_grad_()
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = neg_mll(params, X, y, rbf_kernel)
    loss.sum().backward()
    return loss.detach(), torch.cat(
        [X.grad.reshape(-1)] + [params[k].grad.reshape(-1)
                                for k in sorted(params)])


def _rel(a, b):
    return float(torch.linalg.norm((a - b).double())
                 / torch.linalg.norm(b.double()))


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """Every K takes the kernel route, whose launchers are the plain
    versions; records the shape of each forward's K."""
    calls = []

    def forward(K, r):
        calls.append(tuple(K.shape))
        q, h, _, W = spd_mll.mll_factor_reference(K, r)
        return q, h, W

    monkeypatch.setattr(spd_mll, "route", lambda device, dtype, n: "kernel")
    monkeypatch.setattr(spd_mll, "_forward", forward)
    monkeypatch.setattr(spd_mll, "_backward", spd_mll.mll_grad_reference)
    return calls


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", SIZES)
def test_plain_algorithm_is_autograd_float64(kernel_on_cpu, monkeypatch, n,
                                             b):
    X, y, params = _problem(n, b, torch.float64)
    loss, grads = _loss_and_grads(X, y, params)
    monkeypatch.undo()
    want_loss, want_grads = _loss_and_grads(X, y, params)
    assert kernel_on_cpu == [(b, n, n)]
    assert _rel(loss, want_loss) < F64
    assert _rel(grads, want_grads) < F64


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n", SIZES)
def test_plain_algorithm_float32(kernel_on_cpu, monkeypatch, n, b):
    X, y, params = _problem(n, b, torch.float32)
    loss, grads = _loss_and_grads(X, y, params)
    monkeypatch.undo()
    lib_loss, lib_grads = _loss_and_grads(X, y, params)
    exact = {k: v.double() for k, v in params.items()}
    f64_loss, f64_grads = _loss_and_grads(X.double(), y.double(), exact)
    for got, lib, f64 in ((loss, lib_loss, f64_loss),
                          (grads, lib_grads, f64_grads)):
        bound = F32_FACTOR * _rel(lib, f64) + F32_FLOOR
        assert _rel(got, f64) < bound
        assert _rel(got, lib) < bound


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("n,b", [(1, 1), (31, 3), (64, 1), (100, 2)])
def test_factor_solve_and_inverse(n, b, tile):
    X, y, params = _problem(n, b, torch.float64)
    K = rbf_kernel(X, X, torch.ones(b, 2, dtype=torch.float64),
                   torch.ones(b, dtype=torch.float64)) \
        + 0.1 * torch.eye(n, dtype=torch.float64)
    q, h, A, W = spd_mll.mll_factor_reference(K, y, tile)
    p = spd_mll.padded_size(n, tile)
    assert A.shape == W.shape == (b, p, p) and p % tile == 0 and p > n
    L = torch.linalg.cholesky(K)
    v = torch.linalg.solve_triangular(L, y[..., None], upper=False)[..., 0]
    Linv = torch.linalg.inv(L)
    alpha = torch.cholesky_solve(y[..., None], L)[..., 0]
    torch.testing.assert_close(A[:, :n, :n], L, rtol=0, atol=1e-12)
    torch.testing.assert_close(A[:, n, :n], v, rtol=0, atol=1e-12)
    torch.testing.assert_close(W[:, :n, :n], Linv, rtol=0, atol=1e-10)
    torch.testing.assert_close(-W[:, n, :n], alpha, rtol=1e-10, atol=1e-10)
    assert torch.equal(A, torch.tril(A)) and torch.equal(W, torch.tril(W))
    torch.testing.assert_close(q, torch.sum(v * v, -1), rtol=1e-12, atol=0)
    torch.testing.assert_close(h, torch.logdet(K) / 2, rtol=1e-12, atol=0)


@pytest.mark.parametrize("route", ["kernel", "library"])
def test_nan_where_the_factor_fails(route, request):
    """One output of three has a K with a negative pivot: its loss is NaN
    and the others' are finite, on both routes."""
    if route == "kernel":
        request.getfixturevalue("kernel_on_cpu")
    X, y, params = _problem(40, 3, torch.float32)
    params["raw_noise"][1] = -50.0          # noise ~ 1e-4: K near singular

    def kernel(x1, x2, ls, os_):
        K = rbf_kernel(x1, x2, ls, os_)
        K[1, 20, 20] = -1.0                 # not positive definite
        return K

    loss = neg_mll(params, X, y, kernel)
    assert torch.isnan(loss[1]) and torch.isfinite(loss[[0, 2]]).all()
    K = torch.eye(40)[None].repeat(3, 1, 1)
    K[1, 20, 20] = -1.0
    q, h, A, W = spd_mll.mll_factor_reference(K, torch.ones(3, 40), 32)
    assert torch.isnan(q[1]) and torch.isnan(h[1])
    assert torch.isnan(A[1]).all() and torch.isnan(W[1]).all()
    assert torch.isfinite(A[[0, 2]]).all() and torch.isfinite(q[[0, 2]]).all()


def test_route_by_device_dtype_and_size():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    limit = spd_mll.MLL_KERNEL_MAX_N
    assert spd_mll.route(cpu, torch.float32, 64) == "library"
    assert spd_mll.route(cuda, torch.float32, 1) == "kernel"
    assert spd_mll.route(cuda, torch.float32, limit) == "kernel"
    assert spd_mll.route(cuda, torch.float32, limit + 1) == "library"
    assert spd_mll.route(cuda, torch.float64, 64) == "library"


def test_neg_mll_on_cpu_is_the_library_route(monkeypatch):
    """A CPU K never reaches the kernels: the launchers are not called."""
    def refuse(*args):
        raise AssertionError("the kernel route was taken on the CPU")

    monkeypatch.setattr(spd_mll, "_forward", refuse)
    X, y, params = _problem(30, 2, torch.float32)
    loss, grads = _loss_and_grads(X, y, params)
    assert torch.isfinite(loss).all() and torch.isfinite(grads).all()


def test_cuda_entry_points_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        spd_mll.mll_forward_cuda(torch.eye(4)[None], torch.ones(1, 4))
    with pytest.raises(ValueError):
        spd_mll.mll_forward_cuda(torch.eye(4), torch.ones(4))


def test_flops_count_the_padded_steps():
    assert spd_mll.padded_size(1024, 32) == 1056
    assert spd_mll.padded_size(1023, 32) == 1024
    assert spd_mll.padded_size(1024, 64) == 1088
    fwd, bwd = spd_mll.mll_flops(1024)
    assert fwd == 2 * 1056 ** 3 // 3 and bwd == 1024 ** 3 // 3


class _FakeGraph:
    """Captures nothing: a replay runs no step."""

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.mark.parametrize("route", ["library", "kernel"])
def test_route_counter_counts_replayed_steps(monkeypatch, request, route):
    """A run of 10 cycles on a (stand-in) graph: 3 eager steps, a capture,
    6 replays that run no Python step; the route's counter reads 10."""
    if route == "kernel":
        request.getfixturevalue("kernel_on_cpu")
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(graphs, "_LAST_SHARED", {})
    monkeypatch.setattr(graphs, "capture_stream",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(GPTrainer, "_graphed", lambda self: True)
    X, y, _ = _problem(24, 1, torch.float32)
    t = GPTrainer(device="cpu")
    t.compile_trainer(X[0], y[0], training_cycles=10)
    steps = []
    step = t._step
    monkeypatch.setattr(t, "_step", lambda: steps.append(1) or step())
    profiling.reset()
    t.run(print_loss=5)
    counters = profiling.summary()["counters"]
    other = "library" if route == "kernel" else "kernel"
    assert counters.get(f"gp.mll_{route}") == 10
    assert f"gp.mll_{other}" not in counters
    assert len(steps) == gptrainer.GRAPH_WARMUP + 1
    profiling.reset()


def test_sgpr_counts_no_route():
    X, y, _ = _problem(24, 1, torch.float32)
    t = GPTrainer(device="cpu")
    t.compile_trainer(X[0], y[0], training_cycles=2, kernel_type="sparse",
                      num_inducing=8)
    profiling.reset()
    with contextlib.redirect_stdout(None):
        t.run(print_loss=2)
    counters = profiling.summary()["counters"]
    assert not any(k.startswith("gp.mll_") for k in counters)
    profiling.reset()
