"""The port's ``GPTrainer`` and ``Reconstructor`` against the JAX package's,
on the same numpy-made data: a few Adam steps of 'exact', 'sparse' and
'kissgp' GPs (one of them with two outputs, the Matern kernel and
lengthscale constraints), their losses, final parameters and
``predict``; ``Reconstructor.reconstruct`` on the exact path (a 20 x 20
image) and the inducing-grid path (24 x 24); a recompile clears the
posterior cache; ``mesh`` is taken and ignored, as the JAX package's
compile_trainer does. Each JAX run happens once, in a
module-scoped fixture.

Stated tolerances, float32 on the CPU (the GP has four parameters an
output, no extractor, so the two packages follow one trajectory): losses
1e-4 relative, parameters and predictions 1e-4 absolute (measured:
losses 6.4e-6, predictions 4.2e-6).

The Reconstructor computes in float64 where the JAX package computes in
float32, and its fits drive the noise to its floor, where float32
rounding grows from cycle to cycle: the first 10 losses within 1e-4
relative (measured 7e-6), then the images against the truth at the JAX
tests' bars (0.15, 0.2) and against the JAX images within 1e-3 (exact
path, measured 8.1e-5) and 2e-2 (inducing grid, measured 8.2e-3). On the
grid path the JAX package's float32 loss leaves float64's by 4e-4
relative by cycle 20, where the port's float32 stays within 4e-6, so that
bound is the JAX package's own rounding.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from atomai_tpu.models import Reconstructor as JaxReconstructor
from atomai_tpu.trainers import GPTrainer as JaxGPTrainer
from atomai_tpu_torch.models import Reconstructor
from atomai_tpu_torch.trainers import GPTrainer

torch.set_num_threads(1)

TOL_LOSS_REL = 1e-4
TOL = 1e-4
EARLY = 10
TOL_RECONSTRUCT_EXACT = 1e-3
TOL_RECONSTRUCT_GRID = 2e-2
CYCLES = 8
RUNS = {
    "exact": dict(kernel_type="exact"),
    "sparse_two_outputs_matern": dict(
        kernel_type="sparse", num_inducing=16, base_kernel="matern",
        lengthscale_constraints=[[0.1, 0.1], [5.0, 5.0]]),
    "kissgp": dict(kernel_type="kissgp", grid_points_ratio=0.2),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    X = rng.uniform(-2, 2, (60, 2)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) * np.cos(X[:, 1])
         + 0.05 * rng.randn(60)).astype(np.float32)
    Y = np.stack([y, (X[:, 0] * X[:, 1]).astype(np.float32)])
    Xs = rng.uniform(-2, 2, (9, 2)).astype(np.float32)
    return X, y, Y, Xs


def _targets(name, data):
    X, y, Y, _ = data
    return Y if "two_outputs" in name else y


def _run(cls, name, data, **kw):
    t = cls(**kw)
    with contextlib.redirect_stdout(io.StringIO()):
        t.run(data[0], _targets(name, data), CYCLES, print_loss=3,
              **RUNS[name])
    mean, var = t.predict(data[3])
    return t, np.asarray(mean), np.asarray(var)


@pytest.fixture(scope="module")
def jax_runs(data):
    return {name: _run(JaxGPTrainer, name, data) for name in RUNS}


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) / np.asarray(want) - 1)))


@pytest.mark.parametrize("name", list(RUNS))
def test_gptrainer_matches_jax(data, jax_runs, name):
    jt, jm, jv = jax_runs[name]
    t, m, v = _run(GPTrainer, name, data, device="cpu")
    assert t.kernel_type == jt.kernel_type
    if jt.inducing_points is not None:
        np.testing.assert_array_equal(t.inducing_points.numpy(),
                                      np.asarray(jt.inducing_points))
    assert len(t.train_loss) == CYCLES
    assert _rel(t.train_loss, jt.train_loss) <= TOL_LOSS_REL
    for k, p in t.gp_params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jt.gp_params[k]), atol=TOL)
    assert m.shape == jm.shape and v.shape == jv.shape
    np.testing.assert_allclose(m, jm, atol=TOL)
    np.testing.assert_allclose(v, jv, atol=TOL)


def test_train_steps_equal_a_run(data):
    """Two ``train_step`` calls are the first two cycles of ``run``, and
    each drops the posterior cache."""
    X, y, _, Xs = data
    stepped = GPTrainer(device="cpu")
    stepped.compile_trainer(X, y, training_cycles=2)
    stepped.train_step()
    stepped.predict(Xs)
    stepped.train_step()
    assert stepped._post_cache is None
    ran = GPTrainer(device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        ran.run(X, y, training_cycles=2)
    assert stepped.train_loss == ran.train_loss
    np.testing.assert_array_equal(stepped.predict(Xs)[0], ran.predict(Xs)[0])


def test_recompile_clears_the_posterior_cache(data):
    """``compile_trainer`` on new data drops the factorisation of the
    previous fit, and the next fit predicts from the new one."""
    X, y, _, Xs = data
    t = GPTrainer(device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        t.run(X, y, training_cycles=3, print_loss=3)
        t.predict(Xs)
        assert t._post_cache is not None
        t.compile_trainer(X[:40], y[:40], training_cycles=3)
        assert t._post_cache is None
        t.run(print_loss=3)
    m, _ = t.predict(Xs)
    fresh = GPTrainer(device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        fresh.run(X[:40], y[:40], training_cycles=3, print_loss=3)
    np.testing.assert_allclose(m, fresh.predict(Xs)[0], atol=1e-6)


def test_mesh_raises_and_off_runs(data):
    X, y, _, _ = data
    from atomai_tpu_torch.core.mesh import get_mesh
    with pytest.raises(RuntimeError, match="process group"):
        get_mesh(n_data=2)
    # one GP: the JAX package's compile_trainer takes mesh and ignores it
    for mesh in (None, False, object()):
        GPTrainer(device="cpu").compile_trainer(X, y, mesh=mesh)


def _image(size, period, seed=1):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    true = np.sin(yy / period) * np.cos(xx / period)
    return np.where(rng.rand(size, size) > 0.5, true, 0.0).astype(
        np.float32), true


@pytest.fixture(scope="module")
def reconstructions():
    """(port, JAX) reconstructions of the JAX tests' two images: 20 x 20 on
    the exact path, 24 x 24 on the inducing grid."""
    out = {}
    for name, size, period, cycles, max_exact in (
            ("exact", 20, 3.0, 100, 10000), ("grid", 24, 4.0, 120, 100)):
        img, true = _image(size, period)
        recs = []
        for rec in (Reconstructor(device="cpu"), JaxReconstructor()):
            rec.MAX_EXACT_POINTS = max_exact
            with contextlib.redirect_stdout(io.StringIO()):
                recs.append((rec, rec.reconstruct(
                    img, training_cycles=cycles, print_loss=cycles)))
        out[name] = recs, true
    return out


@pytest.mark.parametrize("name,kernel_type,bar,tol", [
    ("exact", "exact", 0.15, TOL_RECONSTRUCT_EXACT),
    ("grid", "kissgp", 0.2, TOL_RECONSTRUCT_GRID)])
def test_reconstructor_matches_jax(reconstructions, name, kernel_type, bar,
                                   tol):
    ((port, got), (jax_rec, want)), true = reconstructions[name]
    assert port.kernel_type == jax_rec.kernel_type == kernel_type
    assert got.shape == true.shape and got.dtype == np.float32
    np.testing.assert_allclose(port.train_loss[:EARLY],
                               jax_rec.train_loss[:EARLY], rtol=TOL_LOSS_REL)
    np.testing.assert_allclose(got, want, atol=tol)
    assert np.abs(got - true).mean() < bar
