"""``export_model`` / ``load_exported`` (``core/export.py``) on the CPU: a
round trip against the live forward, the symbolic batch axis, the input
conventions of ``predict``, the header, a JAX-written checkpoint exported
and served against the JAX forward, and the refusal of the JAX package's
own ``.aot`` artifacts.

Tolerances: the artifact against the live forward of the same module, 1e-6
absolute (the same float32 ops; measured 6e-8); against the JAX package's
forward of the same weights (the committed Unet fixture), the forward
fixture's float32 bound, 1e-4 (measured 1.2e-7).
"""

import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

import atomai_tpu as J
import atomai_tpu_torch as aoi
from atomai_tpu_torch.core import Precision

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOL_LIVE = 1e-6
TOL_JAX = 1e-4


@pytest.fixture(scope="module")
def seg():
    return aoi.models.Segmentor("Unet", 1, nb_filters=4, layers=[1, 1, 1, 1],
                                seed=3, device="cpu")


@pytest.fixture(scope="module")
def exported(seg, tmp_path_factory):
    path = aoi.export_model(seg, str(tmp_path_factory.mktemp("e") / "seg"),
                            example_shape=(32, 32, 1))
    return path, aoi.load_exported(path, device="cpu")


def test_round_trip_matches_live_forward(seg, exported):
    path, served = exported
    assert path.endswith(".aott")
    x = np.random.RandomState(1).rand(3, 32, 32, 1).astype(np.float32)
    with torch.no_grad():
        want = seg.forward(torch.from_numpy(x)).numpy()
    got = served(x).numpy()
    assert got.shape == want.shape == (3, 32, 32, 1)
    np.testing.assert_allclose(got, want, atol=TOL_LIVE, rtol=0)


@pytest.mark.parametrize("n", [1, 2, 5, 33])
def test_symbolic_batch(exported, n):
    _, served = exported
    x = np.random.RandomState(n).rand(n, 32, 32, 1).astype(np.float32)
    out = served(x)
    assert out.shape == (n, 32, 32, 1)
    # one pass over the batch equals one sample at a time
    np.testing.assert_allclose(out[-1:].numpy(), served(x[-1:]).numpy(),
                               atol=TOL_LIVE, rtol=0)


def test_pinned_batch(seg, tmp_path):
    path = aoi.export_model(seg, str(tmp_path / "one"),
                            example_shape=(32, 32, 1),
                            batch_polymorphic=False)
    served = aoi.load_exported(path, device="cpu")
    x = np.random.RandomState(2).rand(3, 32, 32, 1).astype(np.float32)
    with torch.no_grad():
        want = seg.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(served(x).numpy(), want, atol=TOL_LIVE,
                               rtol=0)


def test_predict_conventions_and_header(seg, exported):
    _, served = exported
    img = np.random.RandomState(2).rand(32, 32) * 100   # not normalised
    out = served.predict(img)
    assert out.shape == (1, 32, 32, 1)
    stack = np.random.RandomState(2).rand(40, 32, 32)
    got = served.predict(stack, max_batch=16)
    x = (stack - stack.min()) / (stack.max() - stack.min())
    with torch.no_grad():
        want = seg.forward(torch.from_numpy(
            x[..., None].astype(np.float32))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL_LIVE, rtol=0)
    with pytest.raises(ValueError, match="does not match"):
        served.predict(np.zeros((16, 16)))
    assert served.model_type == "seg"
    assert served.example_shape == (32, 32, 1)
    assert served.header["precision"] == {"compute_dtype": "float32",
                                          "allow_tf32": False}
    assert served.meta["nb_filters"] == 4


def test_mixed_policy_is_traced(seg, tmp_path):
    """A model under the bf16 policy exports its autocast region."""
    m = aoi.models.Segmentor("Unet", 1, nb_filters=4, layers=[1, 1, 1, 1],
                             seed=3, device="cpu")
    m.precision = Precision.mixed()
    served = aoi.load_exported(aoi.export_model(
        m, str(tmp_path / "mixed"), example_shape=(32, 32, 1)),
        device="cpu")
    assert served.header["precision"]["compute_dtype"] == "bfloat16"
    x = np.random.RandomState(3).rand(2, 32, 32, 1).astype(np.float32)
    with torch.no_grad():
        want = m.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(served(x).numpy(), want, atol=TOL_LIVE,
                               rtol=0)


def test_jax_checkpoint_exported_and_served(tmp_path):
    """The JAX package's Unet checkpoint, loaded by the port, exported and
    served: the JAX forward of the fixture's input."""
    m = aoi.load_model(os.path.join(FIXTURES, "torch_port_unet.aoi"),
                       device="cpu")
    fx = dict(np.load(os.path.join(FIXTURES, "torch_port_aoi.npz")))
    x = np.load(os.path.join(FIXTURES, "torch_port_unet_fwd.npz"))["x"]
    served = aoi.load_exported(aoi.export_model(
        m, str(tmp_path / "unet"), example_shape=x.shape[1:]), device="cpu")
    got = served(x).numpy()
    np.testing.assert_allclose(got, fx["unet/y"], atol=TOL_JAX, rtol=0)


def test_inferred_example_shape(tmp_path):
    m = aoi.models.ImSpec((16, 16), (8,), latent_dim=2, nbfilters_encoder=4,
                          nbfilters_decoder=4, device="cpu")
    served = aoi.load_exported(aoi.export_model(m, str(tmp_path / "ims")),
                               device="cpu")
    assert served.example_shape == (16, 16)
    x = np.random.RandomState(4).rand(3, 16, 16).astype(np.float32)
    with torch.no_grad():
        want = m.forward(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(served(x).numpy(), want, atol=TOL_LIVE,
                               rtol=0)


def test_refuses_jax_artifacts_and_other_files(tmp_path):
    jm = J.models.Segmentor("Unet", 1, nb_filters=4, layers=[1, 1, 1, 1])
    v = jm.net.init({"params": jax.random.key(0)},
                    np.zeros((1, 16, 16, 1), np.float32), False)
    jm.params, jm.batch_stats = v["params"], v["batch_stats"]
    aot = J.export_model(jm, str(tmp_path / "jax"), example_shape=(16, 16, 1),
                         platforms=("cpu",))
    assert aot.endswith(".aot")
    with pytest.raises(ValueError, match="export of the JAX package"):
        aoi.load_exported(aot, device="cpu")
    blob = json.dumps({"magic": "nope"}).encode()
    bad = tmp_path / "bad.aott"
    bad.write_bytes(struct.pack("<Q", len(blob)) + blob)
    with pytest.raises(ValueError, match="not an atomai_tpu_torch export"):
        aoi.load_exported(str(bad), device="cpu")
    junk = tmp_path / "junk.aott"
    junk.write_bytes(b"\xff" * 16)
    with pytest.raises(ValueError, match="not an atomai_tpu_torch export"):
        aoi.load_exported(str(junk), device="cpu")
    jax.clear_caches()


def test_load_exported_defaults_to_the_card(exported):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aoi.load_exported(exported[0])
