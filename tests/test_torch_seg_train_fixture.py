"""The seg-train fixture that ``chip_smoke.py`` holds the card against:
regenerated with the JAX package and compared with the file (so it cannot
go stale), then reproduced by the port's ``Segmentor`` on the CPU.

The port trains the full-width Unet (config A's) from the fixture's
initial variables for its 5 cycles, float32 on the CPU. The c1 conv bias
sits before a LeakyReLU and a BatchNorm, which takes out the batch mean:
its gradient is a sum that cancels to rounding noise, and Adam moves it by
lr * sign(g) a step whatever the gradient's size, in a direction that
rounding picks (the same holds for a few other near-zero gradients). In
eval mode the BatchNorm's running mean lags such moves, so the test loss
drifts too. Tolerances:
- losses: 1e-3 relative (measured: train <= 6.4e-5, test <= 4.8e-4, with
  1 and with 8 threads);
- every trained c1 parameter and running mean: 2 * lr * steps = 1e-2, the
  most that sign-normalised Adam steps can separate two runs (measured:
  the conv bias 6.5e-3, the rest <= 1.1e-3);
- the px head, whose gradient is large and well determined: 1e-4
  (measured 4.5e-6);
- BatchNorm running variance: 1 / (n - 1) relative, n = 4 x 64 x 64, the
  n / (n - 1) of torch's unbiased update against flax's biased one.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from atomai_tpu_torch.models import Segmentor, conversion

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_LOSS = 1e-3
LR = 1e-3
ATOL_HEAD = 1e-4
RTOL_RUNNING_VAR = 1.0 / (4 * 64 * 64 - 1)


def _fixture_script():
    path = os.path.join(ROOT, "scripts", "make_torch_port_fixtures.py")
    spec = importlib.util.spec_from_file_location("_torch_port_fixtures",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def script():
    return _fixture_script()


@pytest.fixture(scope="module")
def stored(script):
    return dict(np.load(script.SEG_TRAIN_FIXTURE))


def test_seg_train_fixture_is_current(script, stored):
    fresh = script.make_seg_train_fixture()
    assert sorted(stored) == sorted(fresh)
    for k in stored:
        if k.startswith("final/") or k.endswith("_loss"):
            # XLA:CPU's float32 convs on another host may round differently
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    assert sum(v.nbytes for v in stored.values()) < 1 << 20


def test_port_reproduces_seg_train_fixture(script, stored, tmp_path):
    base = dict(np.load(script.FIXTURE))
    m = Segmentor("Unet", 1, nb_filters=16, layers=(1, 2, 2, 3),
                  device="cpu")
    m.load_jax_variables(script.unflatten(base, "params"),
                         script.unflatten(base, "batch_stats"))
    m.compile_trainer((stored["x_train"], stored["y_train"],
                       stored["x_test"], stored["y_test"]),
                      training_cycles=script.SEG_CYCLES,
                      batch_size=script.SEG_BATCH,
                      print_loss=script.SEG_CYCLES,
                      filename=str(tmp_path / "seg"))
    np.testing.assert_array_equal(m.batch_idx_train, stored["schedule"])
    m.run()
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(m.loss_acc[k], stored[k],
                                   rtol=RTOL_LOSS, err_msg=k)
    final = script.unflatten(stored, "final")
    want = {f"c1.{k}": v for k, v in conversion._conv_block(
        final["params"]["ConvBlock_0"], final["batch_stats"]["ConvBlock_0"],
        False, "ConvBlock_0").items()}
    want.update({f"px.{k}": v for k, v in conversion._conv(
        final["params"]["Conv_0"], "Conv_0").items()})
    got = m.net.state_dict()
    assert len(want) == 9      # 6 of c1 (+ its step count), 2 of px
    atol_adam = 2 * LR * script.SEG_CYCLES
    for k, w in want.items():
        g = got[k].float()
        if k.endswith("running_var"):
            np.testing.assert_allclose(g, w, rtol=RTOL_RUNNING_VAR, err_msg=k)
        elif not k.endswith("num_batches_tracked"):
            atol = ATOL_HEAD if k.startswith("px.") else atol_adam
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=k)
