"""The zoo fixture that ``chip_smoke.py`` holds the card against:
regenerated with the JAX package and compared with the file (so it cannot
go stale), then reproduced by the port on the CPU through
``chip_smoke.zoo_fixture_run``, in float32, at the bounds the script
applies on the card (stated beside its ``TOL_ZOO_*`` constants).

Every net of ``ZOO_NETS`` at its default width (the dilated Unet, dilnet,
SegResNet, ResHedNet, the denoiser, the regressor on each backbone and
slim preset, a three-class MobileNetV2 classifier) from numpy-drawn
variables, eval-mode forwards of one (2, 64, 64, 1) input, and three
Adam(1e-3) cycles of ``Regressor("mobilenet")``.
"""

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def test_zoo_fixture_is_current():
    script = chip_smoke.fixture_script()
    stored = dict(np.load(script.ZOO_FIXTURE))
    fresh = script.make_zoo_fixture()
    assert sorted(stored) == sorted(fresh)
    for k in stored:
        if k.startswith("y/"):
            # XLA:CPU's float32 convs on another host may round differently
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-5,
                                       atol=1e-6 * np.abs(stored[k]).max(),
                                       err_msg=k)
        elif k.startswith("reg_final/") or k.endswith("_loss"):
            # the SGD cycles follow a float32 gradient that lies 2-7% from
            # the float64 one: another host's rounding moves them further
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-3,
                                       atol=1e-6 * np.abs(stored[k]).max(),
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    assert sum(v.nbytes for v in stored.values()) < 1 << 20
    assert len([k for k in stored if k.startswith("y/")]) == len(
        script.ZOO_NETS)


def test_port_reproduces_zoo_fixture(tmp_path):
    from atomai_tpu_torch.core import Precision
    errs, tols = chip_smoke.zoo_fixture_run(
        torch.device("cpu"), str(tmp_path),
        {"f32": (Precision.full(), chip_smoke.TOL_ZOO_F32)})
    script = chip_smoke.fixture_script()
    assert all(f"{name}/f32" in errs for name in script.ZOO_NETS)
    assert len([k for k in errs if k.startswith("reg/")]) > 10
    assert not chip_smoke.failures(errs, tols)
