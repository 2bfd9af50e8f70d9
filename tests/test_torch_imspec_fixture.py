"""The ImSpec fixture that ``chip_smoke.py`` holds the card against:
regenerated with the JAX package and compared with the file (so it cannot
go stale), then reproduced by the port's ``ImSpec`` on the CPU through
``chip_smoke.imspec_fixture_run``, at the bounds the script applies on the
card (stated beside its ``TOL_IMSPEC_*`` constants).

Bench config B's model and data (``ImSpec((64, 64), (16,),
latent_dim=2)``, default widths), from variables drawn with numpy
(``seeded_variables``), three Adam(1e-3) cycles of batch 32, float32.
"""

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def test_imspec_fixture_is_current():
    script = chip_smoke.fixture_script()
    stored = dict(np.load(script.IMSPEC_FIXTURE))
    fresh = script.make_imspec_fixture()
    assert sorted(stored) == sorted(fresh)
    for k in stored:
        if k.startswith(("final/", "predict")) or k.endswith("_loss"):
            # XLA:CPU's float32 convs on another host may round differently
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    assert sum(v.nbytes for v in stored.values()) < 1 << 20


def test_port_reproduces_imspec_fixture(tmp_path):
    _, errs, tols = chip_smoke.imspec_fixture_run(torch.device("cpu"),
                                                  str(tmp_path))
    assert len(errs) > 20
    assert not chip_smoke.failures(errs, tols)
