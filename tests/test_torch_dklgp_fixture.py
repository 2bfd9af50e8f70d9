"""The GP fixture that ``chip_smoke.py`` holds the card against
(``tests/fixtures/torch_port_dklgp.npz``, written by the JAX package
through ``scripts/make_torch_port_fixtures.py``), reproduced by the port
on the CPU through ``chip_smoke.dklgp_fixture_run``, at the bounds the
script applies on the card (stated beside its ``TOL_DKL_*``, ``TOL_GP_*``
and ``TOL_RECONSTRUCT`` constants): ``dklGPR(64, embedim=2)`` with the
full-width extractor from numpy-drawn weights, 5 Adam steps, ``predict``
and ``embed``; ``GPTrainer`` 'exact' and 'kissgp'; and
``Reconstructor.reconstruct`` of a 32 x 32 image.
"""

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def test_dklgp_fixture_holds_the_three_runs():
    script = chip_smoke.fixture_script()
    stored = dict(np.load(script.DKLGP_FIXTURE))
    assert stored["dkl_loss"].shape == (script.DKL["cycles"],)
    assert stored["dkl_embed"].shape == (script.DKL["n_predict"],
                                         script.DKL["embedim"])
    for kind in ("exact", "kissgp"):
        assert stored[f"gp_{kind}_mean"].shape == (script.GP2D["n_predict"],)
    n = script.RECONSTRUCT["size"]
    assert stored["reconstruct"].shape == (n, n)
    # the extractor's weights and the data are drawn, not stored
    assert sum(v.nbytes for v in stored.values()) < 1 << 16


def test_port_reproduces_dklgp_fixture():
    errs, tols = chip_smoke.dklgp_fixture_run(torch.device("cpu"))
    assert len(errs) == 15
    assert not chip_smoke.failures(errs, tols)
