"""The joint-VAE fixture that ``chip_smoke.py`` holds the card against:
regenerated with the JAX package and compared with the file (so it cannot
go stale), then reproduced by the port on the CPU through
``chip_smoke.jvae_fixture_run``: one training step of ``jVAE((32, 32),
latent_dim=2, discrete_dim=[4])`` and of the ``jrVAE`` of the same
arguments at config C's batch of 128 patches (ELBO, every gradient, one
Adam step), in float32 at the card's float32 bounds (Adam within 1e-6
here, as the CPU's rVAE fixture check), and the jrVAE under the mixed
bf16 policy (CPU autocast) at the bounds the card applies to it.
"""

import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def test_jvae_fixture_is_current():
    script = chip_smoke.fixture_script()
    stored = dict(np.load(script.JVAE_FIXTURE))
    fresh = script.make_jvae_fixture()
    assert sorted(stored) == sorted(fresh)
    for k in stored:
        if k.startswith("shape/") or k.endswith(("/eps", "/u")):
            np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
        else:
            # XLA:CPU on another host may round differently
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert sum(v.nbytes for v in stored.values()) < 4 << 20
    assert {k.split("/")[1] for k in stored if k.startswith("shape/")} == \
        set(script.JVAE_MODELS)


def test_port_reproduces_jvae_fixture():
    from atomai_tpu_torch.core import Precision
    cpu = torch.device("cpu")
    f32 = Precision.full()
    tight = (chip_smoke.TOL_JVAE_ELBO_REL, chip_smoke.TOL_JVAE_GRAD_SCALED,
             1e-6)
    bf16 = (chip_smoke.TOL_ELBO_REL, chip_smoke.TOL_GRAD_SCALED,
            chip_smoke.TOL_ADAM_ABS)
    cases = {"jvae_f32": ("jvae", f32, False) + tight,
             "jrvae_f32": ("jrvae", f32, False) + tight,
             "jrvae_f32_stock": ("jrvae", f32, True) + tight,
             "jrvae_mixed": ("jrvae", Precision.mixed(), False) + bf16}
    out, bad = chip_smoke.jvae_fixture_run(cpu, cases)
    assert not bad, bad
    assert set(out) == set(cases)
    # the card's cases are these, on the kernels
    assert set(chip_smoke.jvae_card_cases(cpu)) == {
        "jvae_f32", "jrvae_f32_stock", "jrvae_f32_kernels",
        "jrvae_mixed_kernels"}
