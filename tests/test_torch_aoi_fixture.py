"""The JAX-written checkpoints that ``chip_smoke.py`` phases 25-26 load on
the card (``tests/fixtures/torch_port_unet.aoi``, ``torch_port_rvae.aoi``
and the JAX numbers of ``torch_port_aoi.npz``): regenerated with the JAX
package's own ``save_model`` and ``resume_training`` and compared with the
committed files (so they cannot go stale), then reproduced by the port on
the CPU through ``chip_smoke.aoi_fixture_run``: the loaded Unet's forward
(float32 and the CPU's mixed policy), ``resume_training`` from the JAX
Adam state at the seg-train fixture's loss bound (1e-3 relative), and the
loaded rVAE's counters, encoding and decoding.
"""

import os
import sys

import numpy as np
import torch
from flax import serialization

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def _restore(path):
    from atomai_tpu.core.checkpoint import load_checkpoint
    return load_checkpoint(path)


def _close(a, b, where):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), where
        for k in b:
            _close(a[k], b[k], f"{where}/{k}")
    else:
        # XLA:CPU on another host may round differently
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-5,
                                   atol=1e-6, err_msg=where)


def test_aoi_fixture_is_current(tmp_path):
    script = chip_smoke.fixture_script()
    stored = dict(np.load(script.AOI_FIXTURE))
    unet, rvae = str(tmp_path / "unet.aoi"), str(tmp_path / "rvae.aoi")
    fresh = script.make_aoi_fixture(unet, rvae)
    assert sorted(stored) == sorted(fresh)
    for k in stored:
        if k.endswith(("schedule", "/x", "/z")):
            np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
        else:
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    for committed, new in ((script.AOI_UNET, unet), (script.AOI_RVAE, rvae)):
        (meta_a, arrays_a), (meta_b, arrays_b) = (_restore(committed),
                                                  _restore(new))
        assert meta_a == meta_b
        _close(arrays_a, arrays_b, os.path.basename(committed))
    meta, arrays = _restore(script.AOI_UNET)
    assert meta["completed_cycles"] == script.SEG_CYCLES
    assert set(arrays) == {"params", "batch_stats", "opt_state"}
    sizes = [os.path.getsize(p) for p in (script.AOI_UNET, script.AOI_RVAE,
                                          script.AOI_FIXTURE)]
    assert sum(sizes) < 8.5 * 2 ** 20


def test_port_reproduces_aoi_fixture():
    out = chip_smoke.aoi_fixture_run(torch.device("cpu"))
    assert out["rvae_num_iter"] == 8
    assert len(out["resume_train_loss"]) == chip_smoke.AOI_RESUME_CYCLES


def test_msgpack_payload_is_flax(tmp_path):
    """The committed files are the JAX package's format: 8-byte length,
    JSON, flax msgpack (read here by flax itself)."""
    with open(chip_smoke.AOI_RVAE, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        f.read(hlen)
        tree = serialization.msgpack_restore(f.read())
    assert set(tree["params"]) == {"encoder", "decoder"}
