"""The port's host utilities and core policy against the JAX package.

The lattice generator, padding, random patches and one-hot labels are
numpy copies and must agree bit for bit; ``img_resize`` goes through torch's antialiased bilinear resize and
must match ``jax.image.resize(..., "linear")`` to float32 rounding (atol
1e-6) when it shrinks as well as when it grows.
"""

import numpy as np
import pytest
import torch

from atomai_tpu.utils import imgen as jax_imgen
from atomai_tpu.utils import img as jax_img
from atomai_tpu.utils import preproc as jax_preproc
from atomai_tpu_torch.core import (GeneratorSeq, Precision,
                                   default_precision, generator_from_seed,
                                   head_f32, set_default_precision)
from atomai_tpu_torch.utils import (extract_patches_2d, format_image,
                                    img_pad, img_resize, make_lattice_stack,
                                    to_onehot)

torch.set_num_threads(1)


@pytest.mark.parametrize("kwargs", [
    dict(n_images=2, size=64, spacing=12, seed=7),
    dict(n_images=3, size=48, spacing=10, seed=0, jitter=2.0, noise=0.2),
])
def test_make_lattice_stack_equals_jax_package(kwargs):
    ours = make_lattice_stack(**kwargs)
    ref = jax_imgen.make_lattice_stack(**kwargs)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    for a, b in zip(ours[2], ref[2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rs", [(20, 26), (17, 31), (80, 104), (61, 75),
                                (40, 30)])
@pytest.mark.parametrize("channels", [False, True])
def test_img_resize_matches_jax(rs, channels):
    x = np.random.RandomState(0).rand(3, 40, 52).astype(np.float32)
    if channels:
        x = x[..., None]
    got = img_resize(x, rs)
    ref = jax_img.img_resize(x, rs)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 60, 60), (1, 64, 57, 1),
                                   (3, 16, 16)])
def test_img_pad_and_format_match_jax(shape):
    x = np.random.RandomState(1).rand(*shape).astype(np.float32) * 3
    padded = img_pad(x, 8)
    np.testing.assert_array_equal(padded, jax_img.img_pad(x, 8))
    np.testing.assert_array_equal(format_image(padded),
                                  jax_preproc.format_image(padded))


def test_default_precision_per_device():
    assert default_precision("cpu") == Precision.full()
    assert default_precision("cuda").compute_dtype == torch.bfloat16
    assert default_precision("cuda").allow_tf32
    assert not Precision.full().allow_tf32
    set_default_precision(Precision.full())
    try:
        assert default_precision("cuda") == Precision.full()
    finally:
        set_default_precision(None)
    assert default_precision("cuda") == Precision.mixed()


@pytest.mark.parametrize("policy", [Precision.full(), Precision.mixed()])
def test_scope_sets_and_restores_tf32(policy):
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with policy.scope("cpu"):
        assert torch.backends.cudnn.allow_tf32 == policy.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 == policy.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


def test_generator_from_seed_is_reproducible():
    a = torch.rand(5, generator=generator_from_seed(3))
    b = torch.rand(5, generator=generator_from_seed(3))
    c = torch.rand(5, generator=generator_from_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("shape,patch,n,seed", [
    ((64, 64), (16, 16), 20, 0), ((50, 40), (32, 8), 7, 3)])
def test_extract_patches_2d_equals_jax_package(shape, patch, n, seed):
    image = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    np.testing.assert_array_equal(
        extract_patches_2d(image, patch, n, seed),
        jax_img.extract_patches_2d(image, patch, n, seed))


@pytest.mark.parametrize("labels,n", [([0, 2, 1, 2], 3), ([[1], [0]], 2)])
def test_to_onehot_equals_jax_package(labels, n):
    np.testing.assert_array_equal(to_onehot(np.array(labels), n),
                                  jax_preproc.to_onehot(np.array(labels), n))
    with pytest.raises(AssertionError, match="Labelling"):
        to_onehot(np.array(labels), 1)


def test_mixed_policy_runs_linear_layers_in_bf16_and_heads_in_f32():
    """Under the mixed scope a hidden ``nn.Linear`` computes in bf16 and a
    head through ``head_f32`` in float32 (autocast on the CPU stands in
    for the card's)."""
    hidden, head = torch.nn.Linear(8, 8), torch.nn.Linear(8, 2)
    x = torch.randn(4, 8)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        h = hidden(x)
        out = head_f32(head, h)
    assert h.dtype == torch.bfloat16
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, head(h.float()))


def test_generator_seq_is_a_deterministic_stream():
    a, b = GeneratorSeq(3), GeneratorSeq(3)
    draws_a = [torch.rand(4, generator=g) for g in a.next(3)]
    draws_b = [torch.rand(4, generator=b.next()) for _ in range(3)]
    for x, y in zip(draws_a, draws_b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(draws_a[0], draws_a[1])
