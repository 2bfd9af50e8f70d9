"""Explicit random generators (counterpart of `atomai_tpu/core/prng.py`).

A seed becomes a ``torch.Generator``; nothing seeds torch's global
generator. The numbers differ from ``jax.random``'s for the same seed, so
tests that compare the two packages make their inputs with numpy.
"""

import torch


def generator_from_seed(seed: int) -> torch.Generator:
    """A CPU generator seeded with ``seed``; weights are drawn on the host
    and then moved, so a seed gives the same weights on every device."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return g
