"""Explicit random generators (counterpart of `atomai_tpu/core/prng.py`).

A seed becomes a ``torch.Generator``; nothing seeds torch's global
generator. The numbers differ from ``jax.random``'s for the same seed, so
tests that compare the two packages make their inputs with numpy.
"""

from typing import List, Optional, Union

import torch


def generator_from_seed(seed: int, device: Union[str, torch.device] = "cpu"
                        ) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``. Weights are drawn on
    the host (the default) and then moved, so a seed gives the same
    weights on every device."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class GeneratorSeq:
    """A deterministic stream of generators, the counterpart of the JAX
    package's ``KeySeq`` (`atomai_tpu/core/prng.py:18-40`): where JAX
    splits a key, this draws the seed of a fresh generator from a host
    generator seeded once."""

    def __init__(self, seed: int):
        self._g = generator_from_seed(seed)

    def next(self, num: Optional[int] = None,
             device: Union[str, torch.device] = "cpu"
             ) -> Union[torch.Generator, List[torch.Generator]]:
        """One generator on ``device``, or a list of ``num``."""
        if num is None:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._g))
            return generator_from_seed(seed, device)
        return [self.next(device=device) for _ in range(num)]
