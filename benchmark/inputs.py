"""Inputs every driver makes the same way: seeded frames from the frozen
generator, and a seeded sample of the window's answers to check."""

from typing import Any, List, Tuple

import numpy as np

import lattice


def frames(spec: dict, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(images (n, size, size) float32, masks (n, size, size) float32) of
    a configuration's data entry (``n_images``, ``size``, ``spacing``,
    optional ``jitter``, ``noise``)."""
    s = int(np.random.SeedSequence(seed).generate_state(1)[0])
    return lattice.make_lattice_stack(
        n_images=spec["n_images"], size=spec["size"], spacing=spec["spacing"],
        jitter=spec.get("jitter", 1.5), noise=spec.get("noise", 0.1),
        seed=s)[:2]


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``seed`` (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.n = k, 0
        self.items: List[Any] = []
        self.rng = np.random.default_rng(seed)

    def offer(self, item_fn) -> None:
        """Offers the next item, made by ``item_fn()`` only when kept."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item_fn())
            return
        j = int(self.rng.integers(0, self.n))
        if j < self.k:
            self.items[j] = item_fn()
