"""The benchmark's frozen traffic source: synthetic graphene-like lattices
of 2D-Gaussian atoms with their ground-truth masks.

A copy of the port's ``utils/imgen.py`` ``make_lattice_stack`` (itself the
JAX package's generator, bit for bit), kept here so that a later change to
the program cannot change the benchmark's inputs. A seed gives the same
images and masks.
"""

from typing import Callable, List, Tuple

import numpy as np


class MakeAtom:
    """An atom modelled as a 2D Gaussian + a circular mask."""

    def __init__(self, sc: int = 5, r_mask: int = 3, intensity: float = 1,
                 theta: float = 0, offset: float = 0):
        if sc % 2 == 0:
            sc += 1
        self.xo, self.yo = sc / 2, sc / 2
        x = np.linspace(0, sc, sc)
        y = np.linspace(0, sc, sc)
        self.x, self.y = np.meshgrid(x, y)
        self.sigma_x, self.sigma_y = sc / 4, sc / 4
        self.intensity = intensity
        self.theta = theta
        self.offset = offset
        self.r_mask = r_mask

    def atom2dgaussian(self) -> np.ndarray:
        th = self.theta
        a = (np.cos(th) ** 2) / (2 * self.sigma_x ** 2) + \
            (np.sin(th) ** 2) / (2 * self.sigma_y ** 2)
        b = -(np.sin(2 * th)) / (4 * self.sigma_x ** 2) + \
            (np.sin(2 * th)) / (4 * self.sigma_y ** 2)
        c = (np.sin(th) ** 2) / (2 * self.sigma_x ** 2) + \
            (np.cos(th) ** 2) / (2 * self.sigma_y ** 2)
        g = self.offset + self.intensity * np.exp(
            -(a * ((self.x - self.xo) ** 2) +
              2 * b * (self.x - self.xo) * (self.y - self.yo) +
              c * ((self.y - self.yo) ** 2)))
        return g

    def circularmask(self, image: np.ndarray, radius: float) -> np.ndarray:
        h, w = self.x.shape
        X, Y = np.ogrid[:h, :w]
        dist = np.sqrt((X - self.xo + 0.5) ** 2 + (Y - self.yo + 0.5) ** 2)
        image = image.copy()
        image[dist > radius] = 0
        return image

    def gen_atom_mask(self) -> Tuple[np.ndarray, np.ndarray]:
        atom = self.atom2dgaussian()
        mask = self.circularmask(atom.copy(), self.r_mask / 2)
        nz = np.where(mask > 0)
        mask = mask[nz[0].min():nz[0].max() + 1, nz[1].min():nz[1].max() + 1]
        mask[mask > 0] = 1
        return atom, mask


def create_atom_mask_pair(sc: int = 5, r_mask: int = 5,
                          intensity: float = 1):
    """Helper creating an (atom, mask) pair."""
    return MakeAtom(sc, r_mask, intensity).gen_atom_mask()


def create_lattice_mask(lattice: np.ndarray, xy_atoms: np.ndarray,
                        *args: Callable, **kwargs: int) -> np.ndarray:
    """Single-class ground-truth mask from xy coordinates."""
    create_mask_func = args[0] if len(args) == 1 else create_atom_mask_pair
    scale = kwargs.get("scale", 7)
    rmask = kwargs.get("rmask", 5)
    lattice_mask = np.zeros_like(lattice)
    _, mask = create_mask_func(scale, rmask)
    r_m = mask.shape[0] / 2
    r_m1 = int(r_m + .5)
    r_m2 = int(r_m - .5)
    H, W = lattice.shape
    for xy in xy_atoms:
        x = int(np.around(xy[0]))
        y = int(np.around(xy[1]))
        if x - r_m1 < 0 or y - r_m1 < 0 or x + r_m2 > H or y + r_m2 > W:
            continue
        lattice_mask[x - r_m1:x + r_m2, y - r_m1:y + r_m2] = mask
    return lattice_mask


def make_lattice_stack(n_images: int = 8, size: int = 256,
                       spacing: int = 16, jitter: float = 1.5,
                       noise: float = 0.1, seed: int = 0,
                       scale: int = 7, rmask: int = 5
                       ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """Synthetic graphene-like lattice stacks for tests and benchmarks.

    Returns (images (n, size, size), masks (n, size, size),
    coordinates [n](atoms, 2)).
    """
    rng = np.random.RandomState(seed)
    atom = MakeAtom(scale, rmask).atom2dgaussian()
    a = atom.shape[0]
    images = np.zeros((n_images, size, size), dtype=np.float32)
    masks = np.zeros((n_images, size, size), dtype=np.float32)
    coords_all = []
    grid = np.arange(spacing, size - spacing, spacing)
    for i in range(n_images):
        xy = np.array([[x, y] for x in grid for y in grid], dtype=float)
        xy += rng.randn(*xy.shape) * jitter
        coords_all.append(xy.copy())
        img = np.zeros((size, size), dtype=np.float32)
        half = a // 2
        for x, y in np.round(xy).astype(int):
            x0, x1 = x - half, x - half + a
            y0, y1 = y - half, y - half + a
            if x0 < 0 or y0 < 0 or x1 > size or y1 > size:
                continue
            img[x0:x1, y0:y1] += atom
        img += rng.randn(size, size).astype(np.float32) * noise
        images[i] = img
        masks[i] = create_lattice_mask(img, xy, scale=scale, rmask=rmask)
    lo, hi = images.min(), images.max()
    images = (images - lo) / max(hi - lo, 1e-12)
    return images, masks, coords_all
