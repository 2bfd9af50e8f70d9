"""Plotting helpers (counterpart of `atomai_tpu/utils/viz.py:15-20,
90-106, 153-170`): matplotlib's pyplot on the Agg backend, the heatmap of
a transition matrix, and a GIF from a directory of PNGs. matplotlib and PIL are imported inside the functions,
so the package imports without them; where they are absent, plotting
raises ``ModuleNotFoundError``."""

import os
import shutil
from typing import Optional

import numpy as np


def _plt():
    """matplotlib.pyplot, on the Agg backend unless one is chosen."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def animation_from_png(png_dir: str, moviename: str = "anim",
                       duration: float = 1, savedir: str = "./",
                       remove_dir: bool = True) -> None:
    """Writes ``savedir``/``moviename``.gif from the PNGs of ``png_dir``
    in name order, ``duration`` seconds a frame, looping; removes
    ``png_dir`` when ``remove_dir``."""
    from PIL import Image
    images = [Image.open(os.path.join(png_dir, f)).copy()
              for f in sorted(os.listdir(png_dir)) if f.endswith(".png")]
    if images:
        os.makedirs(savedir, exist_ok=True)
        images[0].save(os.path.join(savedir, moviename + ".gif"),
                       save_all=True, append_images=images[1:],
                       duration=int(duration * 1000), loop=0)
    if remove_dir:
        shutil.rmtree(png_dir, ignore_errors=True)


def plot_transitions(m: np.ndarray, gmm_components: Optional[np.ndarray]
                     = None, plot_values: bool = False, **kwargs) -> None:
    """Heatmap of a transition matrix (``fsize``, ``cmap``, ``savefig``:
    a file to write), with each value printed when ``plot_values``."""
    plt = _plt()
    fsize = kwargs.get("fsize", 6)
    fig, ax = plt.subplots(1, 1, figsize=(fsize, fsize))
    im = ax.imshow(m, cmap=kwargs.get("cmap", "Reds"))
    if plot_values:
        for (j, i), v in np.ndenumerate(m):
            ax.text(i, j, "{:0.2f}".format(v), ha="center", va="center")
    fig.colorbar(im)
    ax.set_xlabel("Transition class")
    ax.set_ylabel("Starting class")
    if kwargs.get("savefig"):
        fig.savefig(kwargs["savefig"])
    plt.close(fig)
