"""Plotting helpers (counterpart of `atomai_tpu/utils/viz.py:15-20,
153-170`): matplotlib's pyplot on the Agg backend, and a GIF from a
directory of PNGs. matplotlib and PIL are imported inside the functions,
so the package imports without them; where they are absent, plotting
raises ``ModuleNotFoundError``."""

import os
import shutil


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
