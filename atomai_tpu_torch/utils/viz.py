"""Plotting helpers (counterpart of `atomai_tpu/utils/viz.py`): loss
curves, coordinates and boxes over images, trajectories, transition
matrices, lattice bonds, coordinate comparisons, unmixing results, and a
GIF from a directory of PNGs. matplotlib (pyplot on the Agg backend) and
PIL are imported inside the functions, so the package imports without
them; where they are absent, plotting raises ``ModuleNotFoundError``.
Each figure is closed after it is drawn (and written, where a file is
asked for)."""

import os
import shutil
from typing import Dict, List, Optional, Union

import numpy as np


def _plt():
    """matplotlib.pyplot, on the Agg backend unless one is chosen."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_losses(train_loss: Union[List[float], np.ndarray],
                test_loss: Union[List[float], np.ndarray],
                savefig: Optional[str] = None) -> None:
    """Train and test loss curves (``savefig``: a file to write)."""
    plt = _plt()
    fig, ax = plt.subplots(1, 1, figsize=(6, 6))
    ax.plot(train_loss, label="Train")
    ax.plot(test_loss, label="Test")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.legend()
    if savefig:
        fig.savefig(savefig)
    plt.close(fig)


def plot_coord(img: np.ndarray, coord: np.ndarray, fsize: int = 6,
               savefig: Optional[str] = None) -> None:
    """An image with (n, 3) [row, col, class] coordinates over it,
    coloured by class."""
    plt = _plt()
    y, x, c = coord[:, 0], coord[:, 1], coord[:, -1]
    fig, ax = plt.subplots(1, 1, figsize=(fsize, fsize))
    ax.imshow(img, cmap="gray")
    ax.scatter(x, y, c=c, cmap="RdYlGn", s=8)
    if savefig:
        fig.savefig(savefig)
    plt.close(fig)


def draw_boxes(imgdata: np.ndarray, defcoord: np.ndarray, bbox: int = 16,
               fsize: int = 6, savefig: Optional[str] = None) -> None:
    """An image with a 2 ``bbox`` square around each [row, col]."""
    plt = _plt()
    fig, ax = plt.subplots(1, 1, figsize=(fsize, fsize))
    ax.imshow(imgdata, cmap="gray")
    for point in defcoord:
        startx = int(round(point[0] - bbox))
        starty = int(round(point[1] - bbox))
        ax.add_patch(plt.Rectangle((starty, startx), bbox * 2, bbox * 2,
                                   fill=False, edgecolor="orange", lw=2))
    ax.grid(False)
    if savefig:
        fig.savefig(savefig)
    plt.close(fig)


def plot_trajectories(traj: np.ndarray, frames: np.ndarray,
                      **kwargs: Union[int, str]) -> None:
    """One trajectory's (m, 2+) [row, col, ...] positions joined in order
    (``fsize``, ``savefig``)."""
    plt = _plt()
    fsize = kwargs.get("fsize", 6)
    fig, ax = plt.subplots(1, 1, figsize=(fsize, fsize))
    ax.plot(traj[:, 1], traj[:, 0], "-o", ms=4)
    ax.invert_yaxis()
    if kwargs.get("savefig"):
        fig.savefig(kwargs["savefig"])
    plt.close(fig)


def plot_trajectories_transitions(trans_dict: Dict, k: int,
                                  **kwargs) -> None:
    """:func:`plot_trajectories` of trajectory ``k`` of a transitions
    dict (``"trajectories"``, ``"frames"``)."""
    plot_trajectories(trans_dict["trajectories"][k],
                      trans_dict["frames"][k], **kwargs)


def plot_lattice_bonds(distances: np.ndarray, atom_pairs: np.ndarray,
                       distance_ideal: Optional[float] = None,
                       frame: int = 0, display_results: bool = True,
                       **kwargs: Union[str, int]) -> None:
    """Each atom's bonds to its neighbours (``get_nn_distances_``'s
    output), coloured by their deviation from ``distance_ideal`` (default:
    the mean), on an ``h`` x ``w`` canvas (default 512); written to
    ``savedir``/frame_<frame>.png when ``savedir`` is given or when not
    ``display_results``."""
    plt = _plt()
    savedir = kwargs.get("savedir", "./")
    h, w = kwargs.get("h", 512), kwargs.get("w", 512)
    if distance_ideal is None:
        distance_ideal = np.mean(distances)
    fig, ax = plt.subplots(1, 1, figsize=(8, 8))
    for d, pairs in zip(distances, atom_pairs):
        for dd, p in zip(np.atleast_1d(d), pairs[1:]):
            dev = abs(dd - distance_ideal)
            ax.plot([pairs[0][1], p[1]], [pairs[0][0], p[0]],
                    c=plt.cm.jet(min(dev / max(distance_ideal, 1e-9), 1.0)))
    ax.set_xlim(0, w)
    ax.set_ylim(h, 0)
    if not display_results or kwargs.get("savedir"):
        os.makedirs(savedir, exist_ok=True)
        fig.savefig(os.path.join(savedir, f"frame_{frame}.png"))
    plt.close(fig)


def plot_coordinates_comparison(coordinates: np.ndarray,
                                delta_r: List[float],
                                expdata: Optional[np.ndarray],
                                fsize: int = 20) -> None:
    """Coordinates over the image ``expdata`` (required), coloured by
    their deviation ``delta_r`` (``compare_coordinates``' plot)."""
    if expdata is None:
        raise AssertionError(
            "For plotting, provide 2D image via 'expdata' keyword")
    plt = _plt()
    fig = plt.figure(figsize=(int(fsize * 1.25), fsize))
    plt.imshow(expdata, cmap="gray")
    im = plt.scatter(coordinates[:, 1], coordinates[:, 0],
                     c=np.array(delta_r), cmap="jet", s=5)
    clrbar = plt.colorbar(im)
    clrbar.set_label("Position deviation (px)")
    plt.close(fig)


def visualize_unmixing_results(components: np.ndarray,
                               abundances: np.ndarray, figsize: int = 4,
                               savefig: Optional[str] = None) -> None:
    """Each unmixed component's spectrum above its (h, w) abundance map."""
    plt = _plt()
    components = np.atleast_2d(components)
    n = components.shape[0]
    fig, axes = plt.subplots(2, n, figsize=(figsize * n, 2 * figsize))
    axes = np.asarray(axes).reshape(2, n)
    for i in range(n):
        axes[0, i].plot(components[i])
        axes[0, i].set_title(f"Component {i + 1}")
        axes[1, i].imshow(abundances[..., i], cmap="viridis")
        axes[1, i].set_title(f"Abundance {i + 1}")
    if savefig:
        fig.savefig(savefig)
    plt.close(fig)


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
