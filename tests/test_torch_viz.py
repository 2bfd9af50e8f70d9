"""The port's plotting on matplotlib's Agg backend: every function of
``utils.viz`` draws (and writes its file where one is asked for) from the
inputs that the JAX package's same function draws from, and the three
calls that raised before the plots were ported now plot:
``fit(plot_training_history=True)``, ``SpectralUnmixer.plot_results``
and ``compare_coordinates(plot_results=True)``; ``map_bonds`` draws each
frame's bonds. Plots are not compared pixel by pixel.
"""

import os

import matplotlib
import numpy as np
import pytest
import torch

from atomai_tpu.utils import viz as jviz
import atomai_tpu_torch as aoi
from atomai_tpu_torch.utils import viz

matplotlib.use("Agg")
torch.set_num_threads(1)


def _written(path):
    return os.path.isfile(path) and os.path.getsize(path) > 0


def _calls(mod):
    rng = np.random.RandomState(0)
    img = rng.rand(32, 32)
    coord = np.concatenate([rng.rand(10, 2) * 32, rng.randint(0, 3, (10, 1))],
                           1)
    traj = np.cumsum(rng.randn(12, 3), 0)
    d, pairs = aoi.utils.get_nn_distances_(coord, 2)
    return {
        "plot_losses": lambda f: mod.plot_losses(rng.rand(5), rng.rand(5),
                                                 savefig=f),
        "plot_coord": lambda f: mod.plot_coord(img, coord, savefig=f),
        "draw_boxes": lambda f: mod.draw_boxes(img, coord[:3], 4,
                                               savefig=f),
        "plot_trajectories": lambda f: mod.plot_trajectories(
            traj, np.arange(12), savefig=f),
        "plot_trajectories_transitions": lambda f:
            mod.plot_trajectories_transitions(
                {"trajectories": [traj], "frames": [np.arange(12)]}, 0,
                savefig=f),
        "plot_transitions": lambda f: mod.plot_transitions(
            rng.rand(3, 3), plot_values=True, savefig=f),
        "visualize_unmixing_results": lambda f:
            mod.visualize_unmixing_results(rng.rand(3, 20),
                                           rng.rand(8, 8, 3), savefig=f),
        "visualize_one_component": lambda f:
            mod.visualize_unmixing_results(rng.rand(20), rng.rand(8, 8, 1),
                                           savefig=f),
        "plot_lattice_bonds": lambda f: mod.plot_lattice_bonds(
            d, pairs, None, 3, True, savedir=os.path.dirname(f)),
    }


CALLS = sorted(_calls(viz))


@pytest.mark.parametrize("name", CALLS)
def test_plot_writes_its_file_as_jax_does(name, tmp_path):
    for mod, sub in ((viz, "port"), (jviz, "jax")):
        os.makedirs(tmp_path / sub)
        path = str(tmp_path / sub / "plot.png")
        _calls(mod)[name](path)
        if name == "plot_lattice_bonds":
            path = str(tmp_path / sub / "frame_3.png")
        assert _written(path), (sub, name)


def test_plot_coordinates_comparison_needs_the_image():
    c = np.random.RandomState(1).rand(5, 2)
    viz.plot_coordinates_comparison(c, np.ones(5), np.zeros((8, 8)))
    with pytest.raises(AssertionError, match="expdata"):
        viz.plot_coordinates_comparison(c, np.ones(5), None)


def test_fit_plots_its_training_history(tmp_path):
    rng = np.random.RandomState(1)
    X = rng.rand(8, 32, 32).astype(np.float32)
    y = (rng.rand(8, 32, 32) > 0.5).astype(np.float32)
    m = aoi.models.Segmentor("Unet", 1, nb_filters=4, layers=(1, 1, 1, 1),
                             device="cpu")
    fname = str(tmp_path / "seg")
    m.fit(X, y, X[:4], y[:4], training_cycles=3, batch_size=4,
          print_loss=3, filename=fname, plot_training_history=True)
    assert _written(fname + "_losses.png")


def test_unmixer_plots_its_results(tmp_path, capsys):
    cube = np.abs(np.random.RandomState(2).rand(8, 8, 16)).astype(
        np.float32)
    u = aoi.stat.SpectralUnmixer("nmf", 2, device="cpu")
    u.plot_results()
    assert "fit() first" in capsys.readouterr().out
    u.fit(cube)
    path = str(tmp_path / "unmix.png")
    u.plot_results(savefig=path)
    assert _written(path)


def test_compare_coordinates_and_map_bonds_plot(tmp_path):
    c1 = np.random.RandomState(3).rand(30, 2) * 64
    out = aoi.utils.compare_coordinates(c1, c1 + 0.2, 1.0,
                                        plot_results=True,
                                        expdata=np.zeros((64, 64)))
    assert len(out[0]) == 30
    frames = {0: np.concatenate([c1, np.zeros((30, 1))], 1)}
    d = aoi.utils.map_bonds(frames, 2, savedir=str(tmp_path))
    assert d.shape == (30, 2) and _written(str(tmp_path / "frame_0.png"))
