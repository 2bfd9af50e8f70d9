"""The port's examples (``examples_torch/``) run end to end on the CPU:
each script in a subprocess of its own with ``--device cpu --smoke``, all
six at once on one thread each (the multi-device one in two ranks), printing what its workflow produces and
writing no figure unless asked. (Without ``--device`` each asks for the
card: ``test_torch_trainer.py::test_entry_points_default_to_the_card``.)
"""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples_torch")

# what each script prints when its workflow ran through, and its extra
# arguments here
RUNS = {
    "segmentation_workflow.py": (["--remat"], ["atoms in frame 0:",
                                               "PCA components:"]),
    "rvae_workflow.py": ([], ["latent mean:", "manifold image:"]),
    "ensemble_uncertainty.py": ([], ["prediction mean:", "frame-0 atoms:"]),
    "dkl_active_learning.py": ([], ["posterior mean/var:"]),
    "graph_analysis_notebook.py": (["--plot"], ["defect clusters: 1",
                                                "POSCAR written: True"]),
    "multichip_training.py": ([], ["segmentor data mesh: (2, 1)",
                                   "rVAE data mesh: (2, 1)",
                                   "ensemble members on every rank: 4",
                                   "DKL model mesh: (1, 2)",
                                   "tiled predict output: (8, 64, 64, 1)",
                                   "2 ranks ended with maps of one shape: "
                                   "True"]),
}


def test_every_example_is_run():
    scripts = sorted(f for f in os.listdir(EXAMPLES)
                     if f.endswith(".py") and not f.startswith("_"))
    assert scripts == sorted(RUNS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every example started at once, each in its own process on one
    thread and in its own directory: {name: (exit code, stdout, stderr,
    the directory)}."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])),
        AOI_AUTO_MESH="1")     # the suite's default is off; a user's is on
    started = {}
    for name, (extra, _) in RUNS.items():
        cwd = tmp_path_factory.mktemp(name[:-3])
        started[name] = (subprocess.Popen(
            [sys.executable, os.path.join(EXAMPLES, name), "--device", "cpu",
             "--smoke", "--out", str(cwd / "out"), *extra],
            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), cwd)
    done = {}
    for name, (proc, cwd) in started.items():
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        done[name] = (proc.returncode, out, err, cwd)
    return done


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, runs):
    extra, expected = RUNS[name]
    rc, out, err, cwd = runs[name]
    assert rc == 0, out[-2000:] + err[-3000:]
    for line in expected:
        assert line in out, (line, out[-2000:])
    figures = sorted(f for f in os.listdir(cwd / "out")
                     if f.endswith(".png"))
    assert bool(figures) == ("--plot" in extra), figures
    assert os.listdir(cwd) == ["out"]
