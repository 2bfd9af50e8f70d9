"""A run with the timed path broken underneath comes out not correct.

Each case skips the harness's look for a card and drives the rest of a run
on the CPU at a small size, with one fault planted in the program where it
produces its answer: a map, a member's map or a cluster mean altered.
(No cell trains, so no step can leave its state unchanged or its batch
half out; no cell runs over several chips, so no exchange between chips
can be left out.) The same run without the fault is correct."""

import numpy as np
import pytest
import torch

import harness
from conftest import tiny


def _run(bench, cell):
    out = harness.run_cell(tiny(harness.load_cell(bench, cell)), 97531, 0.3,
                           False, torch.device("cpu"), 0.0)
    return out["result"]


def _altered_map(monkeypatch):
    from atomai_tpu_torch.predictors.predictor import SegPredictor
    orig = SegPredictor.predict_device

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        y = out[0] if isinstance(out, tuple) else out
        y[0, 0, 0, 0] += 0.5
        return out
    monkeypatch.setattr(SegPredictor, "predict_device", altered)


def _altered_member_map(monkeypatch):
    from atomai_tpu_torch.predictors.epredictor import EnsemblePredictor
    orig = EnsemblePredictor._member_outputs

    def altered(self, x):
        out = orig(self, x).clone()
        out[-1, 0, 5, 5] += 0.5
        return out
    monkeypatch.setattr(EnsemblePredictor, "_member_outputs", altered)


def _altered_cluster(monkeypatch):
    from atomai_tpu_torch.predictors import epredictor
    orig = epredictor.cluster_coord

    def altered(coords, eps, min_samples=10):
        clusters, means, var = orig(coords, eps, min_samples)
        extra = np.array([[32.0, 32.0]])
        return clusters, np.concatenate([means.reshape(-1, 2), extra]), var
    monkeypatch.setattr(epredictor, "cluster_coord", altered)


@pytest.mark.parametrize("cell", ["unet256.serve", "ens512.serve"])
def test_sound_run_is_correct(bench, cell):
    assert _run(bench, cell)["correct"] is True


@pytest.mark.parametrize("cell,fault,number", [
    ("unet256.serve", _altered_map, "map_gap"),
    ("ens512.serve", _altered_member_map, "map_gap"),
    ("ens512.serve", _altered_cluster, "cluster_gap"),
])
def test_fault_is_not_correct(bench, monkeypatch, cell, fault, number):
    fault(monkeypatch)
    res = _run(bench, cell)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"]
