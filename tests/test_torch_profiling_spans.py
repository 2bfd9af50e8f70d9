"""The port's spans and counters (``core.profiling``) on its serve path, on
the CPU with a tiny Unet: nothing is recorded without a profiler, the span
tree under one (parents, intervals, self times), the shared clock with the
profiler's events, one profiled stretch at a time, and the spans in
``trace``'s Chrome trace."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from atomai_tpu_torch import models
from atomai_tpu_torch.core import profiling
from atomai_tpu_torch.predictors import (EnsemblePredictor, SegPredictor,
                                         ensemble_locate)
from atomai_tpu_torch.utils import make_lattice_stack

TRANSFERS = ("predictor.upload", "predictor.fetch", "locator.upload",
             "locator.fetch", "labeller.fetch")


@pytest.fixture(scope="module")
def net():
    return models.Segmentor("Unet", 1, nb_filters=4, layers=[1, 1, 1, 1],
                            device="cpu", seed=3).net


@pytest.fixture(scope="module")
def stack():
    imgs, masks, _ = make_lattice_stack(n_images=2, size=48, spacing=12,
                                        seed=1)
    return imgs, masks


def _member_maps(masks, n_models=3):
    """(members, frames, h, w, 1) maps: the lattice masks, shifted a pixel
    a member."""
    return np.stack([np.roll(masks, m % 2, axis=1 + m // 2)
                     for m in range(n_models)])[..., None].astype(np.float32)


def _ensemble(net):
    members = {}
    for i in range(2):
        g = torch.Generator().manual_seed(i)
        members[i] = {k: v + 0.05 * torch.randn(v.shape, generator=g)
                      if v.is_floating_point() else v
                      for k, v in net.state_dict().items()}
    return EnsemblePredictor(net, members, nb_classes=1, verbose=0)


def _calls(net, stack):
    imgs, masks = stack
    ens = _ensemble(net)
    return {
        "predictor.run": lambda: SegPredictor(
            net, nb_classes=1, verbose=False).run(imgs),
        "predictor.predict": lambda: ens.predict(imgs),
        "predictor.ensemble_forward": lambda: ens.ensemble_forward(
            ens.preprocess(imgs)),
        "locator.ensemble_locate": lambda: ensemble_locate(
            _member_maps(masks), eps=1.5, min_samples=2, device="cpu"),
    }


# each root's children, and those of its children, on the CPU path (the
# labeller's wait, ``labeller.fetch``, is the CUDA kernel's)
TREE = {
    "predictor.run": {
        "predictor.run": {"predictor.preprocess", "predictor.forward",
                          "locator.run", "predictor.fetch"},
        "predictor.preprocess": {"predictor.upload"},
        "locator.run": {"locator.fetch"}},
    "predictor.predict": {
        "predictor.predict": {"predictor.preprocess", "predictor.forward",
                              "predictor.fetch"},
        "predictor.preprocess": {"predictor.upload"}},
    "predictor.ensemble_forward": {
        "predictor.ensemble_forward": {"predictor.forward",
                                       "predictor.fetch"}},
    "locator.ensemble_locate": {
        "locator.ensemble_locate": {"locator.run", "cluster.coord"},
        "locator.run": {"locator.upload", "locator.fetch"},
        "cluster.coord": {"cluster.dbscan"}},
}


def test_no_profiler_records_no_span_and_counters_count(net, stack):
    profiling.reset()
    for call in _calls(net, stack).values():
        call()
    assert profiling.spans() == []
    assert profiling.summary()["spans"] == {}
    profiling.count("test.requests")
    profiling.count("test.requests", 2)
    assert profiling.summary()["counters"]["test.requests"] == 3
    profiling.reset()
    assert "test.requests" not in profiling.summary()["counters"]


def test_span_without_profiler_is_the_shared_no_op():
    assert profiling.span("a.b") is profiling.span("c.d")
    assert profiling.annotate is profiling.span


@pytest.mark.parametrize("root", sorted(TREE))
def test_span_tree_under_a_profiler(net, stack, root):
    call = _calls(net, stack)[root]
    call()                                   # warm, unprofiled
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    records = profiling.spans()
    by_id = {r.id: r for r in records}
    roots = [r for r in records if r.parent is None]
    if root == "predictor.ensemble_forward":    # the caller's preprocess
        assert sorted(r.name for r in roots) == [
            "predictor.ensemble_forward", "predictor.preprocess"]
    else:
        assert [r.name for r in roots] == [root]
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent is None:
            assert r.root == r.id
            continue
        p = by_id[r.parent]
        assert r.root == p.root
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    want = TREE[root]
    for r in records:
        kids = {c.name for c in records if c.parent == r.id}
        if r.parent is None and r.name != root:
            continue
        assert kids == want.get(r.name, set()), r.name
    stats = profiling.summary()["spans"]
    for name, s in stats.items():
        assert s["count"] >= 1 and s["self_s"] >= 0
        assert s["self_s"] <= s["total_s"] + 1e-9
    for name in TRANSFERS:
        if name in stats:
            assert stats[name]["self_s"] == pytest.approx(
                stats[name]["total_s"])
    if root == "locator.ensemble_locate":
        assert stats["cluster.coord"]["count"] == 2       # one a frame
        assert stats["cluster.dbscan"]["total_s"] <= \
            stats["cluster.coord"]["total_s"]


def test_self_time_leaves_out_the_children():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("t.outer"):
            with profiling.span("t.inner"):
                torch.ones(256, 256) @ torch.ones(256, 256)
            with profiling.span("t.inner"):
                pass
    rec = {r.name: r for r in profiling.spans() if r.name == "t.outer"}
    inner = [r for r in profiling.spans() if r.name == "t.inner"]
    s = profiling.summary()["spans"]
    outer = rec["t.outer"]
    covered = sum(r.end_ns - r.start_ns for r in inner)
    assert s["t.inner"]["count"] == 2
    assert s["t.outer"]["self_s"] == pytest.approx(
        (outer.end_ns - outer.start_ns - covered) * 1e-9, abs=1e-9)


def test_profiler_events_share_the_spans_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("t.op"):
            torch.ones(128, 128) @ torch.ones(128, 128)
    span = next(r for r in profiling.spans() if r.name == "t.op")
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert span.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= span.end_ns


def test_a_new_profiled_stretch_replaces_the_last(net, stack):
    imgs, _ = stack
    p = SegPredictor(net, nb_classes=1, verbose=False)
    p.run(imgs)               # ends whatever profiled stretch came before
    with profile(activities=[ProfilerActivity.CPU]):
        p.run(imgs)
        p.run(imgs)
    assert profiling.summary()["spans"]["predictor.run"]["count"] == 2
    first = {r.id for r in profiling.spans()}
    p.run(imgs)                              # unprofiled: recorded nowhere
    assert {r.id for r in profiling.spans()} == first
    with profile(activities=[ProfilerActivity.CPU]):
        p.run(imgs)
    assert profiling.summary()["spans"]["predictor.run"]["count"] == 1
    assert not first & {r.id for r in profiling.spans()}
    profiling.reset()
    assert profiling.spans() == []


def test_trace_file_holds_the_program_spans(net, stack, tmp_path):
    imgs, _ = stack
    p = SegPredictor(net, nb_classes=1, verbose=False)
    with profiling.trace(str(tmp_path)):
        p.run(imgs)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    names = {e["name"] for e in spans}
    assert {"predictor.run", "predictor.preprocess", "predictor.upload",
            "predictor.forward", "locator.run", "locator.fetch",
            "predictor.fetch"} <= names
    run = next(e for e in spans if e["name"] == "predictor.run")
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    # the net's ops lie inside the root span on the trace's time base
    assert any(run["ts"] <= e["ts"] <= run["ts"] + run["dur"] for e in ops)
