"""``core/graphs.py``'s capture rules on the CPU, with a stand-in for
``torch.cuda.CUDAGraph`` that records the captured work and runs it again
at each replay: the warm-up policy, the static inputs, the cloned output,
autocast's cast cache during a capture, and the memory pool a graph takes.
The graphs themselves are held to the eager calls bit for bit on the card
by ``chip_smoke.py``'s ``dkl_path`` and ``ensemble_graph`` phases."""

import contextlib

import pytest
import torch

from atomai_tpu_torch.core import graphs

torch.set_num_threads(1)


class FakeGraph:
    """Records the work a captured call queues; a replay runs it again."""
    capturing = None

    def __init__(self):
        self.work, self.begun_with, self.cast_cache = [], "unset", None

    def capture_begin(self, pool=None):
        self.begun_with = pool
        self.cast_cache = torch.is_autocast_cache_enabled()
        FakeGraph.capturing = self

    def capture_end(self):
        FakeGraph.capturing = None

    def pool(self):
        return ("pool of", id(self))

    def replay(self):
        for work in self.work:
            work()


def doubled(x):
    """``2 x``; under a capture, the work is recorded on its buffers."""
    out = x * 2
    if FakeGraph.capturing is not None:
        FakeGraph.capturing.work.append(lambda: out.copy_(x * 2))
    return out


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(graphs, "_LAST_SHARED", {})


@pytest.mark.parametrize("warmup", [1, 3])
def test_eager_then_captured_then_replayed(fake_cuda, warmup):
    """``warmup`` eager calls, a capture at the next (which replays too),
    replays after; each replay copies its input into the static one and
    returns a clone, so earlier results survive later replays. Only the
    eager and capturing calls ask for the capture stream."""
    call = graphs.GraphedCall(warmup, private=True)
    stages, outs, hops = [], [], []
    for i in range(warmup + 3):
        stages.append(call.stage)
        hops.append(not isinstance(call.stream(torch.device("cuda", 0)),
                                   contextlib.nullcontext))
        x = torch.arange(6.0).reshape(2, 3).t() + i     # not contiguous
        outs.append((x, call(doubled, x)))
    assert stages == ["eager"] * warmup + ["capture", "replay", "replay"]
    assert hops == [True] * (warmup + 1) + [False, False]
    for x, out in outs:
        assert torch.equal(out, x * 2)
    static = call.inputs[0]
    assert static.shape == x.shape and static.stride() == x.stride()
    assert call.output is not outs[-1][1]
    assert call.graph.begun_with is None        # a private pool
    assert call.graph.cast_cache is False
    assert torch.is_autocast_cache_enabled()    # restored after
    assert graphs._LAST_SHARED == {}


def test_shared_pool_follows_the_last_shared_capture(fake_cuda):
    """A shared capture takes the pool of the card's last shared one and
    becomes the last; a private capture neither takes nor gives it."""
    x = torch.ones(4)
    first = graphs.GraphedCall(0, private=False)
    first(doubled, x)
    assert first.graph.begun_with is None       # no earlier pool to share
    private = graphs.GraphedCall(0, private=True)
    private(doubled, x)
    second = graphs.GraphedCall(0, private=False)
    second(doubled, x)
    assert second.graph.begun_with == first.graph.pool()
    assert graphs._LAST_SHARED == {0: second.graph}


def test_a_call_without_inputs(fake_cuda):
    """The GP step's shape: no inputs, one tensor out, state changed in
    place by the captured work."""
    state = torch.zeros(())

    def step():
        if FakeGraph.capturing is None:
            return state.add_(1).clone()
        out = torch.empty(())     # a capture queues the work, runs none
        FakeGraph.capturing.work.append(lambda: out.copy_(state.add_(1)))
        return out
    call = graphs.GraphedCall(2, private=False)
    got = [float(call(step)) for _ in range(5)]
    assert got == [1.0, 2.0, 3.0, 4.0, 5.0]
