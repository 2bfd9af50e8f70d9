"""The port's CUDA graphs, all captured by one set of rules.

A :class:`GraphedCall` runs eagerly for its first ``warmup`` calls (cuDNN's
plans and lazy set-up warm there), then is captured, then replayed: a
replay copies the inputs into static ones and clones the output, which the
next replay overwrites. Eager and capturing calls run on the card's
:func:`capture_stream`. A capture calls ``CUDAGraph.capture_begin``, since
``torch.cuda.graph``'s entry empties the allocator's cache; and turns
autocast's cast cache off, so that the graph makes its own bfloat16 casts
of the parameters rather than reading casts made, and freed, outside it.
"""

import contextlib
from typing import Callable, Dict

import torch

_STREAMS: Dict[int, torch.cuda.Stream] = {}     # by device index
# a card's last graph in the shared pool, kept (never replayed again)
# because a pool that no graph holds cannot be shared
_LAST_SHARED: Dict[int, torch.cuda.CUDAGraph] = {}


@contextlib.contextmanager
def capture_stream(device: torch.device):
    """The enclosed calls on the card's capture stream (made on first
    use), which waits on the caller's stream and is waited on after."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    current = torch.cuda.current_stream(index)
    _STREAMS[index].wait_stream(current)
    try:
        with torch.cuda.stream(_STREAMS[index]):
            yield
    finally:
        current.wait_stream(_STREAMS[index])


class GraphedCall:
    """``fn(*inputs)``, tensors to a tensor, graphed after ``warmup`` eager
    calls. ``private``: the graph owns a memory pool, freed with it;
    otherwise it shares the pool of the card's last shared capture, and
    one such graph is replayed at a time."""

    def __init__(self, warmup: int, private: bool):
        self.warmup, self.private, self.calls = warmup, private, 0
        self.graph = self.inputs = self.output = None

    @property
    def stage(self) -> str:
        """What the next call does: "eager", "capture" or "replay"."""
        if self.graph is not None:
            return "replay"
        return "eager" if self.calls < self.warmup else "capture"

    def stream(self, device: torch.device):
        """The next call's context alone: :func:`capture_stream`, but none
        for a replay (entering costs ~40 us of host on an H100)."""
        return contextlib.nullcontext() if self.graph is not None \
            else capture_stream(device)

    def __call__(self, fn: Callable[..., torch.Tensor], *inputs):
        stage = self.stage
        self.calls += 1
        if stage == "eager":
            return fn(*inputs)
        if stage == "capture":
            self._capture(fn, inputs)
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.graph.replay()
        return self.output.clone()

    def _capture(self, fn, inputs) -> None:
        index = torch.cuda.current_device()
        self.inputs = [torch.empty_strided(x.shape, x.stride(),
                                           dtype=x.dtype, device=x.device)
                       for x in inputs]
        last = None if self.private else _LAST_SHARED.get(index)
        graph = torch.cuda.CUDAGraph()
        cache = torch.is_autocast_cache_enabled()
        torch.set_autocast_cache_enabled(False)
        graph.capture_begin(pool=None if last is None else last.pool())
        try:
            self.output = fn(*self.inputs)
        finally:
            graph.capture_end()
            torch.set_autocast_cache_enabled(cache)
        self.graph = graph
        if not self.private:
            _LAST_SHARED[index] = graph
