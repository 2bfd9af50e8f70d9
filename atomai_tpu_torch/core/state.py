"""Stochastic weight averaging state (counterpart of
`atomai_tpu/core/state.py:19-47` ``SwaState``).

Running sum and sum of squares of a dict of parameter tensors, in float32
on the parameters' device: O(1) memory over the averaging window, and the
second moment gives the weights' variance (SWAG-style sampling). Only
parameters are averaged; BatchNorm running statistics are buffers, as in
the JAX package, where ``batch_stats`` are not in ``params``.
"""

from typing import Dict, Mapping

import torch


class SwaState:
    """Running moments of named parameters over the SWA window."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        self.sum = {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}
        self.sq_sum = {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()}
        self.n = 0

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor]) -> None:
        for k, p in params.items():
            p = p.detach().float()
            self.sum[k].add_(p)
            self.sq_sum[k].addcmul_(p, p)
        self.n += 1

    def mean(self) -> Dict[str, torch.Tensor]:
        n = float(max(self.n, 1))
        return {k: s / n for k, s in self.sum.items()}

    def variance(self) -> Dict[str, torch.Tensor]:
        n = float(max(self.n, 1))
        mean = self.mean()
        return {k: torch.clamp(sq / n - mean[k] * mean[k], min=0.0)
                for k, sq in self.sq_sum.items()}
