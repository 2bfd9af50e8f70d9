"""Weight utilities on ``state_dict``s (counterpart of
`atomai_tpu/utils/nn.py:28-49`): the ensemble average and SWAG-style
sampling."""

from typing import Dict, List, Mapping

import torch

# BatchNorm buffers: kept from the first member, not averaged (original
# atomai's ``average_weights`` skips them by these name endings)
_NOT_AVERAGED = ("running_mean", "running_var", "num_batches_tracked")


def average_weights(ensemble: Mapping[int, Mapping[str, torch.Tensor]]
                    ) -> Dict[str, torch.Tensor]:
    """The mean of the members' ``state_dict``s; BatchNorm running
    statistics and counters are the first member's."""
    members = list(ensemble.values())
    out = {}
    for k, v in members[0].items():
        if k.endswith(_NOT_AVERAGED) or not v.is_floating_point():
            out[k] = v.clone()
        else:
            out[k] = sum(m[k] for m in members) / len(members)
    return out


def sample_weights(mean: Mapping[str, torch.Tensor],
                   var: Mapping[str, torch.Tensor],
                   generator: torch.Generator, n_samples: int = 1
                   ) -> List[Dict[str, torch.Tensor]]:
    """``n_samples`` draws of w ~ N(mean, max(var, 0)), each tensor's noise
    drawn from ``generator`` (on its device), in ``mean``'s key order."""
    samples = []
    for _ in range(n_samples):
        s = {}
        for k, m in mean.items():
            noise = torch.randn(m.shape, generator=generator,
                                device=generator.device, dtype=m.dtype)
            s[k] = m + torch.sqrt(torch.clamp(var[k], min=0.0)) \
                * noise.to(m.device)
        samples.append(s)
    return samples
