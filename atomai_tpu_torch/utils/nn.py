"""Weight and class utilities (counterpart of `atomai_tpu/utils/nn.py`):
the ensemble average and SWAG-style sampling of ``state_dict``s, seeding,
Xavier re-initialisation, BatchNorm resets, parameter counts, the
combining and renumbering of atom classes, a net's classes and
downsampling factor, and the card's memory use."""

import math
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

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


def set_train_rng(seed: int = 1) -> torch.Generator:
    """Seeds numpy's global generator (the host's shuffles) and returns a
    CPU ``torch.Generator`` seeded with ``seed`` (the JAX package returns a
    key)."""
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


@torch.no_grad()
def weights_init(module: nn.Module, generator: torch.Generator
                 ) -> nn.Module:
    """Redraws the weight of every convolution and linear layer of
    ``module`` from Xavier's uniform U(+-sqrt(6 / (fan_in + fan_out)))
    (torch's fans: a conv's receptive field counts in both; the JAX
    package's fan_out leaves it out) and zeroes their biases, in place;
    draws on the generator's device. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear,
                          nn.ConvTranspose2d)):
            fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(
                m.weight)
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            m.weight.copy_(torch.empty(
                m.weight.shape, dtype=m.weight.dtype,
                device=generator.device).uniform_(-bound, bound,
                                                  generator=generator))
            if m.bias is not None:
                m.bias.zero_()
    return module


@torch.no_grad()
def reset_bnorm(module: nn.Module) -> nn.Module:
    """Sets the running means of every BatchNorm layer of ``module`` to 0
    and its running variances to 1, in place. Returns ``module``."""
    for m in module.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm) and \
                m.track_running_stats:
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return module


def num_params(module: nn.Module) -> int:
    """Number of trainable parameters (BatchNorm's running statistics are
    buffers and do not count, as in the JAX package's ``params``)."""
    return sum(p.numel() for p in module.parameters())


def combine_classes(coord_class_dict: Dict[int, np.ndarray],
                    classes_to_combine: List[List[int]],
                    renumerate: bool = True) -> Dict[int, np.ndarray]:
    """Merges the classes of each list of ``classes_to_combine`` into its
    first, in every frame's (n, 3) [row, col, class] array; then
    renumbers them from 1 (``renumerate``)."""
    coord_class_dict_ = {}
    for i, coord in coord_class_dict.items():
        coord_ = coord.copy()
        for comb in classes_to_combine:
            for c in comb[1:]:
                coord_[:, -1][coord_[:, -1] == c] = comb[0]
        coord_class_dict_[i] = coord_
    if renumerate:
        coord_class_dict_ = renumerate_classes(coord_class_dict_)
    return coord_class_dict_


def renumerate_classes_(coord: np.ndarray, start_from_1: bool = True
                        ) -> np.ndarray:
    """The classes of (n, 3) [row, col, class] renumbered 0, 1, ... in
    ascending order (from 1 with ``start_from_1``)."""
    coord_ = coord.copy()
    for i, u in enumerate(np.unique(coord[:, -1])):
        coord_[:, -1][coord[:, -1] == u] = i
    if start_from_1:
        coord_[:, -1] = coord_[:, -1] + 1
    return coord_


def renumerate_classes(coord_class_dict: Dict[int, np.ndarray],
                       start_from_1: bool = True
                       ) -> Dict[int, np.ndarray]:
    """:func:`renumerate_classes_` of every frame."""
    return {i: renumerate_classes_(coord, start_from_1)
            for i, coord in coord_class_dict.items()}


@torch.no_grad()
def mock_forward(net: nn.Module, dims: Tuple[int, int] = (32, 32)
                 ) -> np.ndarray:
    """The eval-mode output of ``net`` for one zero image (1, 1, h, w) on
    the net's device, as numpy in the port's layout (NCHW for the
    segmentation nets); the net's mode is restored."""
    p = next(net.parameters(), None)
    x = torch.zeros((1, 1) + tuple(dims),
                    device=p.device if p is not None else "cpu")
    training = net.training
    net.eval()
    try:
        return net(x).float().cpu().numpy()
    finally:
        net.train(training)


def get_nb_classes(net: nn.Module) -> int:
    """The net's output classes: its ``nb_classes``, else the channels of
    :func:`mock_forward`."""
    nb = getattr(net, "nb_classes", None)
    if nb is not None:
        return int(nb)
    return int(mock_forward(net).shape[1])


def get_downsample_factor(net: nn.Module) -> int:
    """The net's total downsampling: ``nets.fcnn.DOWNSAMPLE_FACTORS`` for
    the package's nets, else the first of 8, 4, 2, 1 whose 8-multiple
    input the net returns at its own size (``mock_forward``), else 1."""
    from ..nets.fcnn import DOWNSAMPLE_FACTORS
    name = type(net).__name__
    if name in DOWNSAMPLE_FACTORS:
        return DOWNSAMPLE_FACTORS[name]
    for f in (8, 4, 2, 1):
        try:
            if mock_forward(net, dims=(f * 8, f * 8)).shape[2] == f * 8:
                return f
        except RuntimeError:
            continue
    return 1


def gpu_usage_map() -> Dict[str, Any]:
    """The card's memory use (``core.profiling.device_memory_stats``)."""
    from ..core.profiling import device_memory_stats
    return device_memory_stats()
