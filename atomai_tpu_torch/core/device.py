"""The device an entry point runs on."""

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a machine where
    torch sees none raises instead of running elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device='{device}' was asked for, but torch "
                           "sees no CUDA device")
    return device
