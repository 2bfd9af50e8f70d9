"""Precision policy (counterpart of `atomai_tpu/core/dtypes.py:15-61`).

Parameters and outputs are always float32. On a CUDA device the default
is "mixed": convs and ``nn.Linear`` layers run in bfloat16 under autocast,
as the JAX package runs its Conv and hidden Dense layers in its compute
dtype (`atomai_tpu/nets/blocks.py:49-51` ``_cdtype``). A head that the JAX
package keeps in float32 (the VAE encoders' ``z_mu``/``z_logstd``, the
decoders' output layer) runs through :func:`head_f32`, outside autocast.
On the CPU everything runs in float32. The TF32 switches of cuDNN and
cuBLAS are set from the policy every time a model runs under it, never
left at torch's defaults (cuDNN runs float32 convs in TF32 unless told
otherwise), and are put back as they were when the run ends.
"""

import contextlib
import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """Compute dtype and TF32 switch of a forward pass."""
    compute_dtype: torch.dtype = torch.float32
    allow_tf32: bool = False

    @classmethod
    def mixed(cls) -> "Precision":
        # the float32 ops left outside autocast (the 1x1 pixel head) may
        # take TF32, as the JAX package runs its f32 matmuls in bf16 passes
        return cls(compute_dtype=torch.bfloat16, allow_tf32=True)

    @classmethod
    def full(cls) -> "Precision":
        return cls()

    @contextlib.contextmanager
    def scope(self, device: torch.device):
        """Runs the enclosed forward under this policy on ``device``."""
        device = torch.device(device)
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.allow_tf32
        try:
            with torch.autocast(device.type, dtype=self.compute_dtype,
                                enabled=self.compute_dtype != torch.float32):
                yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved


_OVERRIDE: Optional[Precision] = None


def default_precision(device: Union[str, torch.device]) -> Precision:
    """The policy for ``device``: an explicit :func:`set_default_precision`
    wins; otherwise mixed on CUDA and full float32 elsewhere, as the JAX
    package picks mixed for any non-CPU backend."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    if torch.device(device).type == "cuda":
        return Precision.mixed()
    return Precision.full()


def head_f32(layer: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in float32 with autocast off: the policy's rule for
    heads, whatever scope the caller runs under."""
    with torch.autocast(x.device.type, enabled=False):
        return layer(x.float())


def set_default_precision(p: Optional[Precision]) -> None:
    """Pins the policy for every device; ``None`` restores the default."""
    global _OVERRIDE
    _OVERRIDE = p
