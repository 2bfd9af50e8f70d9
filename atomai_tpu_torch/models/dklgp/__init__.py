"""Deep kernel learning and GP models (counterpart of
`atomai_tpu/models/dklgp/__init__.py`)."""

from .dklgpr import dklGPR
from .gpr import Reconstructor

__all__ = ["dklGPR", "Reconstructor"]
