"""
atomai_tpu_torch — the PyTorch/CUDA port of ``atomai_tpu``.

This slice carries the segmentation serving path: ``Segmentor("Unet")``
-> ``SegPredictor`` (min-max normalise, forward, sigmoid) -> ``Locator``
(threshold, connected-component labels, centres of mass). The labeller is
a hand-written CUDA kernel (``atomai_tpu_torch/csrc/cc_label.cu``); every
other op is stock PyTorch. The package imports ``torch`` and never JAX.

Public layout follows ``atomai_tpu``: ``models``, ``predictors``,
``utils``, ``ops`` (plus ``core`` and ``nets``).
"""

from . import core
from . import utils
from . import nets
from . import ops
from . import predictors
from . import models
from .__version__ import version as __version__

__all__ = ["core", "utils", "nets", "ops", "predictors", "models",
           "__version__"]
