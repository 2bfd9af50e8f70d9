"""
atomai_tpu_torch — the PyTorch/CUDA port of ``atomai_tpu``.

Two workloads are ported:
- segmentation: ``Segmentor("Unet").fit`` (the SegTrainer with its losses,
  IoU, SWA, weight perturbation and on-device augmentation) ->
  ``predict`` through ``SegPredictor`` (min-max normalise, forward,
  sigmoid) and ``Locator`` (threshold, connected-component labels, centres
  of mass, optional 2D-Gaussian refinement); ``load_model`` reads the
  port's ``.aoit`` checkpoints;
- rVAE (and VAE) training and inference: ``rVAE(...).fit`` -> encode,
  decode, reconstruct, manifold2d.
Each TPU kernel of the JAX package has a hand-written CUDA counterpart in
``atomai_tpu_torch/csrc``: the labeller (``cc_label.cu``) and the rVAE's
fused spatial-decoder MLP, forward and backward (``spatial_mlp.cu``);
every other op is stock PyTorch. The package imports ``torch`` and never
JAX.

Public layout follows ``atomai_tpu``: ``models``, ``predictors``,
``trainers``, ``transforms``, ``losses_metrics``, ``utils``, ``ops`` (plus
``core`` and ``nets``).
"""

from . import core
from . import utils
from . import nets
from . import ops
from . import losses_metrics
from . import transforms
from . import trainers
from . import predictors
from . import models
from .models import load_model
from .__version__ import version as __version__

__all__ = ["core", "utils", "nets", "ops", "losses_metrics", "transforms",
           "trainers", "predictors", "models", "load_model", "__version__"]
