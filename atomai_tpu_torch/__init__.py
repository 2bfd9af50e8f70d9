"""
atomai_tpu_torch — the PyTorch/CUDA port of ``atomai_tpu``.

Ported so far:
- segmentation: ``Segmentor("Unet").fit`` (the SegTrainer with its losses,
  IoU, SWA, weight perturbation and on-device augmentation) ->
  ``predict`` through ``SegPredictor`` (min-max normalise, forward,
  sigmoid) and ``Locator`` (threshold, connected-component labels, centres
  of mass, optional 2D-Gaussian refinement); ``load_model`` reads the
  port's ``.aoit`` checkpoints;
- the VAE family (VAE, rVAE, and the joint jVAE and jrVAE with
  Gumbel-softmax latents): ``fit`` -> encode, decode, reconstruct,
  manifold2d, manifold_traversal, encode_images, encode_trajectories;
- ImSpec and the deep ensembles (training, mean and variance prediction,
  ``ensemble_locate``);
- the Gaussian-process family: ``dklGPR`` (deep kernel learning,
  ``fit`` -> ``predict``/``thompson``), ``GPTrainer`` and the sparse-image
  ``Reconstructor``, on cuSOLVER/cuBLAS linear algebra;
- checkpoints: ``load_model`` / ``load_ensemble`` / ``load_weights`` /
  ``resume_training`` read the JAX package's ``.aoi`` files as well as the
  port's ``.aoit``; ``models.load_torch_checkpoint`` reads the original
  atomai's ``.tar`` files; ``export_model`` / ``load_exported`` write and
  serve ``torch.export`` artifacts;
- ``stat``: local-descriptor statistics (``imlocal``: GMM, PCA, ICA, NMF,
  transitions), ``SpectralUnmixer`` and ``SlidingFFTNMF``, on the card.
- ``utils``: lattice-graph analysis (``graphx``: bonds, rings on a C++
  search, defect-ring clusters), atoms and blobs from masks on the
  labeller (``find_com``, ``filter_cells``, ``get_contours``,
  ``get_blob_params``), and the image, mask, weight, profiling and
  plotting helpers of the JAX package's ``utils``.
Each TPU kernel of the JAX package has a hand-written CUDA counterpart in
``atomai_tpu_torch/csrc``: the labeller (``cc_label.cu``) and the rVAE's
fused spatial-decoder MLP (rVAE, jrVAE), forward and backward
(``spatial_mlp.cu``); one more pair, with no TPU counterpart, does the
exact GP's factor, solve and gradient at N up to a few thousand
(``spd_mll.cu``); every other op is stock PyTorch. The package imports ``torch`` and never
JAX.

Every fit and predictor also runs over a device mesh (``core.mesh``): one
process a card (``parallel.launch``), the batch split over the ranks of
the data axis, ensemble members and independent GP outputs over those of
the model axis, held to the numbers of one process.

Public layout follows ``atomai_tpu``: ``models``, ``predictors``,
``trainers``, ``transforms``, ``losses_metrics``, ``utils``, ``stat``,
``ops``, ``parallel`` (plus ``core`` and ``nets``).
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
from . import stat
from . import parallel
from .models import load_model, load_ensemble
from .core.dtypes import enable_fast_matmul
from .core.export import export_model, load_exported
from .__version__ import version as __version__

__all__ = ["core", "utils", "nets", "ops", "losses_metrics", "transforms",
           "trainers", "predictors", "models", "stat", "load_model",
           "load_ensemble", "export_model", "load_exported", "__version__"]
