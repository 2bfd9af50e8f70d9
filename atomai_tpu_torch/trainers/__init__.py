"""Training engines: the supervised trainers (segmentation, im2spec,
regression, classification), the ensemble trainers, the VAE family's and
the GP trainers."""

from .etrainer import BaseEnsembleTrainer, EnsembleTrainer
from .gptrainer import GPTrainer, dklGPTrainer
from .trainer import (BaseTrainer, ImSpecTrainer, RegTrainer, SegTrainer,
                      clsTrainer)
from .vitrainer import viBaseTrainer

__all__ = ["BaseTrainer", "SegTrainer", "ImSpecTrainer", "RegTrainer",
           "clsTrainer",
           "BaseEnsembleTrainer", "EnsembleTrainer", "viBaseTrainer",
           "GPTrainer", "dklGPTrainer"]
