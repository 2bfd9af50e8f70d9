"""Training engines: the supervised trainers, the ensemble trainers and the
VAE family's."""

from .etrainer import BaseEnsembleTrainer, EnsembleTrainer
from .trainer import BaseTrainer, ImSpecTrainer, SegTrainer
from .vitrainer import viBaseTrainer

__all__ = ["BaseTrainer", "SegTrainer", "ImSpecTrainer",
           "BaseEnsembleTrainer", "EnsembleTrainer", "viBaseTrainer"]
