"""Training engines: the supervised trainers, the ensemble trainers, the
VAE family's and the GP trainers."""

from .etrainer import BaseEnsembleTrainer, EnsembleTrainer
from .gptrainer import GPTrainer, dklGPTrainer
from .trainer import BaseTrainer, ImSpecTrainer, SegTrainer
from .vitrainer import viBaseTrainer

__all__ = ["BaseTrainer", "SegTrainer", "ImSpecTrainer",
           "BaseEnsembleTrainer", "EnsembleTrainer", "viBaseTrainer",
           "GPTrainer", "dklGPTrainer"]
