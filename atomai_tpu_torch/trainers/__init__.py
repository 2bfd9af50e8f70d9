"""Training engines: the supervised trainers and the VAE family's."""

from .trainer import BaseTrainer, SegTrainer
from .vitrainer import viBaseTrainer

__all__ = ["BaseTrainer", "SegTrainer", "viBaseTrainer"]
