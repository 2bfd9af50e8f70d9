"""Training engines."""

from .vitrainer import viBaseTrainer

__all__ = ["viBaseTrainer"]
