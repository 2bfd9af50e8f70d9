"""Precision policy and seeding."""

from .dtypes import Precision, default_precision, set_default_precision
from .prng import generator_from_seed

__all__ = ["Precision", "default_precision", "set_default_precision",
           "generator_from_seed"]
