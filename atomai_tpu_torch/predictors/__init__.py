"""Predictors: segmentation and its Locator, im2spec, and ensembles."""

from .epredictor import EnsemblePredictor, ensemble_locate
from .predictor import BasePredictor, ImSpecPredictor, Locator, SegPredictor

__all__ = ["BasePredictor", "EnsemblePredictor", "ImSpecPredictor",
           "Locator", "SegPredictor", "ensemble_locate"]
