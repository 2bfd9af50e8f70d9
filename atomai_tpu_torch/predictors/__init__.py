"""Predictors: segmentation and its Locator, im2spec, regression,
classification, and ensembles."""

from .epredictor import EnsemblePredictor, ensemble_locate
from .predictor import (BasePredictor, ImSpecPredictor, Locator,
                        RegPredictor, SegPredictor, clsPredictor)

__all__ = ["BasePredictor", "EnsemblePredictor", "ImSpecPredictor",
           "Locator", "RegPredictor", "SegPredictor", "clsPredictor",
           "ensemble_locate"]
