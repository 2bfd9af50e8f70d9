"""Predictors of the segmentation path."""

from .predictor import BasePredictor, Locator, SegPredictor

__all__ = ["BasePredictor", "Locator", "SegPredictor"]
