"""Multivariate statistics of local descriptors, hyperspectral unmixing
and sliding-window FFT unmixing, on the card (counterpart of
`atomai_tpu/stat/__init__.py`)."""

from .decomposition import NMF, PCA, FastICA, GaussianMixture, KMeans
from .fft_nmf import SlidingFFTNMF
from .multivar import (MeanShift1D, calculate_transition_matrix,
                       estimate_bandwidth_1d, imlocal, sum_transitions,
                       update_classes)
from .unmixer import SpectralUnmixer

__all__ = ["imlocal", "update_classes", "calculate_transition_matrix",
           "sum_transitions", "SlidingFFTNMF", "SpectralUnmixer", "PCA",
           "FastICA", "NMF", "GaussianMixture", "KMeans", "MeanShift1D",
           "estimate_bandwidth_1d"]
