"""Hyperspectral unmixing (counterpart of `atomai_tpu/stat/unmixer.py:17-123`):
an (h, w, e) cube into component spectra and abundance maps by NMF, PCA,
ICA, or a GMM of the PCA-projected spectra, with an optional L1
normalisation of each spectrum; the decompositions run on ``device`` (the
card by default)."""

import warnings
from typing import Tuple

import numpy as np

from ..core.device import resolve_device
from .decomposition import NMF, PCA, FastICA, GaussianMixture


class SpectralUnmixer:
    """Decomposition of hyperspectral cubes into component spectra and
    abundance maps.

    Example:
        >>> unmixer = stat.SpectralUnmixer(method="nmf", n_components=4)
        >>> components, abundance_maps = unmixer.fit(hspy_cube)
    """

    def __init__(self, method: str = "nmf", n_components: int = 4,
                 normalize: bool = False, device: str = "cuda", **kwargs):
        self.method = method
        self.n_components = n_components
        self.normalize = normalize
        self.device = resolve_device(device)
        self.kwargs = kwargs
        dev = dict(device=self.device)
        if method == "nmf":
            self.model = NMF(n_components=n_components,
                             max_iter=kwargs.get("max_iter", 1000), **dev)
        elif method == "pca":
            self.model = PCA(n_components=n_components, **dev)
        elif method == "ica":
            self.model = FastICA(n_components=n_components,
                                 max_iter=kwargs.get("max_iter", 200), **dev)
        elif method == "gmm":
            self.model = GaussianMixture(
                n_components=n_components,
                covariance_type=kwargs.get("covariance_type", "full"),
                random_state=kwargs.get("random_state", 1), **dev)
        else:
            raise ValueError("Method not recognized. Choose from 'nmf', "
                             "'pca', 'ica', 'gmm'.")
        self.components_ = None
        self.abundance_maps_ = None
        self.image_shape_ = None

    def fit(self, hspy_data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(components (n_components, e), abundance maps (h, w,
        n_components)) of an (h, w, e) cube."""
        if hspy_data.ndim != 3:
            raise ValueError(
                "Input data must be a 3D hyperspectral cube (h, w, e).")
        self.image_shape_ = hspy_data.shape[:2]
        h, w, e = hspy_data.shape
        spectra_matrix = hspy_data.reshape((h * w, e))
        spectra_to_fit = spectra_matrix.copy()
        l1_norms = None
        if self.normalize:
            l1_norms = np.sum(spectra_matrix, axis=1, keepdims=True)
            l1_norms[l1_norms == 0] = 1
            spectra_to_fit = spectra_matrix / l1_norms
        if self.method == "nmf":
            min_val = np.min(spectra_to_fit)
            if min_val < 0:
                warnings.warn("NMF requires non-negative data. Shifting "
                              f"data by {-min_val:.2f}.")
                spectra_to_fit = spectra_to_fit - min_val
        if self.method == "gmm":
            pca_param = self.kwargs.get("pca_dims", 0.99)
            if isinstance(pca_param, int):
                n_pca = pca_param
            elif isinstance(pca_param, float) and 0 < pca_param < 1:
                ratio = PCA(device=self.device).fit(
                    spectra_to_fit).explained_variance_ratio_
                n_pca = int(np.searchsorted(np.cumsum(ratio), pca_param)) + 1
            else:
                raise ValueError("'pca_dims' must be an int or a float "
                                 "between 0 and 1.")
            projected = PCA(n_components=n_pca, device=self.device
                            ).fit_transform(spectra_to_fit)
            labels = self.model.fit_predict(projected)
            # the responsibilities as abundances
            abundances_unscaled = self.model.predict_proba(projected)
            self.components_ = np.array([
                spectra_matrix[labels == i].mean(axis=0)
                if (labels == i).any() else np.zeros(e)
                for i in range(self.n_components)])
        else:
            abundances_unscaled = self.model.fit_transform(spectra_to_fit)
            self.components_ = self.model.components_
        abundances = abundances_unscaled * l1_norms if self.normalize \
            else abundances_unscaled
        self.abundance_maps_ = abundances.reshape((h, w, self.n_components))
        return self.components_, self.abundance_maps_

    def plot_results(self, x_axis_vals=None, x_axis_units=None,
                     **kwargs) -> None:
        """Each component's spectrum above its abundance map
        (``utils.viz.visualize_unmixing_results``; ``savefig``: a file to
        write); before ``fit``, prints a reminder instead."""
        if self.components_ is None:
            print("You must run .fit() first.")
            return
        from ..utils.viz import visualize_unmixing_results
        visualize_unmixing_results(self.components_, self.abundance_maps_,
                                   savefig=kwargs.get("savefig"))
