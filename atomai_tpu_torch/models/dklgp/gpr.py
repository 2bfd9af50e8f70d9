"""Reconstructor: GP reconstruction of a sparsely measured image.

Counterpart of `atomai_tpu/models/dklgp/gpr.py`: the measured (nonzero)
pixels become an (index, value) training set, the GP is fitted with
lengthscale constraints from the image size, and the full pixel grid is
predicted and reshaped to the image. Exact inference up to
``MAX_EXACT_POINTS`` measured pixels, SGPR on an inducing grid ('kissgp')
above.

The GP runs in float64, where the JAX package runs it in float32. On a
smooth image the fit drives the noise to its floor (1e-4) while the
outputscale grows; with thousands of measured pixels the float32 Cholesky
factorisation then fails and the whole reconstruction is NaN (measured on
an H100: 192 x 192 and 256 x 256 images at 10% measured pixels, and
256 x 256 at 30% on the 'kissgp' path; float64 followed float32 to four
digits until then and finished). Float64 runs at the float32 rate of the
H100's non-tensor pipes, and small images give what the JAX package gives
to float32 rounding.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from ...trainers.gptrainer import GPTrainer
from ...utils.coords import get_lengthscale_constraints
from ...utils.preproc import create_batches, prepare_gp_input


class Reconstructor(GPTrainer):
    """Sparse image reconstructor. ``device``: "cuda" (default; raises
    without a card) or "cpu".

    Example:
        >>> rec = aoi.models.Reconstructor(device="cuda")
        >>> img = rec.reconstruct(sparse_img, training_cycles=200)
    """

    MAX_EXACT_POINTS = 10000
    dtype = torch.float64

    def fit(self, X, y, training_cycles: int, **kwargs) -> None:
        """Trains the GP on the measured pixels."""
        self.run(X, y, training_cycles, **kwargs)

    def predict(self, X_new, **kwargs) -> np.ndarray:
        """Predictive mean on new inputs, in batches of ``batch_size``."""
        batch_size = kwargs.get("batch_size", len(X_new))
        out = [super(Reconstructor, self).predict(x)[0].reshape(-1)
               for x in create_batches(np.asarray(X_new), batch_size)]
        return np.concatenate(out)

    def reconstruct(self, sparse_image: np.ndarray,
                    training_cycles: int = 100,
                    lengthscale_constraints: Optional[Tuple] = None,
                    grid_points_ratio: float = 1.0, **kwargs
                    ) -> np.ndarray:
        """Trains on the sparse image's nonzero pixels and returns the full
        reconstructed image."""
        X_train, y_train, X_full = prepare_gp_input(sparse_image)
        if not lengthscale_constraints:
            lengthscale_constraints = get_lengthscale_constraints(X_full)
        if "kernel_type" not in kwargs:
            kwargs["kernel_type"] = "exact" \
                if len(X_train) <= self.MAX_EXACT_POINTS else "kissgp"
            kwargs.setdefault("grid_points_ratio", grid_points_ratio)
        print("Model training ...\n")
        self.fit(np.asarray(X_train, np.float32), y_train, training_cycles,
                 lengthscale_constraints=lengthscale_constraints, **kwargs)
        print("\n\rPerforming reconstruction... ", end="")
        reconstruction = self.predict(
            np.asarray(X_full, np.float32),
            batch_size=kwargs.get("batch_size", 4096))
        print("Done")
        return reconstruction.reshape(sparse_image.shape)
