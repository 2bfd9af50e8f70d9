"""Sliding-window FFT + NMF unmixing (counterpart of
`atomai_tpu/stat/fft_nmf.py:24-176`).

The image is min-max normalised on the host (float64, as the JAX package
does), cut into strided windows on ``device`` (``Tensor.unfold``, the
card by default), and every window goes through one batched
``torch.fft.fft2`` + ``fftshift``, then ``log1p |.|``, the centre crop and
the linear zoom, then NMF. The zoom is ``F.interpolate(..., "bilinear",
align_corners=False)``: for the integer upscales used here its weights are
those of ``jax.image.resize(method="linear")`` (half-pixel centres; at the
borders JAX renormalises the triangle weights over the pixels inside,
torch clamps the source index, and both give the edge pixel's value).
"""

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .decomposition import NMF


class SlidingFFTNMF:
    """Sliding-window FFT transform unmixed with NMF.

    Example:
        >>> analyzer = stat.SlidingFFTNMF(components=4)
        >>> components, abundances = analyzer.analyze_image(image)
    """

    def __init__(self, window_size_x: Optional[int] = None,
                 window_size_y: Optional[int] = None,
                 window_step_x: Optional[int] = None,
                 window_step_y: Optional[int] = None,
                 interpolation_factor: int = 2, zoom_factor: int = 2,
                 hamming_filter: bool = True, components: int = 4,
                 device: str = "cuda"):
        self._user_window_size_x = window_size_x
        self._user_window_size_y = window_size_y
        self._user_window_step_x = window_step_x
        self._user_window_step_y = window_step_y
        self.interpol_factor = interpolation_factor
        self.zoom_factor = zoom_factor
        self.hamming_filter = hamming_filter
        self.components = components
        self.device = resolve_device(device)
        self.hamming_window = None

    def _calculate_window_params(self, image_shape) -> None:
        """Window sizes (a power of two in [32, 128] near an eighth of the
        side) and steps (a quarter window) unless given; the 2-D Hamming
        window."""
        height, width = image_shape[:2]
        if self._user_window_size_x is None:
            self.window_size_x = 2 ** int(np.log2(
                max(32, min(128, height // 8))))
        else:
            self.window_size_x = self._user_window_size_x
        if self._user_window_size_y is None:
            self.window_size_y = 2 ** int(np.log2(
                max(32, min(128, width // 8))))
        else:
            self.window_size_y = self._user_window_size_y
        self.window_step_x = self._user_window_step_x or \
            max(1, self.window_size_x // 4)
        self.window_step_y = self._user_window_step_y or \
            max(1, self.window_size_y // 4)
        if self.window_size_x > height:
            self.window_size_x = min(64, height)
            self.window_step_x = max(1, self.window_size_x // 4)
        if self.window_size_y > width:
            self.window_size_y = min(64, width)
            self.window_step_y = max(1, self.window_size_y // 4)
        self.hamming_window = np.sqrt(np.outer(
            np.hamming(self.window_size_x), np.hamming(self.window_size_y)))

    def _windows(self, image: np.ndarray) -> torch.Tensor:
        """(n, wx, wy) float32 windows on the device."""
        image = np.asarray(image)
        if image.ndim > 2:
            image = np.mean(image[..., :3], axis=2)
        self._calculate_window_params(image.shape)
        image = image.astype(float)
        if np.max(image) > 0:
            image = (image - np.min(image)) / (np.max(image) -
                                               np.min(image))
        wx, wy = self.window_size_x, self.window_size_y
        if image.shape[0] < wx or image.shape[1] < wy:
            raise ValueError(
                f"Image dimensions {image.shape} are smaller than window "
                f"size ({wx}, {wy})")
        sx, sy = self.window_step_x, self.window_step_y
        img = torch.as_tensor(image.astype(np.float32)).to(self.device)
        windows = img.unfold(0, wx, sx).unfold(1, wy, sy)  # (nx, ny, wx, wy)
        nx, ny = windows.shape[:2]
        self.windows_shape = (nx, ny)
        xx, yy = np.meshgrid(np.arange(0, ny * sy, sy),
                             np.arange(0, nx * sx, sx))
        self.pos_vec = np.column_stack((yy.flatten(), xx.flatten()))
        return windows.reshape(-1, wx, wy)

    def make_windows(self, image: np.ndarray) -> np.ndarray:
        """The strided windows (n, wx, wy) of the normalised image, as
        numpy (float32)."""
        return self._windows(image).cpu().numpy()

    def _process_fft(self, windows: torch.Tensor) -> torch.Tensor:
        w = windows.to(self.device, torch.float32)
        if self.hamming_filter:
            w = w * torch.as_tensor(self.hamming_window, dtype=torch.float32,
                                    device=self.device)[None]
        fft = torch.fft.fftshift(torch.fft.fft2(w), dim=(-2, -1))
        mag = torch.log1p(fft.abs())
        cx, cy = self.window_size_x // 2, self.window_size_y // 2
        zoom = max(1, self.window_size_x // (2 * self.zoom_factor))
        x0, x1 = max(0, cx - zoom), min(mag.shape[1], cx + zoom)
        y0, y1 = max(0, cy - zoom), min(mag.shape[2], cy + zoom)
        zoomed = mag[:, x0:x1, y0:y1]
        if self.interpol_factor > 1:
            zoomed = F.interpolate(zoomed[:, None],
                                   scale_factor=self.interpol_factor,
                                   mode="bilinear", align_corners=False)[:, 0]
        self.fft_size = tuple(zoomed.shape[1:])
        return torch.nan_to_num(zoomed)

    def process_fft(self, windows) -> np.ndarray:
        """The windows' zoomed log-magnitude spectra (n, zx, zy) as numpy:
        one batched FFT on the device."""
        w = torch.as_tensor(np.asarray(windows, np.float32)) \
            if not isinstance(windows, torch.Tensor) else windows
        return self._process_fft(w).cpu().numpy()

    def run_nmf(self, fft_results) -> Tuple[np.ndarray, np.ndarray]:
        """(components (k, zx, zy), abundances (nx, ny, k)) of NMF of the
        flattened spectra (numpy or a device tensor)."""
        fft_flat = torch.as_tensor(fft_results).reshape(
            len(fft_results), -1).clamp_min(0)
        if not bool(fft_flat.any()) or not bool(fft_flat.isfinite().all()):
            raise ValueError(
                "Invalid data for NMF: contains zeros, NaNs or Infs")
        if fft_flat.shape[0] < self.components:
            self.components = min(fft_flat.shape[0], 3)
        nmf = NMF(n_components=self.components, random_state=42,
                  max_iter=1000, device=self.device)
        abundances = nmf.fit_transform(
            fft_flat if fft_flat.device == self.device
            else fft_flat.numpy())
        components = nmf.components_.reshape(
            self.components, self.fft_size[0], self.fft_size[1])
        abundances = abundances.reshape(
            self.windows_shape[0], self.windows_shape[1], self.components)
        return components, abundances

    def analyze_image(self, image_input: Union[str, np.ndarray],
                      output_path: Optional[str] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """The whole pipeline on a file path or an array: (components,
        abundances (k, nx, ny)), also saved as ``<output_path>_*.npy``
        (``array_analysis`` in the working directory for an array, as in
        the JAX package; an empty ``output_path`` saves nothing)."""
        if isinstance(image_input, str):
            from ..utils.img import load_image
            image = load_image(image_input)
            if output_path is None:
                base = os.path.splitext(os.path.basename(image_input))[0]
                output_path = os.path.join(os.path.dirname(image_input),
                                           f"{base}_analysis")
        elif isinstance(image_input, np.ndarray):
            image = image_input.copy()
            if output_path is None:
                output_path = "array_analysis"
        else:
            raise TypeError("image_input must be either a file path "
                            "(string) or numpy array")
        fft_results = self._process_fft(self._windows(image))
        components, abundances = self.run_nmf(fft_results)
        abundances = abundances.transpose(-1, 0, 1)
        if output_path:
            np.save(f"{output_path}_components.npy", components)
            np.save(f"{output_path}_abundances.npy", abundances)
        return components, abundances
