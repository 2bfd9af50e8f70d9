"""Statistics of local image descriptors (counterpart of
`atomai_tpu/stat/multivar.py:24-412`).

:class:`imlocal` cuts the windows around located atoms out of a stack of
network outputs (``utils.extract_subimages``, one host gather), keeps the
flattened stack on ``device`` (the card by default) once, and runs the
decompositions of ``stat/decomposition.py`` on it: GMM, PCA, ICA, NMF,
PCA of each GMM class, the scree plots' explained variances, the
``imblock_*`` variants, trajectories (``utils.chain_tracks``) and Markov
transition matrices. :func:`update_classes` relabels atoms by their local
intensity: a threshold, KMeans, a 1-D mean shift (the port's own, with
sklearn's bandwidth estimate and bin seeding; sklearn is not used), or a
GMM of the windows. Plots import matplotlib on use.
"""

import copy
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils import extract_subimages, get_intensities
from ..utils.coords import chain_tracks
from .decomposition import NMF, PCA, FastICA, GaussianMixture, KMeans


class imlocal:
    """Extraction and statistical analysis of local image descriptors.

    Example:
        >>> imstack = stat.imlocal(nn_output, coordinates,
        >>>                        window_size=32, coord_class=1)
        >>> imstack.pca_scree_plot(plot_results=False)
        >>> pca_results = imstack.imblock_pca(n_components=4)
    """

    def __init__(self, network_output: np.ndarray,
                 coord_class_dict_all: Dict[int, np.ndarray],
                 window_size: Optional[int] = None,
                 coord_class: int = 0, device: str = "cuda") -> None:
        self.network_output = network_output
        self.nb_classes = network_output.shape[-1]
        self.coord_all = coord_class_dict_all
        self.coord_class = float(coord_class)
        self.r = window_size
        self.device = resolve_device(device)
        (self.imgstack, self.imgstack_com,
         self.imgstack_frames) = self.extract_subimages_()
        self.d0, self.d1, self.d2, self.d3 = self.imgstack.shape
        self._x = None

    def extract_subimages_(self) -> Tuple[np.ndarray, ...]:
        """(windows, centres, frames) of the atoms of ``coord_class``."""
        return extract_subimages(self.network_output, self.coord_all,
                                 self.r, self.coord_class)

    def _X_vec(self) -> torch.Tensor:
        """The flattened windows (d0, d1 * d2 * d3), on the device (copied
        there once)."""
        if self._x is None:
            self._x = torch.as_tensor(
                np.ascontiguousarray(self.imgstack, np.float32).reshape(
                    self.d0, -1)).to(self.device)
        return self._x

    def _with_frames(self, *cols) -> np.ndarray:
        return np.concatenate((self.imgstack_com,) + cols +
                              (self.imgstack_frames[:, None],), axis=-1)

    # ------------------------------------------------------------- GMM
    def gmm(self, n_components: int, covariance: str = "diag",
            random_state: int = 1, plot_results: bool = False
            ) -> Tuple[np.ndarray, List[np.ndarray], np.ndarray]:
        """(mean window of each class, the windows of each class, [centre,
        class (from 1), frame] of each window) of a GMM of the windows."""
        clf = GaussianMixture(n_components=n_components,
                              covariance_type=covariance,
                              random_state=random_state, device=self.device)
        classes = clf.fit_predict(self._X_vec()) + 1
        cla = np.zeros((np.amax(classes), int(self.r), int(self.r),
                        self.nb_classes))
        cl_all = []
        for i in range(np.amax(classes)):
            cl = self.imgstack[classes == i + 1]
            cl_all.append(cl)
            if len(cl) > 0:
                cla[i] = np.mean(cl, axis=0)
        if plot_results:
            self._plot_components(cla)
        return cla, cl_all, self._with_frames(classes[:, None])

    # --------------------------------------------------- decompositions
    def _decompose(self, model, n_components: int):
        X_vec_t = model.fit_transform(self._X_vec())
        components = model.components_.reshape(
            n_components, self.d1, self.d2, self.d3)
        return components, X_vec_t, self._with_frames()

    def pca(self, n_components: int, random_state: int = 1,
            plot_results: bool = False):
        """(components as windows, the windows' scores, [centre, frame])."""
        return self._decompose(PCA(n_components, random_state,
                                   device=self.device), n_components)

    def ica(self, n_components: int, random_state: int = 1,
            plot_results: bool = False):
        """As :meth:`pca`, by FastICA."""
        return self._decompose(FastICA(n_components, random_state,
                                       device=self.device), n_components)

    def nmf(self, n_components: int, random_state: int = 1,
            plot_results: bool = False, **kwargs: int):
        """As :meth:`pca`, by NMF (``max_iterations``, default 1000)."""
        return self._decompose(
            NMF(n_components, random_state,
                max_iter=kwargs.get("max_iterations", 1000),
                device=self.device), n_components)

    def pca_gmm(self, n_components_gmm: int,
                n_components_pca: Union[int, List[int]],
                plot_results: bool = False,
                covariance_type: str = "diag", random_state: int = 1):
        """PCA of the windows of each GMM class."""
        gmm_components, gmm_imgs, com_class_frames = self.gmm(
            n_components_gmm, covariance_type, random_state, plot_results)
        if isinstance(n_components_pca, (int, np.integer)):
            n_components_pca = [n_components_pca] * n_components_gmm
        pca_components_all, X_vec_t_all = [], []
        for imgs, ncomp in zip(gmm_imgs, n_components_pca):
            if len(imgs) < ncomp:
                pca_components_all.append(np.zeros(
                    (ncomp, self.d1, self.d2, self.d3)))
                X_vec_t_all.append(np.zeros((len(imgs), ncomp)))
                continue
            p = PCA(n_components=ncomp, random_state=random_state,
                    device=self.device)
            X_vec_t_all.append(p.fit_transform(imgs.reshape(len(imgs), -1)))
            pca_components_all.append(p.components_.reshape(
                ncomp, self.d1, self.d2, self.d3))
        return (gmm_components, pca_components_all, X_vec_t_all,
                com_class_frames)

    def pca_scree_plot(self, plot_results: bool = True) -> np.ndarray:
        """The explained variance ratio of every principal component."""
        explained_var = PCA(device=self.device).fit(
            self._X_vec()).explained_variance_ratio_
        if plot_results:
            self._plot_scree(explained_var)
        return explained_var

    def pca_gmm_scree_plot(self, n_components_gmm: int,
                           covariance_type: str = "diag",
                           random_state: int = 1,
                           plot_results: bool = True) -> List[np.ndarray]:
        """:meth:`pca_scree_plot` of each GMM class."""
        _, gmm_imgs, _ = self.gmm(n_components_gmm, covariance_type,
                                  random_state, plot_results)
        return [np.array([]) if len(imgs) < 2 else
                PCA(device=self.device).fit(imgs.reshape(len(imgs), -1)
                                            ).explained_variance_ratio_
                for imgs in gmm_imgs]

    # --------------------------------------------------------- imblocks
    def imblock_pca(self, n_components: int, random_state: int = 1,
                    plot_results: bool = False, **kwargs: int):
        """:meth:`pca` with the centres only."""
        components, X_vec_t, com_frames = self.pca(n_components,
                                                   random_state)
        return components, X_vec_t, com_frames[:, :2]

    def imblock_ica(self, n_components: int, random_state: int = 1,
                    plot_results: bool = False, **kwargs: int):
        """:meth:`ica` with the centres only."""
        components, X_vec_t, com_frames = self.ica(n_components,
                                                   random_state)
        return components, X_vec_t, com_frames[:, :2]

    def imblock_nmf(self, n_components: int, random_state: int = 1,
                    plot_results: bool = False, **kwargs: int):
        """:meth:`nmf` with the centres only."""
        components, X_vec_t, com_frames = self.nmf(n_components,
                                                   random_state)
        return components, X_vec_t, com_frames[:, :2]

    # ------------------------------------------------------------ plots
    @classmethod
    def plot_decomposition_results(cls, components, X_vec_t,
                                   image_hw=None, xy_centers=None,
                                   plot_loading_maps: bool = True,
                                   **kwargs: int) -> None:
        """Each component as an image (the last channel, background,
        left out of multichannel components)."""
        from ..utils.viz import _plt
        plt = _plt()
        nc = components.shape[0]
        comp_ = components[..., :-1] if components.shape[-1] > 1 \
            else components
        fig, axes = plt.subplots(1, nc, figsize=(4 * nc, 4))
        for i, ax in enumerate(np.atleast_1d(axes)):
            ax.imshow(np.sum(comp_[i], axis=-1), cmap="seismic")
            ax.axis("off")
        plt.close(fig)

    def _plot_components(self, cla) -> None:
        from ..utils.viz import _plt
        plt = _plt()
        fig, axes = plt.subplots(1, len(cla), figsize=(4 * len(cla), 4))
        for i, ax in enumerate(np.atleast_1d(axes)):
            ax.imshow(cla[i, ..., 0], cmap="seismic")
            ax.axis("off")
        plt.close(fig)

    def _plot_scree(self, explained_var) -> None:
        from ..utils.viz import _plt
        plt = _plt()
        fig, ax = plt.subplots(1, 1, figsize=(6, 6))
        ax.plot(explained_var, "-o")
        ax.set_xlabel("Number of components")
        ax.set_ylabel("Explained variance")
        plt.close(fig)

    # ----------------------------------------------------- trajectories
    @classmethod
    def get_trajectory(cls, coord_class_dict: Dict[int, np.ndarray],
                       start_coord: np.ndarray, rmax: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """One atom's track: nearest-neighbour chaining across frames
        within ``rmax``."""
        (flow, frames), = chain_tracks(
            coord_class_dict, np.asarray(start_coord, float)[None, :], rmax)
        return flow, frames

    def get_all_trajectories(self, min_length: int = 0,
                             run_gmm: bool = False, rmax: int = 10,
                             **kwargs) -> Dict:
        """The tracks of every window of the first frame (all chained at
        once), with their GMM classes when ``run_gmm``."""
        if run_gmm:
            gmm_comps, _, classes_frames = self.gmm(
                kwargs.get("n_components", 5),
                kwargs.get("covariance", "diag"),
                kwargs.get("random_state", 1))
            classes = classes_frames[:, -2]
        else:
            classes = np.zeros(len(self.imgstack_frames))
        # one entry a frame, in order of first appearance (the windows'
        # frames repeat once a window)
        coord_class_dict = {
            i: np.concatenate(
                (self.imgstack_com[self.imgstack_frames == i],
                 classes[self.imgstack_frames == i][..., None]), axis=-1)
            for i in dict.fromkeys(self.imgstack_frames.tolist())}
        first = next(iter(coord_class_dict.values()))
        tracks = chain_tracks(coord_class_dict, first[:, :2], rmax)
        kept = [(f, fr) for f, fr in tracks if len(f) > min_length]
        return_dict = {"trajectories": [f for f, _ in kept],
                       "frames": [fr for _, fr in kept]}
        if run_gmm:
            return_dict["gmm_components"] = gmm_comps
        return return_dict

    @classmethod
    def renumerate_classes(cls, classes: np.ndarray) -> np.ndarray:
        """Classes renumbered 0, 1, ... in their sorted order."""
        uniq = np.unique(classes)
        diff_d = {cl: d for d, cl in zip(uniq - np.arange(len(uniq)), uniq)}
        return np.array([cl - diff_d[cl] for cl in classes], dtype=np.int64)

    def transition_matrix(self, n_components: int,
                          covariance: str = "diag",
                          random_state: int = 1, rmax: int = 10,
                          min_length: int = 0,
                          sum_all_transitions: bool = False) -> Dict:
        """GMM classes, tracks and each track's Markov transition matrix
        (and their normalised sum with ``sum_all_transitions``)."""
        dict_to_return = self.get_all_trajectories(
            min_length, run_gmm=True, n_components=n_components,
            rmax=rmax, covariance=covariance, random_state=random_state)
        dict_to_return["transitions"] = [
            calculate_transition_matrix(self.renumerate_classes(t[:, -1]))
            for t in dict_to_return["trajectories"]]
        if sum_all_transitions:
            dict_to_return["all_transitions"] = sum_transitions(
                dict_to_return, n_components)
        return dict_to_return


def calculate_transition_matrix(trace: Union[List, np.ndarray]
                                ) -> np.ndarray:
    """The Markov transition matrix of a state sequence, rows normalised."""
    trace = np.asarray(trace, dtype=np.int64)
    n = 1 + int(trace.max())
    M = np.zeros((n, n))
    np.add.at(M, (trace[:-1], trace[1:]), 1)
    row_sums = M.sum(axis=1, keepdims=True)
    np.divide(M, row_sums, out=M, where=row_sums > 0)
    return M


def sum_transitions(trans_dict: Dict, msize: int,
                    plot_results: bool = False, **kwargs: int
                    ) -> np.ndarray:
    """The tracks' transition matrices summed in the global class indices,
    rows normalised."""
    transmat_all = np.zeros((msize, msize))
    for traj, trans in zip(trans_dict["trajectories"],
                           trans_dict["transitions"]):
        states = np.unique(traj[:, -1]).astype(np.int64) - 1
        transmat_all[np.ix_(states, states)] += trans
    sums = transmat_all.sum(axis=1, keepdims=True)
    np.divide(transmat_all, sums, out=transmat_all, where=sums > 0)
    if plot_results:
        from ..utils.viz import plot_transitions
        plot_transitions(transmat_all,
                         gmm_components=trans_dict.get("gmm_components"),
                         **kwargs)
    return transmat_all


def estimate_bandwidth_1d(values: np.ndarray, quantile: float = 0.3
                          ) -> float:
    """sklearn's ``estimate_bandwidth`` of 1-D data (all points, no
    subsampling): the mean over points of the distance to the
    ``int(n * quantile)``-th nearest point, the point itself counted. In
    sorted order those neighbours are a window of that many points
    around the point; the distance is the least, over such windows, of
    the farther end's, found by a vectorised bisection."""
    x = np.sort(np.asarray(values, np.float64).ravel())
    n = len(x)
    k = max(int(n * quantile), 1)
    i = np.arange(n)
    lo = np.maximum(i - k + 1, 0)              # first window start
    hi = np.minimum(i, n - k)                  # last window start

    def width(j):
        return np.maximum(x[i] - x[j], x[j + k - 1] - x[i])

    # x[i] - x[j] falls and x[j + k - 1] - x[i] rises with j: bisect for
    # the first start whose right reach exceeds its left one
    a, b = lo.copy(), hi.copy()
    while np.any(a < b):
        mid = (a + b) // 2
        right = x[mid + k - 1] - x[i] >= x[i] - x[mid]
        b = np.where(right & (a < b), mid, b)
        a = np.where(~right & (a < b), mid + 1, a)
    best = width(a)
    prev = np.maximum(a - 1, lo)
    best = np.minimum(best, width(prev))
    return float(best.sum() / n)


class MeanShift1D:
    """sklearn's ``MeanShift(bandwidth, bin_seeding=True)`` for 1-D data:
    seeds at the occupied bins of width ``bandwidth`` (in order of first
    occupancy), each climbed to the mean of the points within
    ``bandwidth`` until it moves by at most 1e-3 of it (or 300 steps);
    centres ordered by their counts (then values) from the top, and any
    centre within ``bandwidth`` of a kept one dropped; a point's label is
    its nearest centre's index."""

    def __init__(self, bandwidth: float, max_iter: int = 300):
        self.bandwidth = float(bandwidth)
        self.max_iter = max_iter
        self.cluster_centers_ = None

    def _seeds(self, x: np.ndarray) -> np.ndarray:
        bins = np.round(x / self.bandwidth)
        _, first = np.unique(bins, return_index=True)
        seeds = bins[np.sort(first)].astype(np.float32)
        if len(seeds) == len(x):
            return x
        return seeds * self.bandwidth

    def fit(self, X) -> "MeanShift1D":
        x = np.asarray(X, np.float64).ravel()
        xs = np.sort(x)
        bw = self.bandwidth
        centres: Dict[float, int] = {}
        for m in self._seeds(x):
            count = 0
            for it in range(self.max_iter + 1):
                a = np.searchsorted(xs, m - bw, "left")
                b = np.searchsorted(xs, m + bw, "right")
                count = b - a
                if count == 0:
                    break
                old, m = m, xs[a:b].mean()
                if abs(m - old) <= 1e-3 * bw or it == self.max_iter:
                    break
            if count:
                centres[float(m)] = int(count)
        if not centres:
            raise ValueError(f"No point was within bandwidth={bw} of any "
                             "seed")
        ordered = np.array([c for c, _ in sorted(
            centres.items(), key=lambda t: (t[1], t[0]), reverse=True)])
        unique = np.ones(len(ordered), bool)
        for i, c in enumerate(ordered):
            if unique[i]:
                unique[np.abs(ordered - c) <= bw] = False
                unique[i] = True
        self.cluster_centers_ = ordered[unique][:, None]
        return self

    def predict(self, X) -> np.ndarray:
        x = np.asarray(X, np.float64).reshape(-1, 1)
        return np.argmin(np.abs(x - self.cluster_centers_[:, 0][None]),
                         axis=1)


def update_classes(coordinates: Union[Dict[int, np.ndarray], np.ndarray],
                   nn_input: np.ndarray, method: str = "threshold",
                   device: str = "cuda", **kwargs
                   ) -> Dict[int, np.ndarray]:
    """The coordinates with their class column set from the local
    intensity: ``method`` "threshold" (``thresh``), "kmeans"
    (``n_components``), "meanshift" (``quantile``, default 0.25) over the
    mean of a ``window_size`` window (default 3) around each atom, or
    "gmm_local" (``n_components``, ``window_size``): the GMM class of each
    atom's window. KMeans and the GMM run on ``device``."""
    if isinstance(coordinates, np.ndarray):
        coordinates = {0: coordinates}
    if np.ndim(nn_input) == 2:
        nn_input = nn_input[None, ..., None]
    elif np.ndim(nn_input) == 3:
        # (N, H, W) stack or (H, W, C) map: a small last axis is channels
        if nn_input.shape[-1] <= 10:
            nn_input = nn_input[None, ...]
        else:
            nn_input = nn_input[..., None]
    coordinates_ = copy.deepcopy(coordinates)

    if method == "gmm_local":
        n_components = kwargs.get("n_components")
        window_size = kwargs.get("window_size")
        if None in (n_components, window_size):
            raise AttributeError(
                "Specify number of components ('n_components') and "
                "window size ('window_size')")
        s = imlocal(nn_input, coordinates_, window_size,
                    kwargs.get("coord_class", 0), device=device)
        _, _, com_frames = s.gmm(n_components)
        for i in coordinates_.keys():
            coordinates_[i] = com_frames[com_frames[:, -1] == float(i)][:, :3]
            coordinates_[i][:, -1] = coordinates_[i][:, -1] - 1
        return coordinates_

    if method == "threshold":
        thresh = kwargs.get("thresh")
        if thresh is None:
            raise AttributeError(
                "Specify intensity threshold value ('thresh'), "
                "e.g. thresh=.5")

        def fit_labeler(values):
            return lambda v: (v[:, 0] >= thresh).astype(float)
    elif method == "kmeans":
        n_components = kwargs.get("n_components")
        if n_components is None:
            raise AttributeError(
                "Specify number of components ('n_components')")

        def fit_labeler(values):
            return KMeans(n_clusters=n_components, random_state=42,
                          device=device).fit(values).predict
    elif method == "meanshift":
        def fit_labeler(values):
            bandwidth = estimate_bandwidth_1d(
                values, quantile=kwargs.get("quantile", .25))
            return MeanShift1D(bandwidth).fit(values).predict
    else:
        raise NotImplementedError(
            "Choose between 'threshold', 'kmeans', 'meanshift' and "
            "'gmm_local' methods")

    intensities = get_intensities(coordinates_, nn_input,
                                  kwargs.get("window_size", 3))
    labeler = fit_labeler(np.concatenate(intensities)[:, None])
    for i, iarray in enumerate(intensities):
        coordinates_[i][:, -1] = labeler(iarray[:, None])
    return coordinates_
