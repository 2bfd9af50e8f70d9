"""Experimental dataset downloads (Zenodo).

The port's own copy of `atomai_tpu/utils/datasets.py`: ``stem_smbfo`` and
``stem_graphene`` fetch their ``.npy`` file with the standard library's
``urllib`` when ``download=True``, then load ``<filedir>/<name>.npy``;
``download=False`` loads a file already there and touches no network.
"""

import os
import sys
import urllib.request
from typing import Dict, Union

import numpy as np


class ProgressBar:
    """urlretrieve reporthook printing a simple progress line
    (reference `datasets.py:89-102`, without the ``progressbar`` dep)."""

    def __call__(self, block_num, block_size, total_size):
        downloaded = block_num * block_size
        if total_size > 0:
            pct = min(100.0, downloaded * 100.0 / total_size)
            sys.stdout.write(f"\rDownloading... {pct:5.1f}%")
            if downloaded >= total_size:
                sys.stdout.write("\n")
            sys.stdout.flush()


def stem_smbfo(download: bool = True, filedir: str = "./"
               ) -> Dict[str, Dict[str, np.ndarray]]:
    """STEM datasets from the Sm-doped BiFeO3 combinatorial library
    (npj Comput Mater 6, 127 (2020)) — reference `datasets.py:10-51`."""
    print("If you use this dataset in your work, please consider citing "
          "it using the following DOI: "
          "https://doi.org/10.13139/ORNLNCCS/1773704.")
    fpath = os.path.join(filedir, "SmBFO_composition_series.npy")
    if download:
        print("Downloading the dataset. This may take a few minutes.")
        url = ("https://zenodo.org/record/4876786/files/"
               "composition_series_dict_full.npy")
        urllib.request.urlretrieve(url, fpath, ProgressBar())
    return np.load(fpath, allow_pickle=True)[()]


def stem_graphene(download: bool = True, filedir: str = "./"
                  ) -> Dict[int, Dict[str, Union[np.ndarray, Dict]]]:
    """STEM movies of graphene samples
    (https://doi.ccs.ornl.gov/ui/doi/338) — reference
    `datasets.py:54-86`."""
    print("If you use this dataset in your work, please consider citing "
          "it using the following DOI: "
          "https://doi.org/10.13139/ORNLNCCS/1773705.")
    fpath = os.path.join(filedir, "graphene_imgstacks_dict.npy")
    if download:
        print("Downloading the dataset. This may take a few minutes.")
        url = ("https://zenodo.org/record/4885132/files/"
               "graphene_imgstacks_dict.npy")
        urllib.request.urlretrieve(url, fpath, ProgressBar())
    return np.load(fpath, allow_pickle=True)[()]
