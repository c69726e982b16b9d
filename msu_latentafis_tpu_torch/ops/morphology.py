"""Binary morphology and the Euclidean distance transform, on the host.

Counterpart of the JAX package's ``ops/morphology.py`` (scipy.ndimage, as
the reference's skimage / scipy calls at extraction_latent.py:108-115,
:193 and get_maps.py:448-453): the masks are block-sized or computed once
per image.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def binary_dilation(mask: np.ndarray, selem: np.ndarray) -> np.ndarray:
    return ndimage.binary_dilation(mask, structure=selem)


def binary_erosion(mask: np.ndarray, selem: np.ndarray) -> np.ndarray:
    return ndimage.binary_erosion(mask, structure=selem)


def binary_opening(mask: np.ndarray, selem: np.ndarray) -> np.ndarray:
    return ndimage.binary_opening(mask, structure=selem)


def binary_closing(mask: np.ndarray, selem: np.ndarray) -> np.ndarray:
    # scipy's border_value=0, as the JAX package (the reference pads the
    # block masks' edges the same way in its use)
    return ndimage.binary_closing(mask, structure=selem)


def distance_transform_edt(mask: np.ndarray) -> np.ndarray:
    return ndimage.distance_transform_edt(mask)
