"""Model bundle: the networks the pipelines need, on one device.

Counterpart of the JAX package's ``pipeline/models_bundle.py``, for now its
dimensionality-reduction part only: the CompNet and ``compress``. The
minutiae, descriptor and enhancement nets and ``initialize`` (which
restores Orbax checkpoints) come with ROADMAP.md Queue 1 item 7; the port
cannot read Orbax, whose reader imports JAX (``compnet_from_flax`` takes
the Flax variables as arrays).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.compnet import CompNet, compress_descriptors


class ModelBundle:
    """The DR CompNet, in eval mode on ``device``."""

    def __init__(self, compnet: CompNet, device="cuda"):
        self.device = torch.device(device)
        self.compnet = compnet.to(self.device).eval()

    def compress(self, des: np.ndarray) -> np.ndarray:
        """[N, 192] descriptors -> [N, 96], renormalized to 1.73."""
        return compress_descriptors(self.compnet, des)
