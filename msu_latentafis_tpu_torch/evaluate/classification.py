"""Top-k classification accuracy (the JAX package's
``evaluate/classification.py``)."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def topk_accuracy(logits: np.ndarray, labels: np.ndarray,
                  ks: Sequence[int] = (1, 5)) -> dict:
    order = np.argsort(-np.asarray(logits), axis=1)
    labels = np.asarray(labels)
    out = {}
    for k in ks:
        hits = (order[:, :k] == labels[:, None]).any(axis=1)
        out[f"top{k}"] = float(hits.mean())
    return out
