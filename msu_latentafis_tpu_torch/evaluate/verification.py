"""Verification metrics: ROC, TAR@FAR, EER.

Counterpart of the JAX package's ``evaluate/verification.py`` (after the
reference implementation's evaluate/verification.py:13-228): the ROC over
genuine / impostor pair scores at every threshold, true-accept rates at
fixed false-accept rates, the equal error rate.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def roc_curve(scores: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(far, tar, thresholds) sweeping all unique score thresholds.

    ``labels`` is 1 for genuine pairs, 0 for impostors; higher score =
    more similar.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    order = np.argsort(-scores, kind="stable")
    s = scores[order]
    l = labels[order]
    tp = np.cumsum(l)
    fp = np.cumsum(~l)
    n_pos = max(int(l.sum()), 1)
    n_neg = max(int((~l).sum()), 1)
    tar = tp / n_pos
    far = fp / n_neg
    return far, tar, s


def tar_at_far(scores: np.ndarray, labels: np.ndarray,
               far_targets: Sequence[float] = (1e-3, 1e-2, 1e-1)) -> Dict[float, float]:
    far, tar, _ = roc_curve(scores, labels)
    out = {}
    for ft in far_targets:
        idx = np.searchsorted(far, ft, side="right") - 1
        out[ft] = float(tar[idx]) if idx >= 0 else 0.0
    return out


def eer(scores: np.ndarray, labels: np.ndarray) -> float:
    far, tar, _ = roc_curve(scores, labels)
    frr = 1.0 - tar
    idx = np.argmin(np.abs(far - frr))
    return float((far[idx] + frr[idx]) / 2.0)


def verification_metrics(scores: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    m = {f"tar@far={ft:g}": v for ft, v in tar_at_far(scores, labels).items()}
    m["eer"] = eer(scores, labels)
    return m
