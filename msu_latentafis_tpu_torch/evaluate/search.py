"""Identification / retrieval metrics: CMC, rank-k, mAP.

Counterpart of the JAX package's ``evaluate/search.py`` (after the
reference implementation's evaluate/search_mAP_recall.py:8-121 and
search_precision_recall.py:21-142): rank-based retrieval accuracy over
score matrices.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def cumulative_match_curve(score_matrix: np.ndarray,
                           mate_index: np.ndarray,
                           max_rank: int = 20) -> np.ndarray:
    """CMC[r] = fraction of probes whose mate appears within rank r+1.

    ``score_matrix`` is [n_probes, n_gallery]; ``mate_index`` the gallery
    column of each probe's true mate.
    """
    order = np.argsort(-score_matrix, axis=1, kind="stable")
    ranks = np.argmax(order == np.asarray(mate_index)[:, None], axis=1)
    return np.array([(ranks < r + 1).mean() for r in range(max_rank)])


def rank_k_accuracy(score_matrix: np.ndarray, mate_index: np.ndarray,
                    k: int = 1) -> float:
    return float(cumulative_match_curve(score_matrix, mate_index, k)[k - 1])


def mean_average_precision(score_matrix: np.ndarray,
                           relevance: np.ndarray) -> float:
    """mAP over probes; ``relevance`` is a boolean [n_probes, n_gallery]."""
    order = np.argsort(-score_matrix, axis=1, kind="stable")
    aps = []
    for i in range(score_matrix.shape[0]):
        rel = np.asarray(relevance[i])[order[i]]
        if rel.sum() == 0:
            continue
        hits = np.cumsum(rel)
        prec = hits / (np.arange(len(rel)) + 1)
        aps.append((prec * rel).sum() / rel.sum())
    return float(np.mean(aps)) if aps else 0.0
