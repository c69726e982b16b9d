"""Pairs-file verification with k-fold threshold selection (the LFW
standard protocol).

Counterpart of the JAX package's ``evaluate/pairs.py`` (after the reference
implementation's evaluate/lfw_verify_torch.py, LFWVerification): a pairs
file names (same, same) / (a, b) image pairs; features are scored by cosine
similarity or negative L2 distance; accuracy is averaged over k contiguous
folds, the threshold chosen on the train folds (best accuracy, mean over
ties) and applied to the held-out fold.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _normalize(x: np.ndarray, eps: float = 1e-11) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + eps)


def pair_scores(feats: np.ndarray, pair_indices: np.ndarray,
                metric: str = "cos_dist") -> np.ndarray:
    """Similarity score per pair (lfw_verify_torch.py:66-75)."""
    f1 = np.asarray(feats, np.float32)[pair_indices[:, 0]]
    f2 = np.asarray(feats, np.float32)[pair_indices[:, 1]]
    if metric == "cos_dist":
        return (_normalize(f1) * _normalize(f2)).sum(axis=1)
    if metric == "l2_norm":
        return -np.linalg.norm(f1 - f2, axis=1)
    raise ValueError(f"unsupported metric: {metric!r}")


def best_threshold_accuracy(score: np.ndarray, label: np.ndarray,
                            threshold: Optional[float] = None
                            ) -> Tuple[float, float]:
    """Accuracy at a threshold; when none is given, sweep the sorted positive
    scores and return (best accuracy, mean of argmax thresholds)
    (lfw_verify_torch.py:77-106)."""
    score = np.asarray(score, np.float32)
    label = np.asarray(label, bool)
    den = float(len(score))
    if threshold is None:
        thresholds = np.sort(score[label])
        if len(thresholds) == 0:
            return float((~label).mean()), 0.0
        pred = score[None, :] >= thresholds[:, None]
        acc = (pred == label[None, :]).sum(axis=1) / den
        best = float(acc.max())
        return best, float(thresholds[acc == acc.max()].mean())
    pred = score >= threshold
    return float((pred == label).sum() / den), float(threshold)


def kfold_verification(feats: np.ndarray, pair_indices: np.ndarray,
                       labels: np.ndarray, metric: str = "cos_dist",
                       nfolds: int = 10) -> Tuple[float, float]:
    """(mean, std) of per-fold accuracies over contiguous unshuffled folds
    (sklearn KFold(shuffle=False) semantics, lfw_verify_torch.py:108-131)."""
    score = pair_scores(feats, pair_indices, metric)
    labels = np.asarray(labels, bool)
    n = len(score)
    fold_sizes = np.full(nfolds, n // nfolds)
    fold_sizes[: n % nfolds] += 1
    accs = []
    start = 0
    for fs in fold_sizes:
        test = np.arange(start, start + fs)
        train = np.concatenate([np.arange(0, start), np.arange(start + fs, n)])
        _, thr = best_threshold_accuracy(score[train], labels[train])
        acc, _ = best_threshold_accuracy(score[test], labels[test], thr)
        accs.append(acc)
        start += fs
    accs = np.asarray(accs)
    return float(accs.mean()), float(accs.std(ddof=1))


def read_pairs_file(pairs_filename: str,
                    index_dict: dict) -> Tuple[np.ndarray, np.ndarray]:
    """Parse the standard pairs file: '<name> <i> <j>' = genuine,
    '<name1> <i> <name2> <j>' = impostor (lfw_verify_torch.py:27-55)."""
    indices: List[Tuple[int, int]] = []
    labels: List[bool] = []
    with open(pairs_filename) as f:
        for line in f.readlines()[1:]:
            pair = line.strip().split()
            if len(pair) == 3:
                p0 = f"{pair[0]}_{int(pair[1]):04d}"
                p1 = f"{pair[0]}_{int(pair[2]):04d}"
                issame = True
            elif len(pair) == 4:
                p0 = f"{pair[0]}_{int(pair[1]):04d}"
                p1 = f"{pair[2]}_{int(pair[3]):04d}"
                issame = False
            else:
                continue
            indices.append((index_dict[p0], index_dict[p1]))
            labels.append(issame)
    return np.asarray(indices, np.int64), np.asarray(labels, bool)


def read_index_dict(imagepaths_filename: str) -> dict:
    """Image basename (sans extension) -> feature row index
    (lfw_verify_torch.py:19-26)."""
    with open(imagepaths_filename) as f:
        paths = [line.rstrip("\n") for line in f]
    return {os.path.splitext(os.path.basename(p))[0]: i
            for i, p in enumerate(paths)}
