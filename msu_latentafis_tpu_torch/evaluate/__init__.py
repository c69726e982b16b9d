"""Offline evaluation metrics (NumPy): verification, search, pairs,
classification."""
from .verification import roc_curve, tar_at_far, eer, verification_metrics
from .search import cumulative_match_curve, rank_k_accuracy, mean_average_precision
from .pairs import (kfold_verification, pair_scores, best_threshold_accuracy,
                    read_pairs_file, read_index_dict)

__all__ = ["roc_curve", "tar_at_far", "eer", "verification_metrics",
           "cumulative_match_curve", "rank_k_accuracy",
           "mean_average_precision", "kfold_verification", "pair_scores",
           "best_threshold_accuracy", "read_pairs_file", "read_index_dict"]
