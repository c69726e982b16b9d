"""Training losses.

Counterpart of the JAX package's ``training/losses.py`` (after the
reference implementation's loss zoo): L2 reconstruction with
``tf.nn.l2_loss``'s 0.5 * sum (minutiae_AEC.py:267, enhancement_AEC.py:305);
batch-hard and batch-all triplet losses (losses/triplet*.py); the angular
(SphereFace) margin softmax (losses/angleloss.py); classification and
regression heads; the descriptor-compression distance losses
(losses/l2norm.py) and the heteroscedastic regression
(losses/uncertainty.py). The constants inside square roots and
denominators are the JAX package's; masks stay static (no boolean
indexing), so every loss keeps its shape and its gradient."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def l2_reconstruction(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.5 * sum((pred - target)^2)."""
    d = pred - target
    return 0.5 * torch.sum(d * d)


def _pairwise_sq_dists(emb: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(emb * emb, dim=1)
    d2 = sq[:, None] - 2.0 * emb @ emb.T + sq[None, :]
    return torch.clamp(d2, min=0.0)


def _masks(labels: torch.Tensor):
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(len(labels), dtype=torch.bool, device=labels.device)
    return same, same & ~eye


def batch_hard_triplet(emb: torch.Tensor, labels: torch.Tensor,
                       margin: float = 0.3) -> torch.Tensor:
    """Hardest-positive / hardest-negative triplet loss over a batch, the
    mean over anchors that have both."""
    d = torch.sqrt(_pairwise_sq_dists(emb) + 1e-12)
    same, pos_mask = _masks(labels)
    inf = torch.tensor(math.inf, dtype=d.dtype, device=d.device)
    hardest_pos = torch.amax(torch.where(pos_mask, d, -inf), dim=1)
    hardest_neg = torch.amin(torch.where(~same, d, inf), dim=1)
    valid = torch.isfinite(hardest_pos) & torch.isfinite(hardest_neg)
    loss = torch.clamp(hardest_pos - hardest_neg + margin, min=0.0)
    return torch.sum(torch.where(valid, loss, 0.0)) / (valid.sum() + 1e-6)


def batch_all_triplet(emb: torch.Tensor, labels: torch.Tensor,
                      margin: float = 0.3) -> torch.Tensor:
    """Mean over all valid (anchor, positive, negative) triplets with a
    positive loss."""
    d = torch.sqrt(_pairwise_sq_dists(emb) + 1e-12)
    same, pos = _masks(labels)
    tri = d[:, :, None] - d[:, None, :] + margin          # [a, p, n]
    valid = pos[:, :, None] & (~same)[:, None, :]
    loss = torch.where(valid, torch.clamp(tri, min=0.0), 0.0)
    n_pos = ((loss > 1e-16) & valid).sum()
    return torch.sum(loss) / (n_pos + 1e-6)


def angular_margin_softmax(emb: torch.Tensor, weights: torch.Tensor,
                           labels: torch.Tensor, m: int = 4) -> torch.Tensor:
    """SphereFace A-Softmax: cos(m theta) by the Chebyshev expansion with
    the (-1)^k - 2k monotone extension on the target logit; no
    annealing."""
    w = weights / (torch.linalg.norm(weights, dim=0, keepdim=True) + 1e-8)
    x_norm = torch.linalg.norm(emb, dim=1, keepdim=True)
    cos = torch.clamp((emb @ w) / (x_norm + 1e-8), -1.0, 1.0)
    theta = torch.arccos(cos)
    k = torch.floor(theta * m / math.pi)
    sign = 1.0 - 2.0 * torch.remainder(k, 2.0)            # (-1)^k
    cos_m = torch.cos(m * theta) * sign - 2.0 * k
    logits = cos * x_norm
    target_logits = cos_m * x_norm
    onehot = F.one_hot(labels.long(), weights.shape[1]).to(emb.dtype)
    final = logits * (1 - onehot) + target_logits * onehot
    return F.cross_entropy(final, labels.long())


def classification_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


def regression_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE regression head (losses/regression.py)."""
    return torch.mean((pred - target) ** 2)


def l2norm_pair_loss(x1: torch.Tensor, x2: torch.Tensor, y1: torch.Tensor,
                     y2: torch.Tensor) -> torch.Tensor:
    """The norm of the per-pair gap between input-space and output-space L2
    distances, over the batch (L2NormLoss: the DR criterion pairing 192-d
    inputs with 96-d outputs)."""
    dist_in = torch.linalg.norm(x1 - x2, dim=1)
    dist_out = torch.linalg.norm(y1 - y2, dim=1)
    return torch.linalg.norm(dist_in - dist_out) / x1.shape[0]


def batch_hard_pair_l2norm(x1: torch.Tensor, x2: torch.Tensor,
                           y1: torch.Tensor, y2: torch.Tensor,
                           metric: str = "cosine",
                           threshold: float = 0.0) -> torch.Tensor:
    """BatchHardPairL2NormLoss: only pairs whose |in-distance -
    out-distance| exceeds ``threshold`` count, by a static mask."""
    if metric == "cosine":
        def cos(a, b):
            na = torch.linalg.norm(a, dim=1) + 1e-8
            nb = torch.linalg.norm(b, dim=1) + 1e-8
            return torch.sum(a * b, dim=1) / (na * nb)
        dist_in, dist_out = cos(x1, x2), cos(y1, y2)
    elif metric == "euclidean":
        dist_in = torch.linalg.norm(x1 - x2, dim=1)
        dist_out = torch.linalg.norm(y1 - y2, dim=1)
    else:
        raise ValueError(f"unsupported metric {metric!r}")
    diff = dist_in - dist_out
    hard = (diff.abs() - threshold) > 0.0
    n = hard.sum()
    norm = torch.sqrt(torch.sum(torch.where(hard, diff, 0.0) ** 2))
    return torch.where(n > 0, norm / torch.clamp(n, min=1), 0.0)


def uncertainty_loss(mu: torch.Tensor, log_var: torch.Tensor,
                     target: torch.Tensor, wsigma: float = 0.0) -> torch.Tensor:
    """Squared error scaled by exp(-log sigma^2), plus log sigma^2, plus
    wsigma * ||sigma^2||."""
    sq = (target - mu) ** 2
    loss = torch.mean(sq * torch.exp(-log_var)) + torch.mean(log_var)
    return loss + wsigma * torch.linalg.norm(torch.exp(log_var))
