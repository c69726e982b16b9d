"""PQ texture matching (asymmetric-distance scoring), plain PyTorch.

The reference scores every (latent virtual minutia i, rolled virtual
minutia j) as ``6 - sum_k LUT_i[k, codes[j, k]]`` with
``LUT_i[k, c] = ||x_ik - C_kc||^2`` (matcher.cpp:564-714). The exact
identity

    simi[i, j] = 2 <x_i, decode(codes_j)> + (6 - ||x_i||^2 - ||decode_j||^2)

turns it into a product with the decoded gallery. ``decode_pq`` is a plain
index gather; the row max of ``simi`` that the engine needs is the
``adc_rowmax`` kernel (``kernels/ops.py``).
"""
from __future__ import annotations

import torch


def decode_pq(codes: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Decode PQ codes [..., S] -> descriptors [..., S*d].

    ``codebook`` is [S, C, d]; sub-quantizer k of every row reads
    ``codebook[k, codes[..., k]]``.
    """
    S, _, d = codebook.shape
    sub = torch.arange(S, device=codes.device)
    dec = codebook[sub, codes.long()]                     # [..., S, d]
    return dec.reshape(codes.shape[:-1] + (S * d,))


def texture_similarity(lat_des: torch.Tensor, lat_sqnorm: torch.Tensor,
                       lat_valid: torch.Tensor, rol_dec: torch.Tensor,
                       rol_sqnorm: torch.Tensor,
                       rol_valid: torch.Tensor) -> torch.Tensor:
    """simi[..., Lt, Rt] = 2 X.dec^T + (6 - |x|^2 - |c|^2), f32.

    ``lat_des`` [Lt, D], ``rol_dec`` [..., Rt, D]. Invalid pairs are -inf
    (excluded from the row argmax and from the top-K).
    """
    dots = torch.matmul(lat_des.double(),
                        rol_dec.double().transpose(-1, -2)).float()
    simi = 2.0 * dots + (6.0 - lat_sqnorm[:, None]
                         - rol_sqnorm[..., None, :])
    pair_valid = lat_valid[:, None] & rol_valid[..., None, :]
    return torch.where(pair_valid, simi, torch.full_like(simi, -torch.inf))
