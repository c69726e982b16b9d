"""BatchNorm with ``flax.linen.BatchNorm``'s train-mode semantics.

PyTorch's ``nn.BatchNorm*d`` in train mode differs from Flax's in three
ways, all of which change the running statistics a training step leaves:
- Flax's ``momentum`` 0.99 keeps 0.99 of the old statistic (PyTorch's
  ``momentum`` is the weight of the new one: 0.01 here);
- Flax updates the running variance with the BIASED batch variance
  (PyTorch with the unbiased one);
- Flax computes that variance as E[x^2] - E[x]^2, clipped at 0
  (``use_fast_variance=True``), and normalizes with it.
``FlaxBatchNorm1d`` / ``FlaxBatchNorm2d`` train as Flax does. In eval mode
they run ``nn.BatchNorm*d.forward`` unchanged (the running statistics), so
inference is the same bits as before; ``models.weights`` maps them as any
``_BatchNorm``.

``stats_group``: a process group over which the batch statistics are
averaged (each rank's shard the same size), differentiably, so a
data-parallel step normalizes with the global batch's statistics as the
JAX package's GSPMD step does (``training.trainer``). None: this rank's
batch alone.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from .weights import BN_EPS

FLAX_MOMENTUM = 0.99


class _AllReduceMean(torch.autograd.Function):
    """Mean over ``group``'s ranks; the gradient of the mean is the mean of
    every rank's gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


class _FlaxBatchNorm:
    stats_group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        axes = [0] + list(range(2, x.dim()))
        mean = x.mean(axes)
        mean2 = (x * x).mean(axes)
        if self.stats_group is not None:
            mean, mean2 = _AllReduceMean.apply(torch.stack([mean, mean2]),
                                               self.stats_group)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            m = FLAX_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        shape = [1, -1] + [1] * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + \
            self.bias.view(shape)


class FlaxBatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=1 - FLAX_MOMENTUM)


class FlaxBatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=1 - FLAX_MOMENTUM)


def set_stats_group(model: nn.Module, group) -> None:
    """Every Flax BatchNorm of ``model`` averages its batch statistics
    over ``group`` (None: its own batch)."""
    for m in model.modules():
        if isinstance(m, _FlaxBatchNorm):
            m.stats_group = group
