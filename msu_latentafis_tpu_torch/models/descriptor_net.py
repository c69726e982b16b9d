"""Minutiae patch descriptor network.

Counterpart of the JAX package's ``models/descriptor_net.py``: a compact
pre-activation ResNet, 96x96 patch -> 64-d embedding (widths 32-256, a
stride-2 and a stride-1 ``ResBlock`` per width, BatchNorm + ReLU, global
average pool, Dense).

Flax names a ``ResBlock``'s convs in the order they are created: where a
1x1 shortcut exists (the width or the stride changes) it is made before
the two 3x3 convs and so takes ``Conv_0``, the 3x3 convs ``Conv_1`` and
``Conv_2``; without one the 3x3 convs are ``Conv_0`` and ``Conv_1``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch.nn.functional as F
from torch import nn

from .enhancement import SameConv2d
from .batchnorm import FlaxBatchNorm2d
from .weights import load_flax


class ResBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.bn0 = FlaxBatchNorm2d(cin)
        self.shortcut = SameConv2d(cin, features, 1, stride) \
            if cin != features or stride != 1 else None
        self.conv1 = SameConv2d(cin, features, 3, stride)
        self.bn1 = FlaxBatchNorm2d(features)
        self.conv2 = SameConv2d(features, features, 3)

    def forward(self, x):
        y = F.relu(self.bn0(x))
        residual = x if self.shortcut is None else self.shortcut(y)
        y = F.relu(self.bn1(self.conv1(y)))
        return self.conv2(y) + residual

    def flax_modules(self, prefix: str) -> dict:
        convs = [self.conv1, self.conv2]
        if self.shortcut is not None:
            convs.insert(0, self.shortcut)
        out = {f"{prefix}/BatchNorm_0": self.bn0,
               f"{prefix}/BatchNorm_1": self.bn1}
        out.update({f"{prefix}/Conv_{i}": c for i, c in enumerate(convs)})
        return out


class DescriptorNet(nn.Module):
    """96x96 patch [B, 1, 96, 96] -> 64-d embedding [B, 64]."""

    def __init__(self, embedding_size: int = 64,
                 widths: Sequence[int] = (32, 64, 128, 256)):
        super().__init__()
        self.stem = SameConv2d(1, widths[0], 3)
        self.blocks = nn.ModuleList()
        c = widths[0]
        for w in widths:
            self.blocks.append(ResBlock(c, w, stride=2))
            self.blocks.append(ResBlock(w, w))
            c = w
        self.bn = FlaxBatchNorm2d(c)
        self.fc = nn.Linear(c, embedding_size)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        x = F.relu(self.bn(x)).mean(dim=(2, 3))
        return self.fc(x)

    def flax_modules(self) -> dict:
        out = {"Conv_0": self.stem, "BatchNorm_0": self.bn,
               "Dense_0": self.fc}
        for i, b in enumerate(self.blocks):
            out.update(b.flax_modules(f"ResBlock_{i}"))
        return out


def descriptor_from_flax(variables) -> DescriptorNet:
    """A DescriptorNet in eval mode holding the JAX package's Flax variables
    (its widths and embedding size read from them)."""
    p = variables["params"]
    widths = tuple(int(np.shape(p[f"ResBlock_{2 * i}"]["BatchNorm_1"]
                                ["scale"])[0])
                   for i in range(sum(k.startswith("ResBlock_")
                                      for k in p) // 2))
    emb = int(np.shape(p["Dense_0"]["kernel"])[1])
    return load_flax(DescriptorNet(emb, widths), variables)
