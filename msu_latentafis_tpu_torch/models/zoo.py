"""Training model zoo.

Counterpart of the JAX package's ``models/zoo.py`` (after the reference
implementation's training model zoo, extraction/models/: resnet.py,
preactresnet.py, sphereface.py, inception_resnet_v1.py, hourglass.py,
bcnn.py, dropout.py, net.py): embedding backbones for the patch
descriptor nets and heatmap regressors. NCHW modules; each names its Flax
module paths (``flax_modules()``) in the order Flax creates them, so
``models.weights.load_flax`` / ``to_flax`` carry the JAX package's
variables over, and each has a ``*_from_flax(variables, **config)`` that
reads its input width from the variables.

Layouts as the JAX package computes them: convolutions pad as Flax's
"SAME" (``SameConv2d``), "SAME" max pools pad with -inf the same way, a
flatten before a Dense reads the NHWC order, the hourglass's nearest
upsample picks floor((i + 0.5) in / out) as ``jax.image.resize`` does,
and the bilinear pool keeps the signed square root with +1e-10. Dropout
is the identity in eval mode; in train mode its mask is torch's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .batchnorm import FlaxBatchNorm1d, FlaxBatchNorm2d
from .enhancement import SameConv2d, same_pads
from .weights import load_flax


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax's ``max_pool(x, (k, k), strides=(s, s), padding="SAME")``."""
    pads = same_pads(x.shape[-2:], (k, k), (s, s))
    return F.max_pool2d(F.pad(x, pads, value=-float("inf")), k, s)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` over the last two dims."""
    for d, n in ((-2, size[0]), (-1, size[1])):
        m = x.shape[d]
        if m != n:
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * m / n).long().to(x.device)
            x = x.index_select(x.dim() + d, idx)
    return x


def _prefixed(prefix: str, mods: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in mods.items()}


# ---------------------------------------------------------------------------
# ResNet / PreActResNet
# ---------------------------------------------------------------------------

class ResNetBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(cin, features, 3, stride, bias=False)
        self.bn1 = FlaxBatchNorm2d(features)
        self.conv2 = SameConv2d(features, features, 3, bias=False)
        self.bn2 = FlaxBatchNorm2d(features)
        self.proj = None
        if cin != features or stride != 1:
            self.proj = SameConv2d(cin, features, 1, stride, bias=False)
            self.proj_bn = FlaxBatchNorm2d(features)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(y + r)

    def flax_modules(self) -> dict:
        out = {"Conv_0": self.conv1, "BatchNorm_0": self.bn1,
               "Conv_1": self.conv2, "BatchNorm_1": self.bn2}
        if self.proj is not None:
            out.update({"Conv_2": self.proj, "BatchNorm_2": self.proj_bn})
        return out


def _stages(cls, width: int, stage_sizes, cin: int) -> Tuple[nn.ModuleList, int]:
    blocks = nn.ModuleList()
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            blocks.append(cls(cin, width * 2 ** i,
                              2 if j == 0 and i > 0 else 1))
            cin = width * 2 ** i
    return blocks, cin


class ResNet(nn.Module):
    """Post-activation ResNet (models/resnet.py)."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 width: int = 64, num_outputs: int = 128,
                 in_channels: int = 1):
        super().__init__()
        self.stem = SameConv2d(in_channels, width, 3, bias=False)
        self.bn = FlaxBatchNorm2d(width)
        self.blocks, c = _stages(ResNetBlock, width, stage_sizes, width)
        self.fc = nn.Linear(c, num_outputs)

    def forward(self, x):
        x = F.relu(self.bn(self.stem(x)))
        for b in self.blocks:
            x = b(x)
        return self.fc(x.mean(dim=(2, 3)))

    def flax_modules(self) -> dict:
        out = {"Conv_0": self.stem, "BatchNorm_0": self.bn,
               "Dense_0": self.fc}
        for i, b in enumerate(self.blocks):
            out.update(_prefixed(f"ResNetBlock_{i}", b.flax_modules()))
        return out


class PreActBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.bn0 = FlaxBatchNorm2d(cin)
        self.proj = SameConv2d(cin, features, 1, stride, bias=False) \
            if cin != features or stride != 1 else None
        self.conv1 = SameConv2d(cin, features, 3, stride, bias=False)
        self.bn1 = FlaxBatchNorm2d(features)
        self.conv2 = SameConv2d(features, features, 3, bias=False)

    def forward(self, x):
        y = F.relu(self.bn0(x))
        r = x if self.proj is None else self.proj(y)
        y = F.relu(self.bn1(self.conv1(y)))
        return self.conv2(y) + r

    def flax_modules(self) -> dict:
        convs = [self.conv1, self.conv2]
        if self.proj is not None:
            convs.insert(0, self.proj)
        out = {"BatchNorm_0": self.bn0, "BatchNorm_1": self.bn1}
        out.update({f"Conv_{i}": c for i, c in enumerate(convs)})
        return out


class PreActResNet(nn.Module):
    """Pre-activation ResNet (models/preactresnet.py)."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 width: int = 64, num_outputs: int = 128,
                 in_channels: int = 1):
        super().__init__()
        self.stem = SameConv2d(in_channels, width, 3, bias=False)
        self.blocks, c = _stages(PreActBlock, width, stage_sizes, width)
        self.bn = FlaxBatchNorm2d(c)
        self.fc = nn.Linear(c, num_outputs)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(F.relu(self.bn(x)).mean(dim=(2, 3)))

    def flax_modules(self) -> dict:
        out = {"Conv_0": self.stem, "BatchNorm_0": self.bn,
               "Dense_0": self.fc}
        for i, b in enumerate(self.blocks):
            out.update(_prefixed(f"PreActBlock_{i}", b.flax_modules()))
        return out


# ---------------------------------------------------------------------------
# SphereFace-style embedding net
# ---------------------------------------------------------------------------

def _same_out(n: int, stride: int) -> int:
    return -(-n // stride)


class SphereFaceNet(nn.Module):
    """Stride-2 / stride-1 conv pairs with leaky-ReLU 0.25 and an
    embedding Dense over the flattened features (models/sphereface.py);
    ``input_hw`` sizes that Dense."""

    def __init__(self, widths: Sequence[int] = (64, 128, 256, 512),
                 embedding_size: int = 512, in_channels: int = 1,
                 input_hw: Tuple[int, int] = (96, 96)):
        super().__init__()
        self.convs = nn.ModuleList()
        c, (h, w) = in_channels, input_hw
        for wd in widths:
            self.convs.append(SameConv2d(c, wd, 3, 2))
            self.convs.append(SameConv2d(wd, wd, 3))
            c, h, w = wd, _same_out(h, 2), _same_out(w, 2)
        self.fc = nn.Linear(c * h * w, embedding_size)

    def forward(self, x):
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.25)
        return self.fc(flatten_nhwc(x))

    def flax_modules(self) -> dict:
        out = {f"Conv_{i}": c for i, c in enumerate(self.convs)}
        out["Dense_0"] = self.fc
        return out


# ---------------------------------------------------------------------------
# Inception-ResNet v1 (facenet backbone of the descriptor models)
# ---------------------------------------------------------------------------

class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, kernel=(3, 3),
                 stride: int = 1):
        super().__init__()
        self.conv = SameConv2d(cin, features, kernel, stride, bias=False)
        self.bn = FlaxBatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))

    def flax_modules(self) -> dict:
        return {"Conv_0": self.conv, "BatchNorm_0": self.bn}


class _Residual(nn.Module):
    """Branches of ConvBlocks (created in Flax's order), concatenated, a
    1x1 conv back to the input width, scaled and added to the input."""

    def __init__(self, c: int, branches, scale: float, activate: bool = True):
        super().__init__()
        self.scale, self.activate = scale, activate
        self.branches = nn.ModuleList()
        mixed = 0
        for widths_kernels in branches:
            seq, cin = nn.ModuleList(), c
            for wd, k in widths_kernels:
                seq.append(ConvBlock(cin, wd, k))
                cin = wd
            self.branches.append(seq)
            mixed += cin
        self.up = SameConv2d(mixed, c, 1)

    def forward(self, x):
        outs = []
        for seq in self.branches:
            y = x
            for blk in seq:
                y = blk(y)
            outs.append(y)
        out = x + self.scale * self.up(torch.cat(outs, dim=1))
        return F.relu(out) if self.activate else out

    def flax_modules(self) -> dict:
        out, i = {"Conv_0": self.up}, 0
        for seq in self.branches:
            for blk in seq:
                out.update(_prefixed(f"ConvBlock_{i}", blk.flax_modules()))
                i += 1
        return out


class Block35(_Residual):
    def __init__(self, c: int, scale: float = 0.17):
        super().__init__(c, [[(32, 1)], [(32, 1), (32, 3)],
                             [(32, 1), (32, 3), (32, 3)]], scale)


class Block17(_Residual):
    def __init__(self, c: int, scale: float = 0.10):
        super().__init__(c, [[(128, 1)], [(128, 1), (128, (1, 7)),
                                          (128, (7, 1))]], scale)


class Block8(_Residual):
    def __init__(self, c: int, scale: float = 0.20, activate: bool = True):
        super().__init__(c, [[(192, 1)], [(192, 1), (192, (1, 3)),
                                          (192, (3, 1))]], scale, activate)


class InceptionResnetV1(nn.Module):
    """Facenet-style backbone (models/inception_resnet_v1.py): stem ->
    n35 x Block35 -> reduction A -> n17 x Block17 -> reduction B -> n8 x
    Block8 and a last one without ReLU -> pooled, dropout, Dense (no bias),
    BatchNorm."""

    def __init__(self, embedding_size: int = 128, n35: int = 5,
                 n17: int = 10, n8: int = 5, in_channels: int = 1):
        super().__init__()
        cb = []

        def block(cin, f, k, s=1):
            cb.append(ConvBlock(cin, f, k, s))
            return cb[-1]
        self.stem = nn.ModuleList([block(in_channels, 32, 3, 2),
                                   block(32, 32, 3), block(32, 64, 3)])
        self.stem2 = nn.ModuleList([block(64, 80, 1), block(80, 192, 3),
                                    block(192, 256, 3, 2)])
        self.b35 = nn.ModuleList([Block35(256) for _ in range(n35)])
        self.ra = nn.ModuleList([block(256, 384, 3, 2), block(256, 192, 1),
                                 block(192, 192, 3), block(192, 256, 3, 2)])
        self.b17 = nn.ModuleList([Block17(896) for _ in range(n17)])
        self.rb = nn.ModuleList([block(896, 256, 1), block(256, 384, 3, 2),
                                 block(896, 256, 1), block(256, 256, 3, 2),
                                 block(896, 256, 1), block(256, 256, 3),
                                 block(256, 256, 3, 2)])
        self.b8 = nn.ModuleList([Block8(1792) for _ in range(n8)]
                                + [Block8(1792, activate=False)])
        self.dropout = nn.Dropout(0.2)
        self.fc = nn.Linear(1792, embedding_size, bias=False)
        self.bn = FlaxBatchNorm1d(embedding_size)
        self._blocks = cb

    def forward(self, x):
        for b in self.stem:
            x = b(x)
        x = max_pool_same(x, 3, 2)
        for b in self.stem2:
            x = b(x)
        for b in self.b35:
            x = b(x)
        r0 = self.ra[0](x)
        r1 = self.ra[3](self.ra[2](self.ra[1](x)))
        x = torch.cat([r0, r1, max_pool_same(x, 3, 2)], dim=1)
        for b in self.b17:
            x = b(x)
        r0 = self.rb[1](self.rb[0](x))
        r1 = self.rb[3](self.rb[2](x))
        r2 = self.rb[6](self.rb[5](self.rb[4](x)))
        x = torch.cat([r0, r1, r2, max_pool_same(x, 3, 2)], dim=1)
        for b in self.b8:
            x = b(x)
        x = self.dropout(x.mean(dim=(2, 3)))
        return self.bn(self.fc(x))

    def flax_modules(self) -> dict:
        out = {"Dense_0": self.fc, "BatchNorm_0": self.bn}
        for i, b in enumerate(self._blocks):
            out.update(_prefixed(f"ConvBlock_{i}", b.flax_modules()))
        for name, blocks in (("Block35", self.b35), ("Block17", self.b17),
                             ("Block8", self.b8)):
            for i, b in enumerate(blocks):
                out.update(_prefixed(f"{name}_{i}", b.flax_modules()))
        return out


# ---------------------------------------------------------------------------
# Stacked hourglass (heatmap regressor)
# ---------------------------------------------------------------------------

class Hourglass(nn.Module):
    """One recursive hourglass (models/hourglass.py): per level a
    ResNetBlock on the input, a 2x2 max pool, a ResNetBlock, the next
    level, a ResNetBlock, the nearest upsample, the sum."""

    def __init__(self, cin: int, depth: int = 3, features: int = 64):
        super().__init__()
        self.blocks = nn.ModuleList()

        def build(c, d):
            up = len(self.blocks)
            self.blocks.append(ResNetBlock(c, features))
            self.blocks.append(ResNetBlock(c, features))
            inner = build(features, d - 1) if d > 1 else None
            self.blocks.append(ResNetBlock(features, features))
            return (up, up + 1, inner, len(self.blocks) - 1)
        self.tree = build(cin, depth)

    def _hg(self, x, node):
        up_i, low_i, inner, out_i = node
        up = self.blocks[up_i](x)
        low = self.blocks[low_i](F.max_pool2d(x, 2, 2))
        if inner is not None:
            low = self._hg(low, inner)
        low = self.blocks[out_i](low)
        return up + resize_nearest(low, up.shape[-2:])

    def forward(self, x):
        return self._hg(x, self.tree)

    def flax_modules(self) -> dict:
        out = {}
        for i, b in enumerate(self.blocks):
            out.update(_prefixed(f"ResNetBlock_{i}", b.flax_modules()))
        return out


class StackedHourglass(nn.Module):
    """A 7x7 stem, then per stack an hourglass, a ConvBlock, a 1x1 output
    conv and a ConvBlock added back; the last stack's output [B, C, H, W],
    or every stack's [n_stacks, B, C, H, W]."""

    def __init__(self, n_stacks: int = 2, features: int = 64,
                 num_outputs: int = 12, in_channels: int = 1):
        super().__init__()
        f = features
        self.stem = ConvBlock(in_channels, f, 7)
        self.hgs = nn.ModuleList([Hourglass(f, features=f)
                                  for _ in range(n_stacks)])
        self.mid = nn.ModuleList([ConvBlock(f, f, 1) for _ in range(n_stacks)])
        self.outs = nn.ModuleList([SameConv2d(f, num_outputs, 1)
                                   for _ in range(n_stacks)])
        self.back = nn.ModuleList([ConvBlock(f, f, 1)
                                   for _ in range(n_stacks)])

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for hg, mid, head, back in zip(self.hgs, self.mid, self.outs,
                                       self.back):
            y = mid(hg(x))
            outs.append(head(y))
            x = x + back(y)
        return outs[-1] if len(outs) == 1 else torch.stack(outs)

    def flax_modules(self) -> dict:
        out = _prefixed("ConvBlock_0", self.stem.flax_modules())
        for s in range(len(self.hgs)):
            out.update(_prefixed(f"Hourglass_{s}", self.hgs[s].flax_modules()))
            out.update(_prefixed(f"ConvBlock_{1 + 2 * s}",
                                 self.mid[s].flax_modules()))
            out.update(_prefixed(f"ConvBlock_{2 + 2 * s}",
                                 self.back[s].flax_modules()))
            out[f"Conv_{s}"] = self.outs[s]
        return out


# ---------------------------------------------------------------------------
# Bilinear CNN, dropout MLP, LeNet
# ---------------------------------------------------------------------------

class BCNN(nn.Module):
    """Bilinear pooling head over conv features (models/bcnn.py):
    outer-product pooling, signed square root, L2 normalization, Dense."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128),
                 num_outputs: int = 128, in_channels: int = 1):
        super().__init__()
        self.blocks = nn.ModuleList()
        c = in_channels
        for wd in widths:
            self.blocks.append(ConvBlock(c, wd, 3, 2))
            c = wd
        self.fc = nn.Linear(c * c, num_outputs)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        bsz, c, h, w = x.shape
        flat = x.reshape(bsz, c, h * w)
        bil = (flat @ flat.transpose(1, 2) / (h * w)).reshape(bsz, c * c)
        bil = torch.sign(bil) * torch.sqrt(bil.abs() + 1e-10)
        bil = bil / (torch.linalg.norm(bil, dim=1, keepdim=True) + 1e-10)
        return self.fc(bil)

    def flax_modules(self) -> dict:
        out = {"Dense_0": self.fc}
        for i, b in enumerate(self.blocks):
            out.update(_prefixed(f"ConvBlock_{i}", b.flax_modules()))
        return out


class DropoutMLP(nn.Module):
    """Fully connected head with dropout (models/dropout.py) over the
    flattened (NHWC order) input of ``in_features``."""

    def __init__(self, in_features: int, hidden: Sequence[int] = (512, 256),
                 num_outputs: int = 128, rate: float = 0.5):
        super().__init__()
        dims = [in_features] + list(hidden)
        self.hidden = nn.ModuleList([nn.Linear(a, b)
                                     for a, b in zip(dims, dims[1:])])
        self.dropout = nn.Dropout(rate)
        self.fc = nn.Linear(dims[-1], num_outputs)

    def forward(self, x):
        x = flatten_nhwc(x) if x.dim() == 4 else x.reshape(x.shape[0], -1)
        for lin in self.hidden:
            x = self.dropout(F.relu(lin(x)))
        return self.fc(x)

    def flax_modules(self) -> dict:
        out = {f"Dense_{i}": lin for i, lin in enumerate(self.hidden)}
        out[f"Dense_{len(self.hidden)}"] = self.fc
        return out


class PlainNet(nn.Module):
    """LeNet-style classifier (models/net.py): conv5x5(6) -> pool ->
    conv5x5(16) -> pool -> fc 120 / 84 / num_classes; unpadded convs;
    ``input_hw`` sizes the first Dense."""

    def __init__(self, num_classes: int = 10, in_channels: int = 1,
                 input_hw: Tuple[int, int] = (32, 32)):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 6, 5)
        self.conv2 = nn.Conv2d(6, 16, 5)
        h, w = (((n - 4) // 2 - 4) // 2 for n in input_hw)
        self.fcs = nn.ModuleList([nn.Linear(16 * h * w, 120),
                                  nn.Linear(120, 84),
                                  nn.Linear(84, num_classes)])

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = flatten_nhwc(x)
        x = F.relu(self.fcs[0](x))
        x = F.relu(self.fcs[1](x))
        return self.fcs[2](x)

    def flax_modules(self) -> dict:
        out = {"Conv_0": self.conv1, "Conv_1": self.conv2}
        out.update({f"Dense_{i}": f for i, f in enumerate(self.fcs)})
        return out


# ---------------------------------------------------------------------------
# Flax variables -> nets
# ---------------------------------------------------------------------------

def _in_channels(variables, *path) -> int:
    node = variables["params"]
    for p in path:
        node = node[p]
    return int(np.shape(node["kernel"])[-2])


def resnet_from_flax(variables, **config) -> ResNet:
    return load_flax(ResNet(in_channels=_in_channels(variables, "Conv_0"),
                            **config), variables)


def preact_resnet_from_flax(variables, **config) -> PreActResNet:
    return load_flax(PreActResNet(
        in_channels=_in_channels(variables, "Conv_0"), **config), variables)


def sphereface_from_flax(variables, **config) -> SphereFaceNet:
    return load_flax(SphereFaceNet(
        in_channels=_in_channels(variables, "Conv_0"), **config), variables)


def inception_resnet_v1_from_flax(variables, **config) -> InceptionResnetV1:
    return load_flax(InceptionResnetV1(
        in_channels=_in_channels(variables, "ConvBlock_0", "Conv_0"),
        **config), variables)


def hourglass_from_flax(variables, **config) -> Hourglass:
    return load_flax(Hourglass(
        _in_channels(variables, "ResNetBlock_0", "Conv_0"), **config),
        variables)


def stacked_hourglass_from_flax(variables, **config) -> StackedHourglass:
    return load_flax(StackedHourglass(
        in_channels=_in_channels(variables, "ConvBlock_0", "Conv_0"),
        **config), variables)


def bcnn_from_flax(variables, **config) -> BCNN:
    return load_flax(BCNN(
        in_channels=_in_channels(variables, "ConvBlock_0", "Conv_0"),
        **config), variables)


def dropout_mlp_from_flax(variables, **config) -> DropoutMLP:
    return load_flax(DropoutMLP(
        int(np.shape(variables["params"]["Dense_0"]["kernel"])[0]),
        **config), variables)


def plainnet_from_flax(variables, **config) -> PlainNet:
    return load_flax(PlainNet(in_channels=_in_channels(variables, "Conv_0"),
                              **config), variables)
