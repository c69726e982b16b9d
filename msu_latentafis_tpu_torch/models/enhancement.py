"""Enhancement autoencoder, and the layers every net of the port shares.

Counterpart of the JAX package's ``models/enhancement.py`` (after the
reference implementation's ``reconstruction2``, enhancement_AEC.py:198-223):
a conv encoder (nf 16, 4x4 stride-2 x5 + 1x1 bottleneck, tanh feature) and
a deconv decoder (x5 + 3x3 conv, tanh output). Input is a [-1, 1]
normalized grey image; output the enhanced image in [-1, 1].

NCHW modules in eval mode. ``SameConv2d`` pads as Flax's ``"SAME"`` does,
explicitly: where XLA's total padding is odd the extra row or column goes
at the end (a 3x3 stride-2 conv on an even size pads (0, 1)), which
PyTorch's symmetric ``padding=`` cannot express. Flax's 4x4 stride-2
``ConvTranspose`` (``"SAME"``) is ``ConvTranspose2d(k=4, s=2, padding=1)``
with the kernel flipped (``models.weights``). The nets run in f32 on a
CUDA device (``utils.precision.f32_compute``: TF32 off while they run).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import f32_compute
from .batchnorm import FlaxBatchNorm2d
from .weights import load_flax


def same_pads(size, kernel, stride) -> list:
    """F.pad's list for Flax "SAME" over the trailing dims ``size``: per
    axis a total of max((ceil(n / s) - 1) s + k - n, 0), the smaller half
    first."""
    pads = []
    for n, k, s in reversed(list(zip(size, kernel, stride))):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with Flax's "SAME" padding, padded explicitly."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 bias: bool = True):
        super().__init__(cin, cout, kernel, stride=stride, bias=bias)

    def forward(self, x):
        pads = same_pads(x.shape[-2:], self.kernel_size, self.stride)
        return super().forward(F.pad(x, pads) if any(pads) else x)


def deconv(cin: int, cout: int) -> nn.ConvTranspose2d:
    """Flax's ConvTranspose(cout, (4, 4), strides=(2, 2)), "SAME": H -> 2H."""
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


class ConvBNRelu(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 4,
                 stride: int = 2):
        super().__init__()
        self.conv = SameConv2d(cin, features, kernel, stride)
        self.bn = FlaxBatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))

    def flax_modules(self, prefix: str) -> dict:
        return {f"{prefix}/Conv_0": self.conv,
                f"{prefix}/BatchNorm_0": self.bn}


class DeconvBNRelu(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.deconv = deconv(cin, features)
        self.bn = FlaxBatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.bn(self.deconv(x)))

    def flax_modules(self, prefix: str) -> dict:
        return {f"{prefix}/ConvTranspose_0": self.deconv,
                f"{prefix}/BatchNorm_0": self.bn}


def chain(cin: int, cls, widths) -> Tuple[nn.ModuleList, int]:
    """Blocks ``cls(c_in, w)`` for w in widths, each fed the last; ->
    (blocks, last width)."""
    blocks = nn.ModuleList()
    for w in widths:
        blocks.append(cls(cin, w))
        cin = w
    return blocks, cin


def block_modules(blocks, name: str) -> dict:
    """Flax paths of ``name_0``, ``name_1``, ... blocks."""
    out = {}
    for i, b in enumerate(blocks):
        out.update(b.flax_modules(f"{name}_{i}"))
    return out


class EnhancementAEC(nn.Module):
    """Conv-deconv enhancement autoencoder; 1 channel in and out."""

    def __init__(self, nf: int = 16):
        super().__init__()
        self.enc, c = chain(1, ConvBNRelu, [nf * m for m in (1, 2, 4, 8, 8)])
        self.bottleneck = SameConv2d(c, nf, 1)
        self.dec, c = chain(nf, DeconvBNRelu,
                            [nf * m for m in (8, 4, 2, 1, 1)])
        self.out = SameConv2d(c, 1, 3)

    def forward(self, x):
        for b in self.enc:
            x = b(x)
        x = torch.tanh(self.bottleneck(x))
        for b in self.dec:
            x = b(x)
        return torch.tanh(self.out(x))

    def flax_modules(self) -> dict:
        return {**block_modules(self.enc, "ConvBNRelu"),
                "Conv_0": self.bottleneck,
                **block_modules(self.dec, "DeconvBNRelu"),
                "Conv_1": self.out}


def enhancement_from_flax(variables) -> EnhancementAEC:
    """An EnhancementAEC in eval mode holding the JAX package's Flax
    variables (its width read from them)."""
    nf = np.shape(variables["params"]["Conv_0"]["kernel"])[-1]
    return load_flax(EnhancementAEC(nf), variables)


def pad_to_multiple(img: torch.Tensor, multiple: int = 32):
    """Zero-pad the last two dims up to multiples of ``multiple`` ->
    (padded, h, w)."""
    h, w = img.shape[-2:]
    H = -(-h // multiple) * multiple
    W = -(-w // multiple) * multiple
    return F.pad(img, [0, W - w, 0, H - h]), h, w


def gaussian_blend_weights(h: int, w: int, sigma=None) -> np.ndarray:
    """Center-weighted blending window (enhancement_AEC.get_weights,
    :405-413: sigma defaults to (max(h, w) / 3)^2)."""
    Y, X = np.mgrid[0:h, 0:w]
    x0, y0 = w // 2, h // 2
    if sigma is None:
        sigma = (max(h, w) / 3.0) ** 2
    return np.exp(-((X - x0) ** 2 + (Y - y0) ** 2) / sigma)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def enhance_tiled(model: nn.Module, img, patch: int = 128) -> np.ndarray:
    """Tiled inference with Gaussian-window overlap-add blending
    (ImportGraph.run, enhancement_AEC.py:39-66): 128x128 tiles at stride
    64 through the net in one batch, min-max rescaled to [0, 255] (f64,
    host)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    stride = patch // 2
    ys = list(range(0, max(h - patch, 0) + 1, stride))
    xs = list(range(0, max(w - patch, 0) + 1, stride))
    tiles = np.stack([img[y:y + patch, x:x + patch]
                      for y in ys for x in xs])[:, None]
    with torch.inference_mode(), f32_compute():
        out = model(torch.as_tensor(tiles, device=_device(model)))
    out = out[:, 0].cpu().numpy()
    weight = gaussian_blend_weights(patch, patch)
    canvas = np.zeros((h, w), np.float64)
    i = 0
    for y in ys:
        for x in xs:
            canvas[y:y + patch, x:x + patch] += out[i] * weight
            i += 1
    lo, hi = canvas.min(), canvas.max()
    return (canvas - lo) / (hi - lo + 1e-9) * 255.0


def enhance_whole_image(model: nn.Module, img) -> torch.Tensor:
    """Whole-image inference (ImportGraph.run_whole_image,
    enhancement_AEC.py:89-104): x / 128 - 1 in, min-max rescale to
    [0, 255] out, as an [h, w] tensor on the model's device."""
    x = torch.as_tensor(img, dtype=torch.float32, device=_device(model))
    x, h, w = pad_to_multiple(x / 128.0 - 1.0, 32)
    with torch.inference_mode(), f32_compute():
        out = model(x[None, None])[0, 0, :h, :w]
    lo, hi = out.min(), out.max()
    return (out - lo) / (hi - lo + 1e-9) * 255.0
