"""Minutiae detection networks.

Counterpart of the JAX package's ``models/minutiae_net.py`` (after the
reference implementation's minutiae_AEC.py):
- ``MinutiaeAEC``: nf 64, 4x4 stride-2 encoder x6 with a tanh bottleneck,
  deconv decoder x6 to a 12-channel orientation-cylinder heatmap, ReLU out
  (:228-256);
- ``MinutiaeAEC64``: the rolled path's 64-patch variant
  (minutiae_AEC_modified.py:234-249): 4 encoder convs, tanh, 3 deconvs and
  a last deconv to 12 channels, with NO output ReLU; downsamples by 16;
- ``MinutiaeUNet``: the U-Net variant with encoder skips (:367-422).
All are fully convolutional: whole-image inference on sizes padded to the
downsampling factor (64, or 16 for the 64 variant). The heatmap comes out
NCHW [B, 12, H, W]; the decoders take it as [H, W, 12].
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .enhancement import (ConvBNRelu, DeconvBNRelu, block_modules, chain,
                          deconv, gaussian_blend_weights,
                          pad_to_multiple)
from ..utils.precision import f32_compute
from .weights import load_flax


class MinutiaeAEC(nn.Module):
    """Conv-deconv 12-channel minutiae-cylinder regressor."""

    downsample = 64

    def __init__(self, nf: int = 64, num_ori: int = 12):
        super().__init__()
        self.enc, c = chain(1, ConvBNRelu,
                            [nf * m for m in (1, 2, 4, 8, 8, 8)])
        self.dec, c = chain(c, DeconvBNRelu, [nf * m for m in (8, 8, 4, 2, 1)])
        self.out = deconv(c, num_ori)

    def forward(self, x):
        for b in self.enc:
            x = b(x)
        x = torch.tanh(x)
        for b in self.dec:
            x = b(x)
        return F.relu(self.out(x))

    def flax_modules(self) -> dict:
        return {**block_modules(self.enc, "ConvBNRelu"),
                **block_modules(self.dec, "DeconvBNRelu"),
                "ConvTranspose_0": self.out}


class MinutiaeAEC64(MinutiaeAEC):
    """The rolled path's shallower variant: no output ReLU."""

    downsample = 16

    def __init__(self, nf: int = 64, num_ori: int = 12):
        nn.Module.__init__(self)
        self.enc, c = chain(1, ConvBNRelu, [nf * m for m in (1, 2, 4, 8)])
        self.dec, c = chain(c, DeconvBNRelu, [nf * m for m in (4, 2, 1)])
        self.out = deconv(c, num_ori)

    def forward(self, x):
        for b in self.enc:
            x = b(x)
        x = torch.tanh(x)
        for b in self.dec:
            x = b(x)
        return self.out(x)


class MinutiaeUNet(MinutiaeAEC):
    """U-Net variant: each decoder block's output is concatenated with the
    encoder output of its size."""

    def __init__(self, nf: int = 64, num_ori: int = 12):
        nn.Module.__init__(self)
        enc_w = [nf * m for m in (1, 2, 4, 8, 8, 8)]
        self.enc, c = chain(1, ConvBNRelu, enc_w)
        self.dec = nn.ModuleList()
        for i, m in enumerate((8, 8, 4, 2, 1)):
            self.dec.append(DeconvBNRelu(c, nf * m))
            c = nf * m + enc_w[len(enc_w) - 2 - i]
        self.out = deconv(c, num_ori)

    def forward(self, x):
        enc = []
        for b in self.enc:
            x = b(x)
            enc.append(x)
        for i, b in enumerate(self.dec):
            x = torch.cat([b(x), enc[len(enc) - 2 - i]], dim=1)
        return F.relu(self.out(x))


def _nf(variables) -> int:
    return np.shape(variables["params"]["ConvBNRelu_0"]["Conv_0"]
                    ["kernel"])[-1]


def minutiae_from_flax(variables, cls=MinutiaeAEC) -> MinutiaeAEC:
    """A minutiae net of class ``cls`` in eval mode holding the JAX
    package's Flax variables (its width read from them)."""
    num_ori = np.shape(variables["params"]["ConvTranspose_0"]["kernel"])[-1]
    return load_flax(cls(_nf(variables), num_ori), variables)


def minutiae_heatmap(model: nn.Module, imgs, multiple=None) -> torch.Tensor:
    """Whole-image forward of a batch of same-shape grey images [B, h, w]
    (or one [h, w]): x / 128 - 1, zero-padded to the downsampling factor,
    -> the cropped heatmaps [B, h, w, 12] on the model's device."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(imgs, dtype=torch.float32, device=dev)
    if x.dim() == 2:
        x = x[None]
    x, h, w = pad_to_multiple(x / 128.0 - 1.0, multiple or model.downsample)
    with torch.inference_mode(), f32_compute():
        cyl = model(x[:, None])
    return cyl[:, :, :h, :w].permute(0, 2, 3, 1)


def detect_minutiae_tiled(model: nn.Module, img, minu_thr: float = 0.2,
                          patch: int = 128) -> np.ndarray:
    """Tiled minutiae inference with Gaussian blending and 10-px tile-border
    zeroing (ImportGraph.run, minutiae_AEC.py:42-74), then the decoder."""
    from ..ops.minutiae import decode_minutiae
    img = np.asarray(img, np.float32)
    h, w = img.shape
    stride = patch // 2
    ys = list(range(0, max(h - patch, 0) + 1, stride))
    xs = list(range(0, max(w - patch, 0) + 1, stride))
    tiles = np.stack([img[y:y + patch, x:x + patch]
                      for y in ys for x in xs]) / 128.0 - 1.0
    dev = next(model.parameters()).device
    with torch.inference_mode(), f32_compute():
        out = model(torch.as_tensor(tiles[:, None], dtype=torch.float32,
                                    device=dev))
    out = out.permute(0, 2, 3, 1).cpu().numpy().copy()    # [N, P, P, 12]
    out[:, :10, :, :] = 0
    out[:, -10:, :, :] = 0
    out[:, :, :10, :] = 0
    out[:, :, -10:, :] = 0
    weight = gaussian_blend_weights(patch, patch)[:, :, None]
    canvas = np.zeros((h, w, out.shape[-1]), np.float64)
    i = 0
    for y in ys:
        for x in xs:
            canvas[y:y + patch, x:x + patch] += out[i] * weight
            i += 1
    return decode_minutiae(canvas, thr=minu_thr)


def detect_minutiae_whole_image_batch(model: nn.Module, imgs, thrs,
                                      multiple=None,
                                      refine_dist_thr: float = 20.0):
    """Same-shape images through ONE forward and one batched decode, each
    with its own threshold (the latent pipeline's paired detections,
    extraction_latent.py:119-148)."""
    from ..ops.minutiae import decode_minutiae_batch
    cyl = minutiae_heatmap(model, np.stack([np.asarray(im, np.float32)
                                            for im in imgs])
                           if not torch.is_tensor(imgs[0])
                           else torch.stack(list(imgs)), multiple)
    return decode_minutiae_batch(cyl, thrs, refine_dist_thr=refine_dist_thr)


def detect_minutiae_whole_image(model: nn.Module, img, minu_thr: float = 0.2,
                                multiple=None,
                                refine_dist_thr: float = 20.0) -> np.ndarray:
    """Whole-image detection: x / 128 - 1, forward, crop, decode + refine +
    crowding filter (minutiae_AEC.py:76-88). The 64-patch rolled variant
    refines at dist 10 instead of 20 (minutiae_AEC_modified.py:89)."""
    from ..ops.minutiae import decode_minutiae
    cyl = minutiae_heatmap(model, img, multiple)
    return decode_minutiae(cyl[0], thr=minu_thr,
                           refine_dist_thr=refine_dist_thr)
