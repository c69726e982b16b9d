"""Model bundle: every network the pipelines need, on one device.

Counterpart of the JAX package's ``pipeline/models_bundle.py`` (after the
reference implementation's startup, extraction_latent.py:34-67): the
enhancement net, three minutiae nets (latent STFT 128, latent AEC 128, the
rolled 64 variant), one descriptor net per patch type and the DR CompNet.

``initialize`` builds each net from the ``.npz`` its config path names
(``models.weights``; a path that is given but cannot be read raises), else
from a seeded init. The nets run in eval mode and in f32.

``describe_stack`` gathers the patches of every 96x96 patch type from an
edge-padded image stack on the device, in chunks that bound the memory of
the nets' activations; patch types whose crop window needs a resize take
the host path (``describe_host``), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.compnet import CompNet, compnet_from_flax, compress_descriptors
from ..models.descriptor_net import DescriptorNet, descriptor_from_flax
from ..models.enhancement import (EnhancementAEC, enhance_whole_image,
                                  enhancement_from_flax)
from ..models.minutiae_net import (MinutiaeAEC, MinutiaeAEC64,
                                   detect_minutiae_whole_image,
                                   detect_minutiae_whole_image_batch,
                                   minutiae_from_flax, minutiae_heatmap)
from ..models.weights import load_npz, seeded
from ..ops.gaussian import pad2d
from ..ops.patches import (PATCH_PAD, device_patch_index_table,
                           extract_patches, gather_patches_device_packed,
                           needs_resize, orientation_index)
from ..utils.precision import f32_compute

DESCRIBE_CHUNK = 512     # minutiae per descriptor forward on the device:
#                          the stem's [512, 32, 96, 96] f32 output is 600 MB


@dataclasses.dataclass
class ImageStack:
    """Descriptor-source images on the device, edge-padded by ``pad`` px,
    one flat row each: ``flat`` [I, hp * wp]."""

    h: int
    w: int
    n_images: int
    pad: int
    hp: int
    wp: int
    flat: torch.Tensor


class ModelBundle:
    """The nets, in eval mode on ``device``. ``minutiae`` lists the latent
    STFT, latent AEC and rolled nets; ``descriptors`` one net per entry of
    ``patch_types``. Only ``compnet`` is required (the DR stages)."""

    def __init__(self, compnet: CompNet, device="cuda",
                 enhancement: Optional[EnhancementAEC] = None,
                 minutiae: Sequence[MinutiaeAEC] = (),
                 descriptors: Sequence[DescriptorNet] = (),
                 patch_types: Sequence[int] = (2, 8, 11)):
        self.device = torch.device(device)
        on = lambda m: m.to(self.device).eval()  # noqa: E731
        self.compnet = on(compnet)
        self.enhancement = None if enhancement is None else on(enhancement)
        self.minutiae = [on(m) for m in minutiae]
        self.descriptors = [on(m) for m in descriptors]
        self.patch_types = tuple(patch_types)

    @classmethod
    def initialize(cls, config=None, patch_types: Sequence[int] = (2, 8, 11),
                   seed: int = 0, device="cuda") -> "ModelBundle":
        """Each net from the ``.npz`` its config path names (its widths
        read from the file; raises if a named file cannot be read), else
        from the seeded init (net i of the list below from seed + i)."""
        slots = [("EnhancementModel", EnhancementAEC, enhancement_from_flax),
                 ("MinutiaeExtractionModelLatentSTFT", MinutiaeAEC,
                  minutiae_from_flax),
                 ("MinutiaeExtractionModel", MinutiaeAEC, minutiae_from_flax),
                 ("MinutiaeExtractionModelRolled", MinutiaeAEC64,
                  lambda v: minutiae_from_flax(v, MinutiaeAEC64)),
                 ("DimensionalityReductionModel", CompNet, compnet_from_flax)]
        slots += [(f"DescriptorModelPatch{pt}", DescriptorNet,
                   descriptor_from_flax) for pt in patch_types]
        nets = []
        for i, (key, init, from_flax) in enumerate(slots):
            path = getattr(config, key, "") if config is not None else ""
            if path:
                nets.append(from_flax(load_npz(path)))
                continue
            with seeded(seed + i):
                nets.append(init())
        enh, *minu, comp = nets[:5]
        return cls(comp, device, enhancement=enh, minutiae=minu,
                   descriptors=nets[5:], patch_types=patch_types)

    # ------------------------------------------------------------------
    def enhance(self, img) -> torch.Tensor:
        return enhance_whole_image(self.enhancement, img)

    def _detect_args(self, model_idx: int) -> dict:
        modified = isinstance(self.minutiae[model_idx], MinutiaeAEC64)
        return dict(multiple=16 if modified else 64,
                    refine_dist_thr=10.0 if modified else 20.0)

    def minutiae_heatmap(self, model_idx: int, img) -> torch.Tensor:
        """The net's cropped heatmap [h, w, 12] of one image, on the
        device."""
        return minutiae_heatmap(self.minutiae[model_idx], img,
                                self._detect_args(model_idx)["multiple"])[0]

    def detect_minutiae(self, model_idx: int, img,
                        minu_thr: float = 0.2) -> np.ndarray:
        return detect_minutiae_whole_image(
            self.minutiae[model_idx], img, minu_thr=minu_thr,
            **self._detect_args(model_idx))

    def detect_minutiae_batch(self, model_idx: int, imgs, thrs):
        """Same-model detection of same-shape images in one forward."""
        return detect_minutiae_whole_image_batch(
            self.minutiae[model_idx], imgs, thrs,
            **self._detect_args(model_idx))

    def prepare_image_stack(self, imgs: Sequence) -> ImageStack:
        """The images edge-padded by PATCH_PAD on the device, one flat row
        each."""
        arrs = torch.stack([torch.as_tensor(im, dtype=torch.float32,
                                            device=self.device)
                            for im in imgs])
        h, w = arrs.shape[1:]
        padded = pad2d(arrs, PATCH_PAD, "edge")
        return ImageStack(h=h, w=w, n_images=len(imgs), pad=PATCH_PAD,
                          hp=h + 2 * PATCH_PAD, wp=w + 2 * PATCH_PAD,
                          flat=padded.reshape(len(imgs), -1))

    def _embed(self, k: int, x: torch.Tensor) -> torch.Tensor:
        """Descriptor net k on patches [B, 96, 96] (0-255) -> L2-normalized
        [B, 64]."""
        with torch.inference_mode(), f32_compute():
            emb = self.descriptors[k]((x / 128.0 - 1.0)[:, None])
        return emb / (emb.norm(dim=1, keepdim=True) + 1e-7)

    def describe_stack(self, stack: ImageStack,
                       minutiae: np.ndarray) -> List[List[np.ndarray]]:
        """L2-normalized embeddings for every (image, patch type) pair:
        ``out[i][k]`` is [n_minutiae, 64] for source image i, patch type
        k."""
        n = len(minutiae)
        if n == 0:
            return [[] for _ in range(stack.n_images)]
        if any(needs_resize(pt) for pt in self.patch_types):
            imgs = stack.flat.reshape(stack.n_images, stack.hp, stack.wp)[
                :, stack.pad:stack.pad + stack.h,
                stack.pad:stack.pad + stack.w].cpu().numpy()
            return [self.describe_host(im, minutiae) for im in imgs]
        m = np.asarray(minutiae)
        dev = self.device
        ori_ind = torch.as_tensor(orientation_index(m), device=dev)
        xs = torch.as_tensor(np.clip(m[:, 0].astype(np.int64), 0,
                                     stack.w - 1), device=dev)
        ys = torch.as_tensor(np.clip(m[:, 1].astype(np.int64), 0,
                                     stack.h - 1), device=dev)
        table = device_patch_index_table(self.patch_types, stack.wp,
                                         str(dev))
        T = len(self.patch_types)
        out = torch.empty((stack.n_images, T, n, 64), device=dev)
        for a in range(0, n, DESCRIBE_CHUNK):
            b = slice(a, min(a + DESCRIBE_CHUNK, n))
            patches = gather_patches_device_packed(
                stack.flat, stack.wp, stack.pad, xs[b], ys[b], ori_ind[b],
                table)                                  # [I, T, B, 96, 96]
            for k in range(T):
                emb = self._embed(k, patches[:, k].reshape(-1, 96, 96))
                out[:, k, b] = emb.reshape(stack.n_images, -1, 64)
        full = out.cpu().numpy()
        return [[full[i, k] for k in range(T)]
                for i in range(stack.n_images)]

    def describe(self, img, minutiae: np.ndarray) -> List[np.ndarray]:
        """Per-patch-type L2-normalized embeddings of one image
        (descriptor.minutiae_descriptor_extraction)."""
        if len(minutiae) == 0:
            return []
        return self.describe_stack(self.prepare_image_stack([img]),
                                   minutiae)[0]

    def describe_host(self, img: np.ndarray, minutiae: np.ndarray,
                      batch_size: int = 128) -> List[np.ndarray]:
        """The patches extracted on the host (``extract_patches``, which
        resizes crops smaller than 96x96), then the nets on the device:
        the oracle of ``describe_stack``."""
        out = []
        if len(minutiae) == 0:
            return out
        for k, pt in enumerate(self.patch_types):
            patches = extract_patches(minutiae, np.asarray(img, np.float32),
                                      patch_type=pt)
            embs = [self._embed(k, torch.as_tensor(
                        np.ascontiguousarray(patches[i:i + batch_size]),
                        dtype=torch.float32, device=self.device))
                    for i in range(0, len(patches), batch_size)]
            out.append(torch.cat(embs).cpu().numpy())
        return out

    def compress(self, des: np.ndarray) -> np.ndarray:
        """[N, 192] descriptors -> [N, 96], renormalized to 1.73."""
        return compress_descriptors(self.compnet, des)
