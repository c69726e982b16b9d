"""Latent feature extraction.

Counterpart of the JAX package's ``pipeline/latent.py`` (reference:
FeatureExtraction_Latent.feature_extraction_single_latent,
extraction_latent.py:69-217):

1. preprocessing: cartoon-texture, Gaussian contrast normalization and the
   STFT enhancement of the texture, raw and contrast images (one batch);
2. the autoencoder enhancement of the STFT texture image; the dictionary
   quality / orientation / frequency maps of it and the SSIM block quality
   against the STFT texture; the block mask (AEC quality > 0.45, SSIM >
   0.2, each closed and opened) upsampled to pixels;
3. five minutiae sets (STFT 0.05, contrast STFT 0.10, AEC 0.25, the
   Gabor-enhanced contrast and texture images 0.25) and two consensus sets
   (votes >= 3, >= 2): 7 sets x 4 descriptor images = 28 minutiae
   templates, described over the union of the sets' minutiae;
4. virtual minutiae on a stride-16 grid more than 16 px inside the mask,
   both ridge directions: one texture template from the Gabor-enhanced
   contrast image.

Images and maps stay on the models' device; thresholds, morphology, the
consensus and the virtual grid run on the host, as in the JAX package.
``timings`` holds the last call's stage seconds (with
``EXTRACT_SYNC_TIMINGS=1`` the device is synchronized at each stage's end,
so each stage's seconds are its own); ``diag`` the last call's per-stage
counts.
"""
from __future__ import annotations

import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..ops import contrast as C
from ..ops import fft as F
from ..ops import gabor, maps, minutiae as M, morphology
from ..templates.data_model import MinuTemplate, Template, TextureTemplate
from ..utils.image_io import read_grey, resize_linear
from .models_bundle import ModelBundle

BLOCK = 16


def adjust_image_size(img: np.ndarray, block_size: int = BLOCK) -> np.ndarray:
    """Crop to whole blocks."""
    h, w = img.shape[:2]
    return img[: (h // block_size) * block_size,
               : (w // block_size) * block_size]


def upsample_block_mask(blk: np.ndarray, block: int = BLOCK) -> np.ndarray:
    """``cv2.resize(blk.astype(float), (block * blkW, block * blkH),
    INTER_LINEAR) > 0`` as float64: an upsampled pixel is set where one
    of the source cells it interpolates with a nonzero weight is set."""
    up = resize_linear(np.asarray(blk, np.float32), block, block)
    return (up > 0).astype(np.float64)


class LatentFeatureExtractor:
    def __init__(self, models: Optional[ModelBundle] = None, config=None,
                 device="cuda"):
        self.models = models or ModelBundle.initialize(config, device=device)
        dev = self.models.device
        self.dict_all, self.dict_ori, self.dict_spacing = (
            torch.as_tensor(a, device=dev)
            for a in maps.construct_dictionary(ori_num=60))
        self.timings = {}
        self.diag = {}

    # ------------------------------------------------------------------
    def extract(self, img: np.ndarray, ppi: int = 500,
                max_size: int = 1000) -> Optional[Template]:
        t_start = time.perf_counter()
        img = np.asarray(img, np.float32)
        if ppi != 500:
            img = resize_linear(img, 500.0 / ppi, 500.0 / ppi)
        img = adjust_image_size(img)
        h, w = img.shape
        if h > max_size and w > max_size:
            return None
        dev = self.models.device
        sync = os.environ.get("EXTRACT_SYNC_TIMINGS") == "1" \
            and dev.type == "cuda"
        tick = time.perf_counter()

        def lap(key):
            nonlocal tick
            if sync:
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            self.timings[key] = now - tick
            tick = now

        # --- preprocessing: three STFT variants in one batch
        dimg = torch.as_tensor(img, device=dev)
        texture_img = F.fast_cartoon_texture(dimg)
        lap("cartoon")
        contrast_img = C.local_contrast_enhancement_gaussian(dimg)
        stft3 = F.stft_enhance_batch(torch.stack([texture_img, dimg,
                                                  contrast_img]))
        stft_texture, stft_img, contrast_stft = stft3[0], stft3[1], stft3[2]
        lap("stft_x3")

        # --- AEC enhancement, maps, mask
        aec_img = self.models.enhance(stft_texture)
        lap("aec")
        quality, dir_map, fre_map, ssim_q = (
            a.cpu().numpy() for a in maps.quality_ssim_fused(
                aec_img, stft_texture, self.dict_all, self.dict_ori,
                self.dict_spacing))
        blk_aec = quality > 0.45
        blk_aec = morphology.binary_closing(blk_aec, np.ones((3, 3), bool))
        blk_aec = morphology.binary_opening(blk_aec, np.ones((3, 3), bool))
        blk_ssim = maps._ssim_mask_host(ssim_q, thr=0.2)
        blkmask = blk_ssim * blk_aec.astype(np.int32)
        blkH, blkW = blkmask.shape
        mask = upsample_block_mask(blkmask)
        lap("maps_mask")

        # --- minutiae sets (same-model pairs in one forward)
        minutiae_sets: List[np.ndarray] = []
        minutiae_sets.extend(self.models.detect_minutiae_batch(
            0, [stft_img, contrast_stft], [0.05, 0.10]))
        mnt_aec = self.models.detect_minutiae(1, aec_img, 0.25)
        minutiae_sets.append(M.remove_spurious_minutiae(mnt_aec, mask))
        lap("detect_3")

        plan = gabor.gabor_plan(dir_map + math.pi / 2, fre_map, (h, w),
                                mask=np.ones((h, w), np.uint8), device=dev)
        enh_contrast, enh_texture = gabor.gabor_apply_planned_multi(
            [contrast_img, texture_img], plan)
        lap("gabor_x2")

        mnt_contrast, mnt_texture = self.models.detect_minutiae_batch(
            1, [enh_contrast, enh_texture], [0.25, 0.25])
        minutiae_sets.append(M.remove_spurious_minutiae(mnt_contrast, mask))
        minutiae_sets.append(M.remove_spurious_minutiae(mnt_texture, mask))
        lap("detect_2")

        mnt2 = M.get_common_minutiae(minutiae_sets, thr=2)
        mnt3 = M.get_common_minutiae(minutiae_sets, thr=3)
        minutiae_sets.append(mnt3)
        minutiae_sets.append(mnt2)
        lap("consensus")
        self.timings["minutiae"] = time.perf_counter() - t_start
        self.diag = {
            "quality_mean": float(quality.mean()),
            "quality_p90": float(np.quantile(quality, 0.9)),
            "blk_aec_frac": float(blk_aec.mean()),
            "blk_ssim_frac": float(blk_ssim.mean()),
            "mask_frac": float(mask.mean()),
            "minutiae_per_set": [int(len(m)) for m in minutiae_sets],
        }

        # --- 7 sets x 4 descriptor images = 28 minutiae templates, described
        # once over the union of the sets' (x, y, ori) (the consensus sets
        # copy rows of the others); order of extraction_latent.py:175-181
        t0 = time.perf_counter()
        stack = self.models.prepare_image_stack(
            [stft_img, texture_img, enh_texture, enh_contrast])
        template = Template()
        set_arrays = [np.asarray(mnt).reshape(-1, 4) if len(mnt)
                      else np.zeros((0, 4)) for mnt in minutiae_sets]
        cat = np.concatenate(set_arrays, axis=0)
        if len(cat):
            # rounded so that the consensus copies dedupe exactly
            union, inverse = np.unique(cat[:, :3].round(6), axis=0,
                                       return_inverse=True)
            inverse = inverse.reshape(-1)
            per_img_union = self.models.describe_stack(stack, union)
        sizes = np.cumsum([0] + [len(a) for a in set_arrays])
        for si, mnt in enumerate(set_arrays):
            idx = inverse[sizes[si]:sizes[si + 1]] if len(mnt) else None
            for i in range(stack.n_images):
                des = ([arr[idx] for arr in per_img_union[i]]
                       if len(mnt) else [])
                template.add_minu_template(MinuTemplate(
                    h=h, w=w, blkH=blkH, blkW=blkW, minutiae=mnt,
                    des=des, oimg=dir_map.copy(), mask=mask))
        self.timings["descriptors"] = time.perf_counter() - t0

        # --- the texture template of virtual minutiae
        t0 = time.perf_counter()
        virtual = self._virtual_minutiae(mask, dir_map, h, w)
        self.diag["virtual_minutiae"] = int(len(virtual))
        if len(virtual) > 3:
            vdes = self.models.describe(enh_contrast, virtual)
            template.add_texture_template(TextureTemplate(
                h=h, w=w, minutiae=virtual, des=vdes))
        self.timings["texture"] = time.perf_counter() - t0
        return template

    @staticmethod
    def _virtual_minutiae(mask: np.ndarray, dir_map: np.ndarray, h: int,
                          w: int, stride: int = 16, min_dist: float = 16.0,
                          both_directions: bool = True) -> np.ndarray:
        """Grid points more than ``min_dist`` inside the mask, oriented by
        -dir_map, one row per ridge direction (extraction_latent.py:186-203).
        """
        dist = morphology.distance_transform_edt(mask)
        out = []
        for y in range(24, h - 24, stride):
            for x in range(24, w - 24, stride):
                if dist[y][x] <= min_dist:
                    continue
                ori = -dir_map[y // 16][x // 16]
                out.append([x, y, ori])
                if both_directions:
                    out.append([x, y, math.pi + ori])
        return np.asarray(out, np.float64)

    # ------------------------------------------------------------------
    def extract_file(self, img_file: str, ppi: int = 500) -> Optional[Template]:
        return self.extract(read_grey(img_file), ppi=ppi)
