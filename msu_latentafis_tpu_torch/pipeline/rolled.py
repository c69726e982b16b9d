"""Rolled (gallery) feature extraction.

Counterpart of the JAX package's ``pipeline/rolled.py`` (reference:
FeatureExtraction_Rolled.feature_extraction_single_rolled,
extraction_rolled.py:70-144): the intensity-based segmentation mask,
contrast and cartoon-texture preprocessing, one minutiae set from the
texture image (the 64-patch net, thr 0.15), descriptors from the raw image,
the STFT orientation map, one minutiae template, and one texture template
of <= 1000 single-direction virtual minutiae (>= 24 px inside the mask)
described from the contrast image. The image goes to the models' device
once; ``timings`` holds the last call's stage seconds.
"""
from __future__ import annotations

import glob
import os
import time
from typing import Optional

import numpy as np
import torch

from ..ops import contrast as C
from ..ops import fft as F
from ..ops import maps, minutiae as M, morphology
from ..templates.data_model import MinuTemplate, Template, TextureTemplate
from ..utils.image_io import read_grey, resize_linear
from .latent import adjust_image_size
from .models_bundle import ModelBundle

BLOCK = 16


class RolledFeatureExtractor:
    def __init__(self, models: Optional[ModelBundle] = None, config=None,
                 device="cuda"):
        self.models = models or ModelBundle.initialize(config, device=device)
        self.timings = {}

    def extract(self, img: np.ndarray, ppi: int = 500) -> Template:
        img = np.asarray(img, np.float32)
        if ppi != 500:
            img = resize_linear(img, 500.0 / ppi, 500.0 / ppi)
        img = adjust_image_size(img)
        h, w = img.shape
        dimg = torch.as_tensor(img, device=self.models.device)

        t0 = time.perf_counter()
        mask = maps.get_quality_map_intensity(dimg)
        self.timings["cropping"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        contrast_img = C.local_contrast_enhancement(dimg)
        texture_img = F.fast_cartoon_texture(dimg)
        # the rolled path runs the 64-patch variant (bundle slot 2;
        # extraction_rolled.py:15 imports minutiae_AEC_modified), thr 0.15
        mnt = self.models.detect_minutiae(2, texture_img, 0.15)
        mnt = M.remove_spurious_minutiae(mnt, mask, r=5)
        self.timings["minutiae"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        des = self.models.describe(dimg, mnt)
        self.timings["descriptors"] = time.perf_counter() - t0

        dir_map = maps.get_maps_stft(texture_img)[0].cpu().numpy()

        blkH, blkW = h // BLOCK, w // BLOCK
        template = Template()
        template.add_minu_template(MinuTemplate(
            h=h, w=w, blkH=blkH, blkW=blkW,
            minutiae=np.asarray(mnt).reshape(-1, 4) if len(mnt)
            else np.zeros((0, 4)),
            des=des, oimg=dir_map[:blkH, :blkW].copy(), mask=mask))

        t0 = time.perf_counter()
        virtual = self._virtual_minutiae(mask, dir_map, h, w)
        if len(virtual) > 3:
            vdes = self.models.describe(contrast_img, virtual)
            template.add_texture_template(TextureTemplate(
                h=h, w=w, minutiae=virtual, des=vdes, mask=mask))
        self.timings["texture"] = time.perf_counter() - t0
        return template

    @staticmethod
    def _virtual_minutiae(mask, dir_map, h, w, stride: int = 16,
                          min_dist: float = 24.0,
                          cap: int = 1000) -> np.ndarray:
        dist = morphology.distance_transform_edt(mask)
        out = [[x, y, -dir_map[y // 16][x // 16]]
               for y in range(24, h - 24, stride)
               for x in range(24, w - 24, stride) if dist[y][x] > min_dist]
        return np.asarray(out, np.float64)[:cap]

    def extract_file(self, img_file: str, ppi: int = 500) -> Template:
        return self.extract(read_grey(img_file), ppi=ppi)


# ---------------------------------------------------------------------------
# dataset layouts (the reference's batch modes)
# ---------------------------------------------------------------------------

def enumerate_rolled_dataset(image_dir: str, layout: str = "flat",
                             img_type: str = "bmp", N1: int = 0,
                             N2: int = 10 ** 9):
    """Yield ``(img_file, template_stem, ppi)`` for each image to enroll
    (extraction_rolled.py's batch modes):

    - ``flat``: sorted ``*.<img_type>`` (and ``*.png`` beside bmp) in one
      directory, sliced [N1:N2] (feature_extraction, :146-174);
    - ``longitudinal``: per-subject directories, fingers 0-9, the first five
      impressions of each finger with five or more, stem
      ``<subject>_<image>`` (feature_extraction_Longitudinal, :176-213);
    - ``msp``: numbered ``<i>.bmp`` for i in [N1, N2]
      (feature_extraction_MSP, :215-234);
    - ``n2n``: per-subject directories of ``*.png`` at 1200 ppi
      (feature_extraction_N2N, :236-262).
    """
    if layout == "flat":
        files = sorted(glob.glob(os.path.join(image_dir, "*." + img_type)))
        if img_type == "bmp":
            files = sorted(set(files) |
                           set(glob.glob(os.path.join(image_dir, "*.png"))))
        for f in files[N1:N2]:
            yield f, os.path.splitext(os.path.basename(f))[0], 500
    elif layout == "longitudinal":
        for subject in sorted(os.listdir(image_dir))[N1:N2]:
            for finger_id in range(10):
                imgs = sorted(glob.glob(os.path.join(
                    image_dir, subject, f"*{finger_id}.bmp")))
                if len(imgs) < 5:
                    continue
                for f in imgs[:5]:
                    stem = os.path.splitext(os.path.basename(f))[0]
                    yield f, subject + "_" + stem, 500
    elif layout == "msp":
        for i in range(N1, N2 + 1):
            f = os.path.join(image_dir, f"{i}.bmp")
            if os.path.exists(f):
                yield f, str(i), 500
    elif layout == "n2n":
        for sp in sorted(glob.glob(os.path.join(image_dir, "*")))[N1:N2]:
            for f in sorted(glob.glob(os.path.join(sp, "*.png"))):
                yield f, os.path.splitext(os.path.basename(f))[0], 1200
    else:
        raise ValueError(f"unknown dataset layout: {layout!r}")
