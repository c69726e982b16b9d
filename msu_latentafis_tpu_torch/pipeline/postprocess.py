"""Template post-processing stages: dimensionality reduction + PQ encoding.

Counterpart of the JAX package's ``pipeline/postprocess.py``; it rewrites
templates as the reference's two batch stages do:
- ``template_compression`` (the reference implementation's
  extraction/descriptor_DR.py:104-225): read TF_C, run CompNet 192->96 over
  every template's descriptors, renormalize to 1.73, rewrite TF_C;
- ``encode_pq`` (extraction/descriptor_PQ.py:286-369): latents -> final
  .dat with float texture descriptors; rolled -> per-6-d nearest codeword
  against the codebook -> uint8 codes -> final PQ .dat.
The DR runs on the bundle's device, the PQ encoding on ``device``.
"""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from ..ops.pq import pq_encode
from ..templates import (read_codebook, read_template, write_template,
                         write_final_latent_template,
                         write_final_rolled_pq_template)
from .models_bundle import ModelBundle


def compress_template(models: ModelBundle, template) -> None:
    """DR all descriptor matrices in a Template in place."""
    def resolve(des):
        if des is None:
            return None
        if isinstance(des, (list, tuple)):
            if len(des) == 0:
                return None
            des = np.concatenate([np.asarray(d) for d in des], axis=1)
        return des if len(des) else None

    for mt in template.minu_template:
        des = resolve(mt.des)
        if des is not None:
            mt.des = models.compress(np.asarray(des, np.float32))
    for tt in template.texture_template:
        des = resolve(tt.des)
        if des is not None:
            tt.des = models.compress(np.asarray(des, np.float32))


def template_compression(models: ModelBundle, input_dir: str,
                         output_dir: Optional[str] = None,
                         is_latent: bool = False) -> None:
    output_dir = output_dir or input_dir
    os.makedirs(output_dir, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(input_dir, "*.dat"))):
        t = read_template(path, is_latent=is_latent)
        if t is None:
            continue
        compress_template(models, t)
        write_template(os.path.join(output_dir, os.path.basename(path)), t,
                       is_latent=is_latent)


def encode_pq_latent(input_path: str, output_path: str) -> None:
    t = read_template(input_path, is_latent=True)
    write_final_latent_template(output_path, t)


def encode_pq_rolled(input_path: str, output_path: str,
                     codebook: np.ndarray, device="cuda") -> None:
    """A rolled TF_C template -> its final PQ .dat; a template without
    texture descriptors -> the 2-byte empty file."""
    t = read_template(input_path, is_latent=False)
    if t is None or not t.texture_template or t.texture_template[0].des is None:
        with open(output_path, "wb") as f:
            f.write(np.zeros(1, np.uint16).tobytes())
        return
    tt = t.texture_template[0]
    tt.des = pq_encode(np.asarray(tt.des, np.float32), codebook, device=device)
    write_final_rolled_pq_template(output_path, t)


def encode_pq(input_dir: str, output_dir: str, fprint_type: str,
              codebook_path: Optional[str] = None, device="cuda") -> None:
    os.makedirs(output_dir, exist_ok=True)
    is_latent = fprint_type.lower() == "latent"
    codebook = None if is_latent else read_codebook(codebook_path)
    for path in sorted(glob.glob(os.path.join(input_dir, "*.dat"))):
        out = os.path.join(output_dir, os.path.basename(path))
        if is_latent:
            encode_pq_latent(path, out)
        else:
            encode_pq_rolled(path, out, codebook, device=device)
