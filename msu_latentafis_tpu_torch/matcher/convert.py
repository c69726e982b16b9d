"""Carry a gallery over from the JAX engine's device layout.

A matcher's only learned state is its PQ codebook and its gallery. The JAX
``DeviceGallery`` (the JAX package's ``matcher/engine.py:40-79``) keeps a
TPU layout: descriptors transposed to [G, D, R], coordinates as split x / y
planes, and the predecoded texture gallery as ``tex_dec`` [G, D, Rt]. This
module turns those arrays, handed over as NumPy, into the port's layout.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .engine import DeviceGallery, coord_pack


def gallery_from_jax(arrays: Dict[str, np.ndarray],
                     names: Optional[Sequence[str]] = None,
                     n_real: Optional[int] = None,
                     device="cuda") -> DeviceGallery:
    """JAX DeviceGallery arrays -> port DeviceGallery on ``device``.

    ``arrays`` needs minu_des [G, D, Rm], minu_x / minu_y / minu_ori
    [G, Rm], minu_n [G], tex_dec [G, D, Rt] (f32), tex_sqnorm / tex_x /
    tex_y / tex_ori [G, Rt] and tex_n [G]. A codes-only or int8 gallery
    has no f32 ``tex_dec`` and is refused.
    """
    if "tex_dec" not in arrays or arrays["tex_dec"] is None:
        raise ValueError("gallery_from_jax needs a predecoded tex_dec")
    if np.asarray(arrays["tex_dec"]).dtype != np.float32 or \
            np.asarray(arrays["minu_des"]).dtype != np.float32:
        raise ValueError("only f32 galleries are ported")

    def t(key, dtype=torch.float32):
        return torch.as_tensor(np.array(arrays[key]),
                               device=device).to(dtype)

    def plane_pack(prefix):
        xy = torch.stack([t(prefix + "_x"), t(prefix + "_y")], dim=-1)
        return coord_pack(xy, t(prefix + "_ori"))

    G = int(np.asarray(arrays["minu_des"]).shape[0])
    return DeviceGallery(
        minu_des=t("minu_des").transpose(1, 2).contiguous(),
        minu_pack=plane_pack("minu"),
        minu_n=t("minu_n", torch.int32),
        tex_dec=t("tex_dec").transpose(1, 2).contiguous(),
        tex_sqnorm=t("tex_sqnorm").contiguous(),
        tex_pack=plane_pack("tex"),
        tex_n=t("tex_n", torch.int32),
        names=list(names) if names is not None else [str(i) for i in range(G)],
        n_real=G if n_real is None else int(n_real))
