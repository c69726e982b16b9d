"""Carry a gallery over from the JAX engine's device layout.

A matcher's only learned state is its PQ codebook and its gallery. The JAX
``DeviceGallery`` (the JAX package's ``matcher/engine.py:40-79``) keeps a
TPU layout: descriptors transposed to [G, D, R], coordinates as split x / y
planes, and the texture side as predecoded ``tex_dec`` [G, D, Rt], as
codes-resident uint8 planes ``tex_codes_t`` [G, S, Rt], or as flat uint8
codes ``tex_codes`` [G, Rt * S]. This module turns those arrays, handed
over as NumPy, into the port's layout (``tex_dec`` [G, Rt, D] or
``tex_codes`` [G, Rt, S]).
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

    ``arrays`` needs minu_des [G, D, Rm] f32, minu_x / minu_y / minu_ori
    [G, Rm], minu_n [G], tex_sqnorm / tex_x / tex_y / tex_ori [G, Rt],
    tex_n [G], and one texture field: tex_dec [G, D, Rt] f32, tex_codes_t
    [G, S, Rt] uint8 or tex_codes [G, Rt * S] uint8. The predecoded field
    wins when there are several. int8 galleries are refused.
    """
    def arr(key):
        v = arrays.get(key)
        return None if v is None else np.asarray(v)

    minu_des, dec = arr("minu_des"), arr("tex_dec")
    codes_t, codes = arr("tex_codes_t"), arr("tex_codes")
    if minu_des.dtype != np.float32 or (dec is not None
                                        and dec.dtype != np.float32):
        raise ValueError("only f32 galleries are ported")
    G, Rt = arr("tex_sqnorm").shape
    if dec is not None:
        tex = dict(tex_dec=np.swapaxes(dec, 1, 2))
    elif codes_t is not None:
        tex = dict(tex_codes=np.swapaxes(codes_t, 1, 2))
    elif codes is not None:
        tex = dict(tex_codes=codes.reshape(G, Rt, -1))
    else:
        raise ValueError("gallery_from_jax needs tex_dec, tex_codes_t or "
                         "tex_codes")
    if "tex_codes" in tex and tex["tex_codes"].dtype != np.uint8:
        raise ValueError("PQ codes must be uint8")

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a),
                               device=device).to(dtype).contiguous()

    def plane_pack(prefix):
        xy = torch.stack([t(arr(prefix + "_x")), t(arr(prefix + "_y"))],
                         dim=-1)
        return coord_pack(xy, t(arr(prefix + "_ori")))

    return DeviceGallery(
        minu_des=t(np.swapaxes(minu_des, 1, 2)),
        minu_pack=plane_pack("minu"),
        minu_n=t(arr("minu_n"), torch.int32),
        tex_sqnorm=t(arr("tex_sqnorm")),
        tex_pack=plane_pack("tex"),
        tex_n=t(arr("tex_n"), torch.int32),
        names=list(names) if names is not None else [str(i) for i in range(G)],
        n_real=G if n_real is None else int(n_real),
        **{k: t(v, torch.float32 if k == "tex_dec" else torch.uint8)
           for k, v in tex.items()})
