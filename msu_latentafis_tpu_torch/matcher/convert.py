"""Carry a gallery over from the JAX engine's device layout.

A matcher's only learned state is its PQ codebook and its gallery. The JAX
``DeviceGallery`` (the JAX package's ``matcher/engine.py:40-79``) keeps a
TPU layout: descriptors transposed to [G, D, R], coordinates as split x / y
planes, and the texture side as predecoded ``tex_dec`` [G, D, Rt], as
codes-resident uint8 planes ``tex_codes_t`` [G, S, Rt], or as flat uint8
codes ``tex_codes`` [G, Rt * S]. This module turns those arrays, handed
over as NumPy, into the port's layout (``tex_dec`` [G, Rt, D] or
``tex_codes`` [G, Rt, S]). Every mode of the JAX engine carries over with
its types: f32 or bf16 descriptors, int8 ``minu_des`` with its
``minu_scale``, int8 ``tex_dec``.
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

    ``arrays`` needs minu_des [G, D, Rm] (f32, bf16, or int8 with
    minu_scale [1] f32), minu_x / minu_y / minu_ori [G, Rm], minu_n [G],
    tex_sqnorm / tex_x / tex_y / tex_ori [G, Rt], tex_n [G], and one
    texture field: tex_dec [G, D, Rt] (f32, bf16 or int8), tex_codes_t
    [G, S, Rt] uint8 or tex_codes [G, Rt * S] uint8. The predecoded field
    wins when there are several. Descriptors keep their type.
    """
    def arr(key):
        v = arrays.get(key)
        return None if v is None else np.asarray(v)

    minu_des, dec = arr("minu_des"), arr("tex_dec")
    codes_t, codes = arr("tex_codes_t"), arr("tex_codes")
    scale = arr("minu_scale")
    for name, a in (("minu_des", minu_des), ("tex_dec", dec)):
        if a is not None and _dtype(a) is None:
            raise ValueError(f"{name}: dtype {a.dtype}, expected float32, "
                             f"bfloat16 or int8")
    if (minu_des.dtype == np.int8) != (scale is not None):
        raise ValueError("int8 minu_des comes with minu_scale, and only "
                         "it does")
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

    def typed(a):                        # a descriptor array, its own type
        a = np.ascontiguousarray(a)
        if _dtype(a) == torch.bfloat16:  # NumPy's bf16 is an extension type
            return torch.as_tensor(a.view(np.int16), device=device) \
                .view(torch.bfloat16).contiguous()
        return torch.as_tensor(a, device=device).contiguous()

    def plane_pack(prefix):
        xy = torch.stack([t(arr(prefix + "_x")), t(arr(prefix + "_y"))],
                         dim=-1)
        return coord_pack(xy, t(arr(prefix + "_ori")))

    if "tex_dec" in tex:
        tex["tex_dec"] = typed(tex["tex_dec"])
    else:
        tex["tex_codes"] = t(tex["tex_codes"], torch.uint8)
    return DeviceGallery(
        minu_des=typed(np.swapaxes(minu_des, 1, 2)),
        minu_scale=None if scale is None else t(scale.reshape(1)),
        minu_pack=plane_pack("minu"),
        minu_n=t(arr("minu_n"), torch.int32),
        tex_sqnorm=t(arr("tex_sqnorm")),
        tex_pack=plane_pack("tex"),
        tex_n=t(arr("tex_n"), torch.int32),
        names=list(names) if names is not None else [str(i) for i in range(G)],
        n_real=G if n_real is None else int(n_real), **tex)


def _dtype(a: np.ndarray) -> Optional[torch.dtype]:
    """The torch type of a JAX descriptor array, None if the port has no
    mode for it."""
    if a.dtype == np.float32:
        return torch.float32
    if a.dtype == np.int8:
        return torch.int8
    if str(a.dtype) == "bfloat16":
        return torch.bfloat16
    return None
