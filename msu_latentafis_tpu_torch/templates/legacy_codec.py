"""Legacy template codecs.

The port's copy of the JAX package's ``templates/legacy_codec.py`` (the same
bytes written and read): the reference's older on-disk format family, kept
in the reference implementation's extraction/template.py:79-614:

- "Byte" (template.py:79-285): 3-column minutiae (x, y, ori), descriptors
  u16-QUANTIZED (written as floor(des / rowmax * 65535), read back with
  per-row L2 normalization), f32 orientation field, a mandatory RLE mask
  section (u16 run count + u32 runs), a u16 texture-template count, and a
  latent-only 4th texture column (distance to border, f32);
- "Byte_TF" (template.py:287-497): 4-column minutiae (adds reliability),
  float32 descriptors (read-normalized), optional RLE mask section
  (``save_mask`` writer flag, template.py:457-463);
- "Byte_TF_C_old" (template.py:499-614): the TF_C layout but with a
  ``des_num`` list of descriptor matrices per template and the RLE mask.

These exist so archives produced by older reference deployments remain
readable; new templates always use the TF_C + final PQ formats in .codec. Host NumPy
code: it runs on no device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .codec import (_Reader, _Writer, _U8, _U16, _U32, _F32,
                    run_length_decode, run_length_encode)
from .data_model import MinuTemplate, Template, TextureTemplate


def _norm_rows(d: np.ndarray) -> np.ndarray:
    return d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-6)


def _quantize_rows_u16(d: np.ndarray) -> np.ndarray:
    """The Byte writers' u16 row quantization: floor(des / rowmax * 65535)
    (template.py:224-227)."""
    d = np.asarray(d, np.float32)
    rowmax = d.max(axis=1, keepdims=True)
    return np.floor(d / (rowmax + 1e-5) * 65535.0).astype(np.uint16)


def read_template_byte(fname, is_latent: bool = True) -> Optional[Template]:
    """Parse the oldest "Byte" format (Bin2Template_Byte,
    template.py:79-190): 3-column minutiae, u16-quantized descriptors
    (L2-normalized per row on read), f32 orientation field, RLE mask
    section, then a u16 texture-template count + texture section whose
    latent variant carries a 4th distance-to-border column.

    Note: the reference's own Byte READER skips the texture-template count
    its WRITER emits (template.py:143-145 vs :247-249) — this reader
    follows the writer's byte stream, so real archives parse correctly.
    """
    with open(fname, "rb") as f:
        r = _Reader(f.read())
    template = Template()
    h, w = r.scalar(_U16), r.scalar(_U16)
    if h <= 0 or w <= 0:
        return None
    blkH, blkW = r.scalar(_U16), r.scalar(_U16)
    for _ in range(r.scalar(_U8)):
        n = r.scalar(_U16)
        if n <= 0:
            continue
        minu = np.zeros((n, 3), np.float64)
        minu[:, 0] = r.arr(_U16, n)
        minu[:, 1] = r.arr(_U16, n)
        minu[:, 2] = r.arr(_F32, n)
        des_num, des_len = r.scalar(_U16), r.scalar(_U16)
        des = [_norm_rows(r.arr(_U16, des_len * n)
                          .reshape(n, des_len).astype(np.float32))
               for _ in range(des_num)]
        oimg = r.arr(_F32, blkH * blkW).reshape(blkW, blkH).T.copy()
        runs = r.arr(_U32, r.scalar(_U16))
        mask = run_length_decode(runs, h, w)
        template.add_minu_template(MinuTemplate(
            h=h, w=w, blkH=blkH, blkW=blkW, minutiae=minu, des=des,
            oimg=oimg, mask=mask))

    if r.scalar(_U16) == 0:         # texture-template count
        return template
    n = r.scalar(_U16)
    if n <= 0:
        template.add_texture_template(TextureTemplate(h=h, w=w))
        return template
    minu = np.zeros((n, 4 if is_latent else 3), np.float64)
    minu[:, 0] = r.arr(_U16, n)
    minu[:, 1] = r.arr(_U16, n)
    minu[:, 2] = r.arr(_F32, n)
    if is_latent:
        minu[:, 3] = r.arr(_F32, n)          # distance to border
    des_num, des_len = r.scalar(_U16), r.scalar(_U16)
    des = [_norm_rows(r.arr(_U16, des_len * n)
                      .reshape(n, des_len).astype(np.float32))
           for _ in range(des_num)]
    template.add_texture_template(TextureTemplate(h=h, w=w, minutiae=minu,
                                                  des=des))
    return template


def write_template_byte(fname, template: Template,
                        is_latent: bool = True) -> None:
    """Serialize in the oldest Byte format (Template2Bin_Byte,
    template.py:192-285): u16 row-quantized descriptors + RLE masks."""
    w = _Writer()
    first = template.minu_template[0]
    w.arr(_U16, [first.h, first.w, first.blkH, first.blkW])
    w.scalar(_U8, len(template.minu_template))
    for mt in template.minu_template:
        minu = np.asarray(mt.minutiae) if mt.minutiae is not None \
            else np.zeros((0, 3))
        n = len(minu)
        w.scalar(_U16, n)
        if n <= 0:
            continue
        w.arr(_U16, minu[:, 0])
        w.arr(_U16, minu[:, 1])
        w.arr(_F32, minu[:, 2])
        des_list = mt.des if isinstance(mt.des, (list, tuple)) else [mt.des]
        w.scalar(_U16, len(des_list))
        w.scalar(_U16, des_list[0].shape[1])
        for d in des_list:
            w.arr(_U16, _quantize_rows_u16(d).reshape(-1))
        w.arr(_F32, np.asarray(mt.oimg, np.float32)
              [:first.blkH, :first.blkW].T.reshape(-1))
        mask = mt.mask if mt.mask is not None \
            else np.zeros((first.h, first.w), np.uint8)
        runs = run_length_encode(mask)
        w.scalar(_U16, len(runs))
        w.arr(_U32, runs)

    w.scalar(_U16, len(template.texture_template))
    if template.texture_template:
        tt = template.texture_template[0]
        minu = np.asarray(tt.minutiae) if tt.minutiae is not None \
            else np.zeros((0, 4))
        n = len(minu)
        w.scalar(_U16, n)
        if n > 0:
            w.arr(_U16, minu[:, 0])
            w.arr(_U16, minu[:, 1])
            w.arr(_F32, minu[:, 2])
            if is_latent:
                w.arr(_F32, minu[:, 3] if minu.shape[1] > 3
                      else np.zeros(n))
            des_list = tt.des if isinstance(tt.des, (list, tuple)) \
                else [tt.des]
            w.scalar(_U16, len(des_list))
            w.scalar(_U16, des_list[0].shape[1])
            for d in des_list:
                w.arr(_U16, _quantize_rows_u16(d).reshape(-1))
    with open(fname, "wb") as f:
        f.write(w.getvalue())


def read_template_tf(fname, is_latent: bool = True,
                     with_mask: bool = True) -> Optional[Template]:
    """Parse the Byte_TF format (Bin2Template_Byte_TF, template.py:287-408):
    4-column minutiae (x, y, ori, reliability), float32 descriptors
    (L2-normalized per row on read), orientation field, RLE mask (written
    only under the writer's ``save_mask`` flag — pass with_mask=False for
    archives written without it), u16 texture count, latent 4th texture
    column = distance to border, f32 texture descriptors (normalized)."""
    with open(fname, "rb") as f:
        r = _Reader(f.read())
    template = Template()
    h, w = r.scalar(_U16), r.scalar(_U16)
    if h <= 0 or w <= 0:
        return None
    blkH, blkW = r.scalar(_U16), r.scalar(_U16)
    for _ in range(r.scalar(_U8)):
        n = r.scalar(_U16)
        if n <= 0:
            continue
        minu = np.zeros((n, 4), np.float64)
        minu[:, 0] = r.arr(_U16, n)
        minu[:, 1] = r.arr(_U16, n)
        minu[:, 2] = r.arr(_F32, n)
        minu[:, 3] = r.arr(_F32, n)
        des_num, des_len = r.scalar(_U16), r.scalar(_U16)
        des = [_norm_rows(r.arr(_F32, des_len * n)
                          .reshape(n, des_len).astype(np.float32))
               for _ in range(des_num)]
        oimg = r.arr(_F32, blkH * blkW).reshape(blkW, blkH).T.copy()
        mask = None
        if with_mask:
            mask = run_length_decode(r.arr(_U32, r.scalar(_U16)), h, w)
        template.add_minu_template(MinuTemplate(
            h=h, w=w, blkH=blkH, blkW=blkW, minutiae=minu, des=des,
            oimg=oimg, mask=mask))

    if r.scalar(_U16) == 0:
        return template
    n = r.scalar(_U16)
    if n <= 0:
        template.add_texture_template(TextureTemplate(h=h, w=w))
        return template
    minu = np.zeros((n, 4 if is_latent else 3), np.float64)
    minu[:, 0] = r.arr(_U16, n)
    minu[:, 1] = r.arr(_U16, n)
    minu[:, 2] = r.arr(_F32, n)
    if is_latent:
        minu[:, 3] = r.arr(_F32, n)
    des_num, des_len = r.scalar(_U16), r.scalar(_U16)
    des = [_norm_rows(r.arr(_F32, des_len * n)
                      .reshape(n, des_len).astype(np.float32))
           for _ in range(des_num)]
    template.add_texture_template(TextureTemplate(h=h, w=w, minutiae=minu,
                                                  des=des))
    return template


def write_template_tf(fname, template: Template, is_latent: bool = True,
                      save_mask: bool = True) -> None:
    """Serialize in the Byte_TF format (Template2Bin_Byte_TF,
    template.py:410-497)."""
    w = _Writer()
    first = template.minu_template[0]
    w.arr(_U16, [first.h, first.w, first.blkH, first.blkW])
    w.scalar(_U8, len(template.minu_template))
    for mt in template.minu_template:
        minu = np.asarray(mt.minutiae) if mt.minutiae is not None \
            else np.zeros((0, 4))
        n = len(minu)
        w.scalar(_U16, n)
        if n <= 0:
            continue
        w.arr(_U16, minu[:, 0])
        w.arr(_U16, minu[:, 1])
        w.arr(_F32, minu[:, 2])
        w.arr(_F32, minu[:, 3] if minu.shape[1] > 3 else np.zeros(n))
        des_list = mt.des if isinstance(mt.des, (list, tuple)) else [mt.des]
        w.scalar(_U16, len(des_list))
        w.scalar(_U16, des_list[0].shape[1])
        for d in des_list:
            w.arr(_F32, np.asarray(d, np.float32).reshape(-1))
        w.arr(_F32, np.asarray(mt.oimg, np.float32)
              [:first.blkH, :first.blkW].T.reshape(-1))
        if save_mask:
            mask = mt.mask if mt.mask is not None \
                else np.zeros((first.h, first.w), np.uint8)
            runs = run_length_encode(mask)
            w.scalar(_U16, len(runs))
            w.arr(_U32, runs)

    w.scalar(_U16, len(template.texture_template))
    if template.texture_template:
        tt = template.texture_template[0]
        minu = np.asarray(tt.minutiae) if tt.minutiae is not None \
            else np.zeros((0, 4))
        n = len(minu)
        w.scalar(_U16, n)
        if n > 0:
            w.arr(_U16, minu[:, 0])
            w.arr(_U16, minu[:, 1])
            w.arr(_F32, minu[:, 2])
            if is_latent:
                w.arr(_F32, minu[:, 3] if minu.shape[1] > 3
                      else np.zeros(n))
            des_list = tt.des if isinstance(tt.des, (list, tuple)) \
                else [tt.des]
            w.scalar(_U16, len(des_list))
            w.scalar(_U16, des_list[0].shape[1])
            for d in des_list:
                w.arr(_F32, np.asarray(d, np.float32).reshape(-1))
    with open(fname, "wb") as f:
        f.write(w.getvalue())


def read_template_legacy(fname, is_latent: bool = True) -> Optional[Template]:
    """Parse the legacy Byte format (template.py:498-614 semantics)."""
    with open(fname, "rb") as f:
        data = f.read()
    r = _Reader(data)
    template = Template()
    h, w = r.scalar(_U16), r.scalar(_U16)
    if h <= 0 or w <= 0:
        return None
    blkH, blkW = r.scalar(_U16), r.scalar(_U16)
    n_minu_templates = r.scalar(_U8)
    for _ in range(n_minu_templates):
        n = r.scalar(_U16)
        if n <= 0:
            continue
        minu = np.zeros((n, 4), np.float64)
        minu[:, 0] = r.arr(_U16, n)
        minu[:, 1] = r.arr(_U16, n)
        minu[:, 2] = r.arr(_F32, n)
        minu[:, 3] = r.arr(_F32, n)
        des_num = r.scalar(_U16)
        des_len = r.scalar(_U16)
        des = []
        for _ in range(des_num):
            d = r.arr(_F32, des_len * n).reshape(n, des_len).astype(np.float32)
            d = d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-6)
            des.append(d)
        oimg = r.arr(_F32, blkH * blkW).reshape(blkW, blkH).T.copy()
        template.add_minu_template(MinuTemplate(
            h=h, w=w, blkH=blkH, blkW=blkW, minutiae=minu, des=des,
            oimg=oimg))

    n_tex = r.scalar(_U16)          # legacy: u16 texture count
    if n_tex == 0:
        return template
    n = r.scalar(_U16)
    if n <= 0:
        template.add_texture_template(TextureTemplate(h=h, w=w))
        return template
    ncols = 4 if is_latent else 3
    minu = np.zeros((n, ncols), np.float64)
    minu[:, 0] = r.arr(_U16, n)
    minu[:, 1] = r.arr(_U16, n)
    minu[:, 2] = r.arr(_F32, n)
    if is_latent:
        minu[:, 3] = r.arr(_F32, n)
    des_num = r.scalar(_U16)
    des_len = r.scalar(_U16)
    des = []
    for _ in range(des_num):
        # legacy texture descriptors are u16-quantized raw values
        d = r.arr(_U16, des_len * n).reshape(n, des_len).astype(np.float32)
        des.append(d)
    template.add_texture_template(TextureTemplate(h=h, w=w, minutiae=minu,
                                                  des=des))
    return template


def write_template_legacy(fname, template: Template,
                          is_latent: bool = True) -> None:
    """Serialize in the legacy Byte format (round-trips read_template_legacy)."""
    w = _Writer()
    if template is None or not template.minu_template:
        w.arr(_U16, [0, 0, 0, 0])
        with open(fname, "wb") as f:
            f.write(w.getvalue())
        return
    first = template.minu_template[0]
    w.arr(_U16, [first.h, first.w, first.blkH, first.blkW])
    w.scalar(_U8, len(template.minu_template))
    for mt in template.minu_template:
        minu = np.asarray(mt.minutiae) if mt.minutiae is not None else np.zeros((0, 4))
        n = len(minu)
        w.scalar(_U16, n)
        if n <= 0:
            continue
        w.arr(_U16, minu[:, 0])
        w.arr(_U16, minu[:, 1])
        w.arr(_F32, minu[:, 2])
        w.arr(_F32, minu[:, 3])
        des_list = mt.des if isinstance(mt.des, (list, tuple)) else [mt.des]
        w.scalar(_U16, len(des_list))
        w.scalar(_U16, des_list[0].shape[1])
        for d in des_list:
            w.arr(_F32, np.asarray(d, np.float32).reshape(-1))
        oimg = np.asarray(mt.oimg, np.float32)[:first.blkH, :first.blkW]
        w.arr(_F32, oimg.T.reshape(-1))

    n_tex = len(template.texture_template)
    w.scalar(_U16, n_tex)
    if n_tex:
        tt = template.texture_template[0]
        minu = np.asarray(tt.minutiae) if tt.minutiae is not None else np.zeros((0, 4))
        n = len(minu)
        w.scalar(_U16, n)
        if n > 0:
            w.arr(_U16, minu[:, 0])
            w.arr(_U16, minu[:, 1])
            w.arr(_F32, minu[:, 2])
            if is_latent:
                w.arr(_F32, minu[:, 3] if minu.shape[1] > 3 else np.zeros(n))
            des_list = tt.des if isinstance(tt.des, (list, tuple)) else [tt.des]
            w.scalar(_U16, len(des_list))
            w.scalar(_U16, des_list[0].shape[1])
            for d in des_list:
                w.arr(_U16, np.asarray(d).reshape(-1))
    with open(fname, "wb") as f:
        f.write(w.getvalue())
