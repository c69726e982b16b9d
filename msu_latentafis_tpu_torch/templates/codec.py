"""Binary template / codebook codecs.

Byte-compatible with the reference's on-disk formats so templates and
codebooks interoperate both ways:

- **Final ``.dat`` format** (written by the PQ stage, consumed by the
  matcher): 12 x int16 reserved header + the TF_C section layout, texture
  coordinates quantized ``(x - 24) / 16`` and texture descriptors kept
  float32 for latents / uint8 PQ codes for rolled prints. Layout specified by
  the reference implementation's extraction/descriptor_PQ.py:80-272 and the native reader
  the reference implementation's matching/matcher.cpp:785-983.
- **PQ codebook**: 3 x uint16 header (n_subs, n_clusters, sub_dim) followed
  by float32 codewords — the reference implementation's matching/matcher.cpp:58-93.

A copy of the JAX package's codec (the port imports nothing from it); the
bytes written and read are identical. All functions use vectorized NumPy
buffer packing (no per-element struct calls).
"""
from __future__ import annotations

import io
import os
from typing import List, Optional, Tuple, Union

import numpy as np

from .data_model import MinuTemplate, TextureTemplate, Template, MatcherConstants

_U8 = np.dtype("<u1")
_U16 = np.dtype("<u2")
_U32 = np.dtype("<u4")
_F32 = np.dtype("<f4")


class _Reader:
    def __init__(self, data: bytes):
        self._d = data
        self._o = 0

    def arr(self, dtype, n: int) -> np.ndarray:
        dt = np.dtype(dtype)
        end = self._o + dt.itemsize * n
        out = np.frombuffer(self._d, dtype=dt, count=n, offset=self._o)
        self._o = end
        return out

    def scalar(self, dtype) -> int:
        return int(self.arr(dtype, 1)[0])

    @property
    def remaining(self) -> int:
        return len(self._d) - self._o


class _Writer:
    def __init__(self):
        self._buf = io.BytesIO()

    def arr(self, dtype, values) -> None:
        self._buf.write(np.ascontiguousarray(values, dtype=dtype).tobytes())

    def scalar(self, dtype, v) -> None:
        self.arr(dtype, [v])

    def getvalue(self) -> bytes:
        return self._buf.getvalue()


# ---------------------------------------------------------------------------
# Final .dat format (PQ stage output == matcher input)
# ---------------------------------------------------------------------------

def _resolve_des(des, n: int) -> np.ndarray:
    """Descriptors may be one array or a list of 3/1 per-patch-type arrays
    that get concatenated along the feature axis (template_2.py:657-663)."""
    if isinstance(des, (list, tuple)):
        if len(des) == 1:
            out = np.asarray(des[0])
        else:
            out = np.concatenate([np.asarray(d) for d in des], axis=1)
    else:
        out = np.asarray(des)
    return np.asarray(out[:n], dtype=np.float32)


def _write_final_common(w: _Writer, template: Template, version: int) -> bool:
    header = np.zeros((12,), dtype=np.uint16)
    header[0] = version
    w.arr(_U16, header)
    if template is None or len(template.minu_template) == 0:
        w.arr(_U16, [0, 0, 0, 0])
        return False
    first = template.minu_template[0]
    blkH = min(first.blkH, MatcherConstants.BLK_CLAMP)
    blkW = min(first.blkW, MatcherConstants.BLK_CLAMP)
    w.arr(_U16, [first.h, first.w, blkH, blkW])
    w.scalar(_U8, len(template.minu_template))
    for mt in template.minu_template:
        minu = np.asarray(mt.minutiae)[:MatcherConstants.MAX_NROF_MINUTIAE]
        n = len(minu)
        w.scalar(_U16, n)
        if n <= 0:
            continue
        w.arr(_U16, minu[:, 0])
        w.arr(_U16, minu[:, 1])
        w.arr(_F32, minu[:, 2])
        des = _resolve_des(mt.des, n)
        w.scalar(_U16, des.shape[1])
        w.arr(_F32, des.reshape(-1))
    return True


def _quantize_tex_xy(v: np.ndarray) -> np.ndarray:
    # (x - 24) / 16 coordinate quantization of texture minutiae
    # (descriptor_PQ.py:152-158); matches python2 integer-truncation via u16
    # cast of the float division.
    return ((np.asarray(v, dtype=np.float64) - 24.0) / 16.0).astype(np.uint16)


def write_final_latent_template(fname, template: Optional[Template], version: int = 1) -> None:
    """Final latent ``.dat``: float texture descriptors, quantized coords
    (descriptor_PQ.py:80-175)."""
    w = _Writer()
    if not _write_final_common(w, template, version):
        with open(fname, "wb") as f:
            f.write(w.getvalue())
        return
    w.scalar(_U8, len(template.texture_template))
    for tt in template.texture_template:
        minu = np.asarray(tt.minutiae)[:MatcherConstants.MAX_NROF_MINUTIAE]
        n = len(minu)
        w.scalar(_U16, n)
        if n <= 0:
            continue
        w.arr(_U16, _quantize_tex_xy(minu[:, 0]))
        w.arr(_U16, _quantize_tex_xy(minu[:, 1]))
        w.arr(_F32, minu[:, 2])
        des = _resolve_des(tt.des, n)[:MatcherConstants.MAX_NROF_MINUTIAE]
        w.scalar(_U16, des.shape[1])
        w.arr(_F32, des.reshape(-1))
    with open(fname, "wb") as f:
        f.write(w.getvalue())


def write_final_rolled_pq_template(fname, template: Optional[Template], version: int = 1) -> None:
    """Final rolled ``.dat``: uint8 PQ codes as texture descriptors
    (descriptor_PQ.py:178-272)."""
    w = _Writer()
    if not _write_final_common(w, template, version):
        with open(fname, "wb") as f:
            f.write(w.getvalue())
        return
    w.scalar(_U8, len(template.texture_template))
    for tt in template.texture_template:
        minu = np.asarray(tt.minutiae)[:MatcherConstants.MAX_NROF_MINUTIAE]
        n = len(minu)
        w.scalar(_U16, n)
        if n <= 0:
            continue
        w.arr(_U16, _quantize_tex_xy(minu[:, 0]))
        w.arr(_U16, _quantize_tex_xy(minu[:, 1]))
        w.arr(_F32, minu[:, 2])
        codes = np.asarray(tt.des)
        w.scalar(_U16, codes.shape[1])
        codes = codes[:MatcherConstants.MAX_NROF_MINUTIAE]
        w.arr(_U8, codes.reshape(-1))
    with open(fname, "wb") as f:
        f.write(w.getvalue())


def read_final_template(fname, kind: str = "latent") -> Template:
    """Parse a final ``.dat`` template exactly like the native reader
    (matcher.cpp:785-983). ``kind`` selects the texture descriptor dtype:
    float32 for ``"latent"``, uint8 PQ codes for ``"rolled"``. Returns an
    empty Template on empty/short files (the reader's skip semantics)."""
    template = Template()
    with open(fname, "rb") as f:
        data = f.read()
    min_len = 0 if kind == "latent" else 10
    if len(data) <= min_len:
        return template
    try:
        return _read_final(data, kind, template)
    except ValueError:
        # truncated/corrupt file: skip-and-continue like the native reader's
        # error-code returns (matcher.cpp:798-801, :835-845)
        return template


def _read_final(data: bytes, kind: str, template: Template) -> Template:
    r = _Reader(data)
    r.arr(_U16, 12)  # reserved header
    if r.remaining < 9:
        return template
    h, wdt = r.scalar(_U16), r.scalar(_U16)
    blkH = min(r.scalar(_U16), MatcherConstants.BLK_CLAMP)
    blkW = min(r.scalar(_U16), MatcherConstants.BLK_CLAMP)
    n_minu_templates = r.scalar(_U8)
    for _ in range(n_minu_templates):
        n = r.scalar(_U16)
        if n <= 0:
            continue
        if n > MatcherConstants.MAX_NROF_MINUTIAE:
            return template
        minu = np.zeros((n, 4), dtype=np.float64)
        minu[:, 0] = r.arr(_U16, n)
        minu[:, 1] = r.arr(_U16, n)
        minu[:, 2] = r.arr(_F32, n)
        des_len = r.scalar(_U16)
        des = r.arr(_F32, des_len * n).reshape(n, des_len).astype(np.float32)
        template.add_minu_template(MinuTemplate(
            h=h, w=wdt, blkH=blkH, blkW=blkW, minutiae=minu, des=des,
            oimg=np.zeros((blkH, blkW), np.float32), mask=None))
    n_tex = r.scalar(_U8)
    for _ in range(n_tex):
        n = r.scalar(_U16)
        if n <= 0:
            continue
        if n > MatcherConstants.MAX_NROF_MINUTIAE:
            return template
        minu = np.zeros((n, 4), dtype=np.float64)
        minu[:, 0] = r.arr(_U16, n)
        minu[:, 1] = r.arr(_U16, n)
        minu[:, 2] = r.arr(_F32, n)
        des_len = r.scalar(_U16)
        if kind == "latent":
            des = r.arr(_F32, des_len * n).reshape(n, des_len).astype(np.float32)
        else:
            des = r.arr(_U8, des_len * n).reshape(n, des_len).copy()
        template.add_texture_template(TextureTemplate(h=h, w=wdt, minutiae=minu, des=des))
    return template


# ---------------------------------------------------------------------------
# PQ codebook
# ---------------------------------------------------------------------------

def read_codebook(fname) -> np.ndarray:
    """Load a PQ codebook -> float32 [n_subs, n_clusters, sub_dim]
    (matcher.cpp:58-93 / descriptor_PQ.py:320-327)."""
    with open(fname, "rb") as f:
        data = f.read()
    r = _Reader(data)
    n_subs, n_clusters, sub_dim = (r.scalar(_U16) for _ in range(3))
    words = r.arr(_F32, n_subs * n_clusters * sub_dim)
    return words.reshape(n_subs, n_clusters, sub_dim).copy()


def write_codebook(fname, codewords: np.ndarray) -> None:
    n_subs, n_clusters, sub_dim = codewords.shape
    w = _Writer()
    w.arr(_U16, [n_subs, n_clusters, sub_dim])
    w.arr(_F32, np.asarray(codewords, np.float32).reshape(-1))
    with open(fname, "wb") as f:
        f.write(w.getvalue())
