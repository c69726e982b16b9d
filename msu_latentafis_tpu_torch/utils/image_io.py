"""Image files without imageio, cv2 or PIL (the card's machine has none).

- ``read_image``: 8-bit BMP (palette, 24- and 32-bit; bottom-up or
  top-down) and PNG (8- and 16-bit grey, grey + alpha, RGB, RGBA and
  palette; the five row filters; no interlace) -> the array imageio gives:
  [h, w] for grey, [h, w, 3 or 4] otherwise;
- ``read_grey``: the JAX package's ``extract_file`` conversion,
  ``img @ [0.299, 0.587, 0.114]`` where the image has channels;
- ``write_bmp`` / ``write_png``: 8-bit grey files (PNG rows filtered by a
  given cycle of filter types);
- ``resize_linear``: ``cv2.resize(img, (0, 0), fx=fx, fy=fy)``
  (INTER_LINEAR) on an f32 image.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
GREY_WEIGHTS = np.array([0.299, 0.587, 0.114])


def read_image(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return _read_png(data)
    if data[:2] == b"BM":
        return _read_bmp(data)
    raise ValueError(f"{path}: neither a BMP nor a PNG file")


def read_grey(path: str) -> np.ndarray:
    img = read_image(path)
    return img @ GREY_WEIGHTS if img.ndim == 3 else img


def _read_bmp(data: bytes) -> np.ndarray:
    offset, = struct.unpack_from("<I", data, 10)
    hsize, width, height, planes, bpp, comp = struct.unpack_from(
        "<IiiHHI", data, 14)
    if comp not in (0, 3) or bpp not in (8, 24, 32):
        raise ValueError(f"BMP of {bpp} bits, compression {comp}: not read")
    h, w = abs(height), width
    stride = (w * bpp // 8 + 3) // 4 * 4
    raw = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if height > 0:                      # bottom-up rows
        raw = raw[::-1]
    if bpp == 8:
        n_colors, = struct.unpack_from("<I", data, 46)
        n_colors = n_colors or 256
        pal = np.frombuffer(data, np.uint8, 4 * n_colors, 14 + hsize) \
            .reshape(n_colors, 4)[:, 2::-1]              # BGRX -> RGB
        idx = raw[:, :w]
        if np.array_equal(pal[:, 0], pal[:, 1]) and \
                np.array_equal(pal[:, 0], pal[:, 2]):
            return pal[idx, 0].copy()
        return pal[idx].copy()
    n = bpp // 8
    px = raw[:, :w * n].reshape(h, w, n)
    return px[..., [2, 1, 0] + ([3] if n == 4 else [])].copy()


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_row(ftype: int, line: list, prev: list, bpp: int) -> list:
    """One average (3) or Paeth (4) row: each byte needs its left one."""
    cur = line[:]
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = prev[x]
        if ftype == 3:
            cur[x] = (cur[x] + ((a + b) >> 1)) & 255
            continue
        c = prev[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (cur[x] + pred) & 255
    return cur


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """PNG scanlines (a filter byte, then the row) -> [h, row_bytes]."""
    lines = np.frombuffer(raw, np.uint8).reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int64)
    for y in range(h):
        ftype, line = int(lines[y, 0]), lines[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:                # sums of every bpp-th byte
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:
            cur = (line + prev) & 255
        elif ftype in (3, 4):
            cur = np.asarray(_unfilter_row(ftype, line.tolist(),
                                           prev.tolist(), bpp), np.int64)
        else:
            raise ValueError(f"PNG row filter {ftype}")
        out[y] = cur
        prev = cur
    return out


def _read_png(data: bytes) -> np.ndarray:
    pos, idat, palette = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                                body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if interlace or depth not in (8, 16):
        raise ValueError(f"PNG of depth {depth}, interlace {interlace}: "
                         f"not read")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        px = rows.view(">u2").astype(np.uint16).reshape(h, w, channels)
    else:
        px = rows.reshape(h, w, channels)
    if ctype == 3:
        return palette[px[..., 0]]
    return px[..., 0] if channels == 1 else px


def write_bmp(path: str, img: np.ndarray) -> None:
    """An 8-bit grey BMP (grey palette, bottom-up rows)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    stride = (w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = img[::-1]
    pal = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    pal[:, 3] = 0
    offset = 14 + 40 + 1024
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", offset + rows.size, 0, 0, offset))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, rows.size,
                            19685, 19685, 256, 0))
        f.write(pal.tobytes() + rows.tobytes())


def write_png(path: str, img: np.ndarray, filters=(0,)) -> None:
    """An 8-bit grey PNG, row y filtered by ``filters[y % len(filters)]``
    (0 none, 1 sub, 2 up, 3 average, 4 Paeth)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    lines = []
    prev = np.zeros(w, np.int32)
    for y in range(h):
        cur = img[y].astype(np.int32)
        a = np.concatenate([[0], cur[:-1]])
        c = np.concatenate([[0], prev[:-1]])
        ftype = filters[y % len(filters)]
        pred = [0, a, prev, (a + prev) >> 1, _paeth(a, prev, c)][ftype]
        lines.append(bytes([ftype]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(lines)))
                + chunk(b"IEND", b""))


def _linear_taps(n_src: int, n_dst: int, scale: float):
    """cv2's INTER_LINEAR source index and weight per destination index:
    f = (d + 0.5) scale - 0.5, s = floor(f), w = f - s rounded to f32
    (computed in f64); clamped to (0, weight 0) below the first and
    (n - 1, 0) at or past the last source pixel."""
    f = (np.arange(n_dst) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    w = (f - s).astype(np.float32)
    low, high = s < 0, s >= n_src - 1
    w[low | high] = 0
    s[low] = 0
    s[high] = n_src - 1
    return s, np.minimum(s + 1, n_src - 1), w


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """cv2.resize(img, (0, 0), fx=fx, fy=fy) with INTER_LINEAR on f32:
    the destination size round(w fx) x round(h fy), source positions at
    scale 1 / fx and 1 / fy, the horizontal pass then the vertical."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    dw, dh = int(np.rint(w * fx)), int(np.rint(h * fy))
    x0, x1, ax = _linear_taps(w, dw, 1.0 / fx)
    y0, y1, ay = _linear_taps(h, dh, 1.0 / fy)
    rows = img[:, x0] * (1 - ax) + img[:, x1] * ax
    return (rows[y0] * (1 - ay)[:, None] + rows[y1] * ay[:, None]) \
        .astype(np.float32)
