"""Ridge orientation / frequency / quality maps and the masks.

Counterpart of the JAX package's ``ops/maps.py`` (reference: get_maps.py):
- ``construct_dictionary`` (:255-346): synthetic 32 x 32 ridge-wave atoms
  over spacing x valley split x orientation x phase, built on the host;
- ``get_quality_map_dict`` (:456-515): each 16 x 16 block's best atom by
  |patch . atom|, one [blocks, 1024] x [1024, atoms] f32 product, then
  quality / orientation / frequency from the winner, smoothed;
- ``get_quality_map_dict_coarse`` (:518-584), the median-centred,
  windowed variant;
- ``get_maps_stft`` (:587-643): a block FFT directional-energy histogram
  with smoothed peak picking, then ``smooth_dir_map`` (:237-252), circular
  smoothing in the doubled-angle domain; ``get_ridge_flow_optimal_n``
  (:200-234), the neighbourhood-consistent choice of two candidates;
- the SSIM block mask (:406-453) and the intensity-based rolled mask
  (:349-366).
Thresholds and morphology of the block masks run on the host.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils.precision import f32_compute
from .contrast import local_contrast_enhancement
from .fft import extract_blocks, median
from .gaussian import gaussian_blur_cv2, gaussian_blur_reflect, pad2d

BLOCK = 16
DICT_PATCH = 32


# ---------------------------------------------------------------------------
# ridge dictionary
# ---------------------------------------------------------------------------

def construct_dictionary(ori_num: int = 30, rolled: bool = False):
    """Synthetic ridge dictionary on the host: (dict_all [1024, n_atoms],
    ori_all [n_atoms], spacing_all [n_atoms], the reciprocal spacing), f32.
    ``rolled=True`` takes construct_dictionary_rolled's narrower spacing
    range (:302-346)."""
    p2 = DICT_PATCH // 2
    Y, X = np.meshgrid(np.arange(-p2, p2), np.arange(-p2, p2))
    atoms, oris, spacings = [], [], []
    spacing_range = range(6, 13) if rolled else range(4, 13)
    for spacing in spacing_range:
        if rolled:
            valley_range = range(3, spacing // 2)
        else:
            valley_range = range(max(2, spacing // 2 - 2), spacing // 2)
        for valley_spacing in valley_range:
            ridge_spacing = spacing - valley_spacing
            for k in range(ori_num):
                theta = np.pi / 2 - k * np.pi / ori_num
                X_r = X * np.cos(theta) - Y * np.sin(theta)
                for offset in range(0, spacing - 1, 2):
                    X_off = np.remainder(X_r + offset + ridge_spacing / 2.0,
                                         spacing)
                    Y1 = np.where(X_off <= ridge_spacing, X_off, 0.0)
                    Y2 = np.where(X_off > ridge_spacing,
                                  X_off - ridge_spacing, 0.0)
                    el = (-np.sin(2 * np.pi * (Y1 / ridge_spacing / 2))
                          + np.sin(2 * np.pi * (Y2 / valley_spacing / 2)))
                    el = el.reshape(-1)
                    el = el - el.mean()
                    el = el / np.linalg.norm(el)
                    atoms.append(el)
                    oris.append(theta)
                    spacings.append(1.0 / spacing)
    dict_all = np.asarray(atoms, np.float32).T
    return (dict_all, np.asarray(oris, np.float32),
            np.asarray(spacings, np.float32))


def smooth_dir_map(dir_map: torch.Tensor, sigma: float = 2.0,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Circular smoothing in the doubled-angle domain (get_maps.py:237-252)."""
    c = torch.cos(dir_map * 2)
    s = torch.sin(dir_map * 2)
    if mask is not None:
        c = torch.where(mask == 0, 0.0, c)
        s = torch.where(mask == 0, 0.0, s)
    c = gaussian_blur_reflect(c, sigma)
    s = gaussian_blur_reflect(s, sigma)
    return torch.atan2(s, c) * 0.5


def _inner_blocks(img: torch.Tensor):
    """The 32 x 32 patch around every block but the outer ring, of the
    image padded symmetrically by 8: ([(blkH - 2)(blkW - 2), 1024], blkH,
    blkW)."""
    h, w = img.shape
    blkH, blkW = h // BLOCK, w // BLOCK
    pad = (DICT_PATCH - BLOCK) // 2
    patches, bh, bw = extract_blocks(pad2d(img, pad, "symmetric"),
                                     patch=DICT_PATCH, stride=BLOCK)
    patches = patches.reshape(bh, bw, -1)[1:blkH - 1, 1:blkW - 1]
    return patches.reshape(-1, DICT_PATCH * DICT_PATCH), blkH, blkW


def dict_similarity(img: torch.Tensor, dict_all: torch.Tensor) -> torch.Tensor:
    """|patch . atom| [(blkH - 2)(blkW - 2), n_atoms] of every inner block
    (get_maps.py:480-490): the patch less its mean, over its norm + 500,
    entries beyond +/-0.05 zeroed (not clamped). Each entry is a 1,024-term
    dot of vectors of norm <= 1."""
    flat, _, _ = _inner_blocks(img)
    flat = flat - flat.mean(dim=1, keepdim=True)
    flat = flat / (flat.norm(dim=1, keepdim=True) + 500.0)
    t = 0.05
    flat = torch.where(flat > t, 0.0, flat)
    flat = torch.where(flat < -t, -0.0, flat)
    with f32_compute():
        return (flat @ dict_all).abs()


def _block_maps(qual, dir_flat, fre_flat, blkH: int, blkW: int,
                replicate_border_bug: bool):
    """Inner-block values onto [blkH, blkW] maps with the reference's
    border replication: it copies the *frequency* row / column into the
    direction map's bottom / right borders (get_maps.py:503-510) where
    ``replicate_border_bug`` is set."""
    inner = (blkH - 2, blkW - 2)
    dev = qual.device
    maps_ = []
    for v in (qual, dir_flat, fre_flat):
        m = torch.zeros((blkH, blkW), dtype=torch.float32, device=dev)
        m[1:-1, 1:-1] = v.reshape(inner)
        maps_.append(m)
    quality, dirm, frem = maps_
    frem[0], frem[-1] = frem[1], frem[-2]
    dirm[0] = dirm[1]
    dirm[-1] = frem[-2] if replicate_border_bug else dirm[-2]
    frem[:, 0], frem[:, -1] = frem[:, 1], frem[:, -2]
    dirm[:, 0] = dirm[:, 1]
    dirm[:, -1] = frem[:, -2] if replicate_border_bug else dirm[:, -2]
    return quality, dirm, frem


def _quality_map_core(img, dict_all, ori_all, spacing_all,
                      replicate_border_bug: bool = True):
    simi = dict_similarity(img, dict_all)
    qual = simi.max(dim=1).values
    best = torch.argmax(simi, dim=1)               # the first maximum
    h, w = img.shape
    quality, dirm, frem = _block_maps(qual, ori_all[best], spacing_all[best],
                                      h // BLOCK, w // BLOCK,
                                      replicate_border_bug)
    return (gaussian_blur_cv2(quality, ksize=5, sigma=0.0),
            smooth_dir_map(dirm, sigma=1.5),
            gaussian_blur_cv2(frem, ksize=3, sigma=1.0))


def get_quality_map_dict(img, dict_all, ori_all, spacing_all,
                         replicate_border_bug: bool = True):
    """Quality / direction / frequency maps [blkH, blkW] from the ridge
    dictionary (get_maps.py:456-515), on the device of ``dict_all``."""
    dict_all = torch.as_tensor(dict_all)
    dev = dict_all.device
    return _quality_map_core(
        torch.as_tensor(img, dtype=torch.float32, device=dev), dict_all,
        torch.as_tensor(ori_all, device=dev),
        torch.as_tensor(spacing_all, device=dev),
        replicate_border_bug=replicate_border_bug)


def _stft_direction_tables(patch_size: int, nrof_dirs: int = 16):
    half = patch_size // 2
    x, y = np.meshgrid(np.arange(-half, half), np.arange(-half, half))
    # f64 tables: direction binning at exact pi/nd boundaries must not
    # depend on f32 arctan2 rounding
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    r = np.sqrt(x * x + y * y) + 1e-4
    f_low = patch_size / 18.0
    f_high = patch_size / 3.0
    band = (1.0 / (1 + (r / f_high) ** 4)) * (1.0 / (1 + (f_low / r) ** 4))
    d = np.arctan2(y, x)
    d[d < 0] += np.pi
    dir_ind = np.floor(d / (np.pi / nrof_dirs)).astype(int)
    dir_ind[dir_ind == nrof_dirs] = 0
    onehot = np.stack([(dir_ind == i).astype(np.float32)
                       for i in range(nrof_dirs)])      # [nd, P, P]
    sigma = patch_size / 3.0
    weight = np.exp(-(x * x + y * y) / (sigma * sigma)).astype(np.float32)
    return band.astype(np.float32), onehot, weight, r.astype(np.float32)


def _stft_histograms(img: torch.Tensor, patch_size: int, nrof_dirs: int):
    """Directional-energy analysis (get_maps.py:33-99) -> (sm, is_peak,
    fre_by_dir, bh, bw): the smoothed, normalized histogram [n, nd], its
    circular peak mask and the per-direction ridge frequency, with two
    quirks of the reference's ``local_STFT.analysis`` kept: the [1, 4, 1] / 6
    smoothing is IN PLACE (``smoothed_dir_norm = dir_norm`` aliases, so each
    step reads the already smoothed left neighbor: a recursive filter, not a
    convolution), and the frequency normalizer is that same aliased,
    smoothed and normalized array, not the raw bin energy."""
    band, onehot, weight, r = (torch.as_tensor(t, device=img.device)
                               for t in _stft_direction_tables(patch_size,
                                                               nrof_dirs))
    patches, bh, bw = extract_blocks(img, patch=patch_size, stride=BLOCK)
    n = patches.shape[0]
    p = patches * weight[None]
    p = p - p.mean(dim=(1, 2), keepdim=True)
    p = p / (p.reshape(n, -1).norm(dim=1)[:, None, None] + 1e-6)
    f = torch.fft.fftshift(torch.fft.fft2(p), dim=(1, 2)) * band[None]

    energy = f.abs()
    energy = energy / (energy.sum(dim=(1, 2), keepdim=True) + 1e-5)
    onehot = onehot.reshape(nrof_dirs, -1)
    with f32_compute():
        dir_norm = energy.reshape(n, -1) @ onehot.T             # [n, nd]
        wenergy = (energy * r[None]).reshape(n, -1) @ onehot.T

    # sequential in-place circular smoothing (get_maps.py:52-58): the left
    # neighbor is the smoothed one, the right neighbor always the raw value
    prev = dir_norm[:, nrof_dirs - 1]
    cols = []
    for i in range(nrof_dirs):
        prev = (prev + 4.0 * dir_norm[:, i]
                + dir_norm[:, (i + 1) % nrof_dirs]) / 6.0
        cols.append(prev)
    sm = torch.stack(cols, dim=1)
    sm = sm / (sm.sum(dim=1, keepdim=True) + 1e-5)

    is_peak = (sm > torch.roll(sm, 1, dims=1)) & (sm > torch.roll(sm, -1,
                                                                 dims=1))
    # aliased normalizer: the reference divides by smoothed_dir_norm
    fre_by_dir = 1.0 / (wenergy / (sm + 1e-12) + 1e-5)
    return sm, is_peak, fre_by_dir, bh, bw


def _stft_maps_core(img: torch.Tensor, patch_size: int = 64,
                    nrof_dirs: int = 16):
    """Each block's strongest smoothed peak -> (ori, fre) [bh, bw]; -10
    where a block has no peak."""
    sm, is_peak, fre_by_dir, bh, bw = _stft_histograms(img, patch_size,
                                                       nrof_dirs)
    conf = torch.where(is_peak, sm, -math.inf)
    best = torch.argmax(conf, dim=1)          # the first maximum
    ori_interval = math.pi / nrof_dirs
    ori = best * ori_interval + ori_interval / 2 + math.pi / 2
    fre = fre_by_dir.gather(1, best[:, None])[:, 0]
    has_peak = is_peak.any(dim=1)
    ori = torch.where(has_peak, ori, -10.0).to(torch.float32)
    fre = torch.where(has_peak, fre, -10.0)
    return ori.reshape(bh, bw), fre.reshape(bh, bw)


def get_maps_stft(img: torch.Tensor, patch_size: int = 64,
                  block_size: int = BLOCK):
    """Direction + frequency maps via block STFT (get_maps.py:587-643):
    the top-confidence smoothed peak per block, then circular smoothing."""
    img = torch.as_tensor(img, dtype=torch.float32)
    ovp = (patch_size - block_size) // 2
    dir_map, fre_map = _stft_maps_core(pad2d(img, ovp, "symmetric"),
                                       patch_size=patch_size)
    return smooth_dir_map(dir_map, sigma=2.0), fre_map


def _stft_top2_core(img: torch.Tensor, patch_size: int = 64,
                    nrof_dirs: int = 16):
    """Up to two candidate orientations per block with the reference's
    pruning (get_maps.py:77-99): the histogram peaks by confidence; if the
    strongest beats the runner-up by more than 2x only it survives, else
    the top two. -> (ori1, ori2, valid1, valid2), each [bh, bw]."""
    sm, is_peak, _, bh, bw = _stft_histograms(img, patch_size, nrof_dirs)
    conf = torch.where(is_peak, sm, -math.inf)
    c1 = conf.max(dim=1).values
    i1 = torch.argmax(conf, dim=1)
    conf2 = conf.scatter(1, i1[:, None], -math.inf)
    c2 = conf2.max(dim=1).values
    i2 = torch.argmax(conf2, dim=1)
    valid1 = is_peak.any(dim=1)
    valid2 = valid1 & torch.isfinite(c2) & \
        ~(c1 / torch.clamp(c2, min=1e-30) > 2.0)
    ori_interval = math.pi / nrof_dirs
    ori1 = i1 * ori_interval + ori_interval / 2 + math.pi / 2
    ori2 = i2 * ori_interval + ori_interval / 2 + math.pi / 2
    return tuple(a.reshape(bh, bw) for a in (ori1.to(torch.float32),
                                             ori2.to(torch.float32),
                                             valid1, valid2))


def _ridge_flow_optimal_core(img: torch.Tensor, patch_size: int = 64,
                             nrof_dirs: int = 16) -> torch.Tensor:
    ori1, ori2, valid1, valid2 = _stft_top2_core(img, patch_size, nrof_dirs)
    bh, bw = ori1.shape
    cand_ori = torch.stack([ori1, ori2], dim=-1)              # [bh, bw, 2]
    cand_valid = torch.stack([valid1, valid2], dim=-1)
    c2t = torch.where(cand_valid, torch.cos(2 * cand_ori), 0.0)
    s2t = torch.where(cand_valid, torch.sin(2 * cand_ori), 0.0)
    pad = 2
    reliability = torch.zeros((bh, bw, 2), device=img.device)
    for di in range(-pad, pad + 1):
        for dj in range(-pad, pad + 1):
            if di == 0 and dj == 0:
                continue
            roll = lambda a: torch.roll(a, (-di, -dj), dims=(0, 1))  # noqa
            nb_c, nb_s, nb_v = roll(c2t), roll(s2t), roll(cand_valid)
            # (cos(2 (ori_k - ori_nb)) + 1) / 2, the best over the
            # neighbour's valid candidates; a neighbour with none adds 0
            simi = (c2t[..., :, None] * nb_c[..., None, :]
                    + s2t[..., :, None] * nb_s[..., None, :] + 1.0) / 2.0
            simi = torch.where(nb_v[..., None, :], simi, -math.inf)
            best = simi.max(dim=-1).values
            reliability = reliability + torch.where(
                nb_v.any(dim=-1)[..., None], best, 0.0)
    reliability = torch.where(cand_valid, reliability, -math.inf)
    k = torch.argmax(reliability, dim=-1)
    dir_map = cand_ori.gather(-1, k[..., None])[..., 0] + math.pi * 0.5
    ii = torch.arange(bh, device=img.device)[:, None]
    jj = torch.arange(bw, device=img.device)[None, :]
    interior = (ii >= pad) & (ii < bh - pad) & (jj >= pad) & (jj < bw - pad)
    return torch.where(interior & valid1, dir_map, -10.0)


def get_ridge_flow_optimal_n(img, patch_size: int = 64,
                             block_size: int = BLOCK) -> torch.Tensor:
    """Neighbourhood-consistent orientation map (get_maps.py:200-234):
    each block keeps up to two candidates and the one most consistent
    with its 24 neighbours (5 x 5) wins; blocks within 2 of the border or
    without a peak are -10. The choice carries the reference's extra
    +pi/2 on top of the histogram's."""
    img = torch.as_tensor(img, dtype=torch.float32)
    ovp = (patch_size - block_size) // 2
    return _ridge_flow_optimal_core(pad2d(img, ovp, "symmetric"),
                                    patch_size=patch_size)


def _coarse_similarity(img: torch.Tensor, dict_all: torch.Tensor,
                       t: float) -> torch.Tensor:
    """The coarse variant's |patch . atom| (get_maps.py:518-560): the
    patch less its median, over its norm + 500, entries beyond +/-t
    zeroed, then a Gaussian window."""
    p2 = DICT_PATCH // 2
    x, y = np.meshgrid(np.arange(-p2, p2), np.arange(-p2, p2))
    window = torch.as_tensor(
        np.exp(-(x * x + y * y) / (DICT_PATCH * DICT_PATCH / 3.0))
        .astype(np.float32).reshape(-1), device=img.device)
    flat, _, _ = _inner_blocks(img)
    flat = flat - median(flat, dim=1, keepdim=True)
    flat = flat / (flat.norm(dim=1, keepdim=True) + 500.0)
    flat = torch.where(flat.abs() > t, 0.0, flat) * window[None, :]
    with f32_compute():
        return (flat @ dict_all).abs()


def get_quality_map_dict_coarse(img, dict_all, ori, spacing, t: float = 0.5,
                                replicate_border_bug: bool = True):
    """Coarse dictionary quality / direction / frequency maps
    (get_maps.py:518-584): median (not mean) centring, entries beyond
    +/-t zeroed, a Gaussian window after the normalization, quality
    smoothing at sigma 2. The reference reads the winner's orientation
    from doubled-angle rows 32 and 96 of a 2-D ``ori`` (pixels (1, 0) and
    (3, 0) of the flattened atom) and its frequency from row 32 of a 2-D
    ``spacing``, a layout no constructor of its produces; that indexing
    is kept for 2-D arrays, and the per-atom 1-D arrays of
    ``construct_dictionary`` are taken as the usable form."""
    dict_all = torch.as_tensor(dict_all)
    dev = dict_all.device
    img = torch.as_tensor(img, dtype=torch.float32, device=dev)
    simi = _coarse_similarity(img, dict_all, t)
    qual = simi.max(dim=1).values
    best = torch.argmax(simi, dim=1)
    ori = torch.as_tensor(np.asarray(ori), device=dev)
    spacing = torch.as_tensor(np.asarray(spacing), device=dev)
    if ori.ndim == 2:
        dir_flat = -torch.atan2(ori[DICT_PATCH + 2 * DICT_PATCH, best],
                                ori[DICT_PATCH, best]) / 2.0
    else:
        dir_flat = ori[best]
    fre_flat = spacing[DICT_PATCH, best] if spacing.ndim == 2 \
        else spacing[best]
    h, w = img.shape
    quality, dirm, frem = _block_maps(qual, dir_flat.to(torch.float32),
                                      fre_flat.to(torch.float32),
                                      h // BLOCK, w // BLOCK,
                                      replicate_border_bug)
    return (gaussian_blur_cv2(quality, ksize=5, sigma=2.0),
            smooth_dir_map(dirm, sigma=1.5),
            gaussian_blur_cv2(frem, ksize=3, sigma=1.0))


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def _ssim_weight(n: int, sigma: float) -> np.ndarray:
    yy, xx = np.mgrid[0:n, 0:n]
    c = n // 2
    return np.exp(-((xx - c) ** 2 + (yy - c) ** 2) / sigma)


def ssim_mask_quality(img: torch.Tensor, temp_img: torch.Tensor) -> torch.Tensor:
    """Blockwise windowed correlation of two images (get_maps.py:406-447)
    before thresholding: every 64 x 64 patch at stride 16 less its median,
    over its norm + 500, windowed; each pair's dot (4,096 terms of vectors
    of norm <= 1) spread onto its 4 x 4 blocks. -> [blkH, blkW]."""
    h, w = img.shape
    blkH, blkW = h // BLOCK, w // BLOCK
    patch_size = 64
    bip = patch_size // BLOCK
    w_blk = _ssim_weight(bip, (bip / 2.0) ** 2).astype(np.float32)
    w_pix = torch.as_tensor(_ssim_weight(patch_size, (patch_size / 2.0) ** 2)
                            .astype(np.float32), device=img.device)

    def prep(x):
        patches, bh, bw = extract_blocks(x, patch=patch_size, stride=BLOCK)
        flat = patches.reshape(patches.shape[0], -1)
        flat = flat - median(flat, dim=1, keepdim=True)
        flat = flat / (flat.norm(dim=1, keepdim=True) + 500.0)
        return flat * w_pix.reshape(1, -1), bh, bw

    pa, bh, bw = prep(img.to(torch.float32))
    pb, _, _ = prep(temp_img.to(torch.float32))
    simi = (pa * pb).sum(dim=1).reshape(bh, bw)
    quality = torch.zeros((blkH, blkW), device=img.device)
    for di in range(bip):
        for dj in range(bip):
            quality[di:di + bh, dj:dj + bw] += simi * float(w_blk[di, dj])
    return quality


def ssim_mask(img, temp_img, thr: float = 0.65) -> np.ndarray:
    """The SSIM block mask: the blurred quality over ``thr``, closed and
    opened on the host."""
    q = ssim_mask_quality(torch.as_tensor(img, dtype=torch.float32),
                          torch.as_tensor(temp_img, dtype=torch.float32))
    q = gaussian_blur_cv2(q, ksize=5, sigma=0.0)
    return _ssim_mask_host(q.cpu().numpy(), thr)


def _ssim_mask_host(q: np.ndarray, thr: float) -> np.ndarray:
    """Host tail of ssim_mask: the threshold and 3 x 3 closing / opening."""
    from . import morphology
    blk = q > thr
    blk = morphology.binary_closing(blk, np.ones((3, 3), bool))
    blk = morphology.binary_opening(blk, np.ones((3, 3), bool))
    return blk.astype(np.int32)


def quality_ssim_fused(aec_img, stft_texture, dict_all, ori_all, spacing_all,
                       replicate_border_bug: bool = True):
    """The latent mask stage's device work (extraction_latent.py:106-115):
    the dictionary maps of the AEC image and the blurred SSIM block quality
    of the STFT texture against it. -> (quality, dir, fre, ssim_quality),
    [blkH, blkW] each, on the device of ``dict_all``."""
    dict_all = torch.as_tensor(dict_all)
    dev = dict_all.device
    aec = torch.as_tensor(aec_img, dtype=torch.float32, device=dev)
    q, d, f = get_quality_map_dict(aec, dict_all, ori_all, spacing_all,
                                   replicate_border_bug)
    sq = ssim_mask_quality(torch.as_tensor(stft_texture, dtype=torch.float32,
                                           device=dev), aec)
    return q, d, f, gaussian_blur_cv2(sq, ksize=5, sigma=0.0)


def _intensity_mask_core(dimg: torch.Tensor) -> torch.Tensor:
    """Device half of get_quality_map_intensity: contrast-normalize ->
    gradient magnitude -> Gaussian blur -> x8 downsample."""
    nimg = local_contrast_enhancement(dimg)
    gy, gx = torch.gradient(nimg)
    mag = gaussian_blur_cv2(gx.abs() + gy.abs(), ksize=21, sigma=7.0)
    return mag[::8, ::8]


def get_quality_map_intensity(img) -> np.ndarray:
    """Rolled segmentation mask from the contrast-normalized gradient
    magnitude (get_maps.py:349-366), uint8 [h, w] on the host. Takes a
    host array or a tensor on its device."""
    from . import morphology
    dimg = torch.as_tensor(img, dtype=torch.float32)
    mag = _intensity_mask_core(dimg).cpu().numpy()
    mask = (mag > 0.3 * 127.5).astype(np.uint8)
    mask = morphology.binary_opening(mask.astype(bool), np.ones((5, 5), bool))
    mask = np.kron(mask.astype(np.uint8), np.ones((8, 8), np.uint8))
    h, w = img.shape[:2]
    return mask[:h, :w]
