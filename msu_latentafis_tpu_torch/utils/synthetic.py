"""Synthetic templates and galleries for tests and the chip smoke run.

The host half is a NumPy copy of the JAX package's generator (final ``.dat``
semantics: texture coordinates already quantized, descriptors L2-normalized
to 1.73 as after dimensionality reduction). ``device_synthetic_gallery``
fills a gallery directly on the card from a ``torch.Generator``, so a
100K-entry gallery costs no host generation or upload.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.pq import pq_encode
from ..templates.data_model import MinuTemplate, TextureTemplate, Template

DES_NORM = 1.73  # post-DR descriptor norm (descriptor_DR.py:152)
# int8 minutiae descriptors of a synthetic gallery: the JAX generator's
# fixed scale, which bounds every |x| <= DES_NORM without a pass over G
MINU_INT8_SCALE = DES_NORM / 127.0 + 1e-12


def random_descriptors(rng: np.random.Generator, n: int, dim: int = 96,
                       norm: float = DES_NORM) -> np.ndarray:
    d = rng.standard_normal((n, dim)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-7
    return (d * norm).astype(np.float32)


def random_codebook(rng: np.random.Generator, n_subs: int = 16,
                    n_clusters: int = 256, sub_dim: int = 6) -> np.ndarray:
    cb = rng.standard_normal((n_subs, n_clusters, sub_dim)).astype(np.float32)
    return cb * (DES_NORM / np.sqrt(n_subs * sub_dim))


def random_minutiae(rng: np.random.Generator, n: int, h: int = 512,
                    w: int = 512, margin: int = 24,
                    with_reliability: bool = True) -> np.ndarray:
    cols = 4 if with_reliability else 3
    m = np.zeros((n, cols), np.float64)
    m[:, 0] = rng.integers(margin, w - margin, n)
    m[:, 1] = rng.integers(margin, h - margin, n)
    m[:, 2] = rng.uniform(-np.pi, np.pi, n)
    if with_reliability:
        m[:, 3] = 1.0
    return m


def random_quantized_minutiae(rng: np.random.Generator, n: int,
                              blk: int = 30) -> np.ndarray:
    """Texture minutiae with on-disk quantized (x-24)/16 coordinates."""
    m = np.zeros((n, 4), np.float64)
    m[:, 0] = rng.integers(0, blk, n)
    m[:, 1] = rng.integers(0, blk, n)
    m[:, 2] = rng.uniform(-np.pi, np.pi, n)
    return m


def make_rolled_template(rng: np.random.Generator, n_minu: int = 60,
                         n_tex: int = 300, des_dim: int = 96,
                         n_subs: int = 16, h: int = 512, w: int = 512,
                         mated_latent: Optional[Template] = None,
                         codebook: Optional[np.ndarray] = None,
                         noise: float = 0.25,
                         tex_noise: float = 0.0,
                         mate_template_idx: int = 26) -> Template:
    """Rolled template in final-PQ form (uint8 texture codes).

    With ``mated_latent`` the descriptors/coordinates are noisy copies of
    the latent's selected minutiae template ``mate_template_idx`` and the
    texture codes PQ-encode the latent's texture descriptors (requires
    ``codebook``), so the genuine pair scores far above random impostors.
    ``noise`` grades the minutiae-descriptor corruption and ``tex_noise``
    the texture descriptors' before PQ encoding (renormalized to
    DES_NORM): together they make near-mates of a controlled strength, as
    the structured rank-parity protocol plants them. The generator is
    drawn in the JAX package's order, so one seed gives one template.
    """
    t = Template()
    minu = random_minutiae(rng, n_minu, h, w, with_reliability=False)
    des = random_descriptors(rng, n_minu, des_dim)
    if mated_latent is not None and mated_latent.minu_template:
        idx = min(mate_template_idx, len(mated_latent.minu_template) - 1)
        src = mated_latent.minu_template[idx]
        k = min(n_minu, src.n_minutiae)
        minu[:k, :3] = np.asarray(src.minutiae)[:k, :3]
        minu[:k, :2] += rng.normal(0, 2.0, (k, 2))
        d = src.des[:k] + noise * rng.standard_normal(
            (k, des_dim)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-7
        des[:k] = d * DES_NORM
    t.add_minu_template(MinuTemplate(
        h=h, w=w, blkH=h // 16, blkW=w // 16, minutiae=minu, des=des,
        oimg=np.zeros((h // 16, w // 16), np.float32)))
    tex = random_quantized_minutiae(rng, n_tex)
    codes = rng.integers(0, 256, (n_tex, n_subs)).astype(np.uint8)
    if mated_latent is not None and mated_latent.texture_template:
        src = mated_latent.texture_template[0]
        k = min(n_tex, src.n_minutiae)
        tex[:k] = np.asarray(src.minutiae)[:k, :4]
        if codebook is not None and k:
            d = np.asarray(src.des)[:k].astype(np.float32)
            if tex_noise > 0:
                d = d + tex_noise * rng.standard_normal(d.shape) \
                    .astype(np.float32)
                d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-7
                d *= DES_NORM
            codes[:k] = pq_encode(d, codebook, device="cpu")
    t.add_texture_template(TextureTemplate(h=h, w=w, minutiae=tex, des=codes))
    return t


def make_latent_template(rng: np.random.Generator, n_minu: int = 30,
                         n_tex: int = 200, des_dim: int = 96,
                         n_minu_templates: int = 28, h: int = 512,
                         w: int = 512) -> Template:
    """Latent template in final form: 28 minutiae templates + 1 float
    texture template with quantized coordinates."""
    t = Template()
    for _ in range(n_minu_templates):
        minu = random_minutiae(rng, n_minu, h, w)
        des = random_descriptors(rng, n_minu, des_dim)
        t.add_minu_template(MinuTemplate(
            h=h, w=w, blkH=h // 16, blkW=w // 16, minutiae=minu, des=des,
            oimg=np.zeros((h // 16, w // 16), np.float32)))
    tex = random_quantized_minutiae(rng, n_tex)
    des = random_descriptors(rng, n_tex, des_dim)
    t.add_texture_template(TextureTemplate(h=h, w=w, minutiae=tex, des=des))
    return t


def synthetic_packed_gallery(rng: np.random.Generator, codebook: np.ndarray,
                             G: int, n_minu: int = 96, n_tex: int = 448,
                             des_dim: int = 96):
    """A PackedGallery of G synthetic rolled templates built with
    vectorized NumPy; counts are jittered down to 75% per entry."""
    from ..templates.packing import PackedGallery
    n_subs, n_clusters, _ = codebook.shape
    Rm, Rt = n_minu, n_tex

    minu_des = rng.standard_normal((G, Rm, des_dim), dtype=np.float32)
    minu_des /= np.linalg.norm(minu_des, axis=2, keepdims=True) + 1e-7
    minu_des *= DES_NORM
    minu_n = rng.integers(int(0.75 * Rm), Rm + 1, G).astype(np.int32)
    mmask = np.arange(Rm)[None, :] < minu_n[:, None]
    minu_des *= mmask[:, :, None]
    minu_xy = rng.integers(24, 488, (G, Rm, 2)).astype(np.float32) \
        * mmask[:, :, None]
    minu_ori = rng.uniform(-np.pi, np.pi, (G, Rm)).astype(np.float32) * mmask

    tex_codes = rng.integers(0, n_clusters, (G, Rt, n_subs)).astype(np.uint8)
    tex_n = rng.integers(int(0.75 * Rt), Rt + 1, G).astype(np.int32)
    tmask = np.arange(Rt)[None, :] < tex_n[:, None]
    tex_codes *= tmask[:, :, None]
    cw_sqnorm = np.sum(codebook.astype(np.float64) ** 2, axis=2) \
        .astype(np.float32)
    tex_sqnorm = cw_sqnorm[np.arange(n_subs)[None, None, :],
                           tex_codes.astype(np.int64)].sum(axis=2) * tmask
    tex_xy = rng.integers(0, 30, (G, Rt, 2)).astype(np.float32) \
        * tmask[:, :, None]
    tex_ori = rng.uniform(-np.pi, np.pi, (G, Rt)).astype(np.float32) * tmask
    return PackedGallery(minu_des=minu_des, minu_xy=minu_xy,
                         minu_ori=minu_ori, minu_n=minu_n,
                         tex_codes=tex_codes,
                         tex_sqnorm=tex_sqnorm.astype(np.float32),
                         tex_xy=tex_xy, tex_ori=tex_ori, tex_n=tex_n,
                         names=[str(i) for i in range(G)])


def device_synthetic_gallery(engine, G: int, n_minu: int = 96,
                             n_tex: int = 448, des_dim: int = 96,
                             codes_resident: bool = False, seed: int = 0,
                             chunk: int = 2048, both_layouts: bool = False):
    """A DeviceGallery of G random rolled templates generated on the
    engine's device from ``torch.Generator(seed)``, chunk by chunk.

    The texture side is predecoded (``tex_dec`` in the engine's mode: f32,
    bf16 or int8) or, with ``codes_resident``, only the uint8
    ``tex_codes``. With ``both_layouts`` it returns the pair (predecoded,
    codes-resident): the second holds the codes the first's ``tex_dec``
    decodes from and shares every other tensor with it. The descriptors
    are drawn in f32 and stored as the engine stores them: the compute
    dtype, or with minu_int8 int8 at the JAX generator's fixed scale
    MINU_INT8_SCALE (the JAX package's utils/synthetic.py:170), one chunk
    at a time. The squared norms are those of each chunk's f32 decode. So
    no G-sized f32 descriptor or predecoded texture is built beyond what
    the gallery keeps: the peak is the gallery plus one chunk's
    temporaries. G is padded to a block multiple; padding entries have
    zero counts and score -1."""
    from ..matcher.engine import DeviceGallery
    from ..matcher.texture_match import decode_pq

    if codes_resident and both_layouts:
        raise ValueError("both_layouts already returns the codes-resident "
                         "twin")
    dev = engine.device
    B = engine.block_size
    Gp = -(-G // B) * B
    Rm, Rt, D = n_minu, n_tex, des_dim
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    cb = engine.codebook_t
    S, C, _ = cb.shape
    f32 = dict(dtype=torch.float32, device=dev)
    scale = MINU_INT8_SCALE if engine.minu_int8 else None
    t = dict(
        minu_des=torch.empty((Gp, Rm, D), dtype=torch.int8
                             if engine.minu_int8 else engine.compute_dtype,
                             device=dev),
        minu_pack=torch.empty((Gp, Rm, 4), **f32),
        minu_n=torch.zeros((Gp,), dtype=torch.int32, device=dev),
        tex_dec=None if codes_resident else torch.empty(
            (Gp, Rt, D), dtype=engine.tex_dec_dtype, device=dev),
        tex_codes=torch.zeros((Gp, Rt, S), dtype=torch.uint8, device=dev)
        if codes_resident or both_layouts else None,
        tex_sqnorm=torch.empty((Gp, Rt), **f32),
        tex_pack=torch.empty((Gp, Rt, 4), **f32),
        tex_n=torch.zeros((Gp,), dtype=torch.int32, device=dev))
    t["minu_n"][:G] = Rm
    t["tex_n"][:G] = Rt
    for a in range(0, Gp, chunk):
        n = min(chunk, Gp - a)
        des = torch.randn((n, Rm, D), generator=gen, **f32)
        des /= des.norm(dim=2, keepdim=True) + 1e-7
        t["minu_des"][a:a + n] = engine.minutiae_storage(
            des * DES_NORM, scale)[0]
        ori = uniform((n, Rm), -np.pi, np.pi)
        t["minu_pack"][a:a + n] = torch.stack(
            [uniform((n, Rm), 24, 488), uniform((n, Rm), 24, 488),
             torch.cos(ori), torch.sin(ori)], dim=2)
        codes = torch.randint(0, C, (n, Rt, S), generator=gen, device=dev)
        if t["tex_codes"] is not None:
            t["tex_codes"][a:a + n] = codes
        if t["tex_dec"] is not None:
            t["tex_dec"][a:a + n] = engine.predecode(codes)
        dec = decode_pq(codes, cb)
        t["tex_sqnorm"][a:a + n] = (dec * dec).sum(dim=2)
        del dec
        tori = uniform((n, Rt), -np.pi, np.pi)
        t["tex_pack"][a:a + n] = torch.stack(
            [torch.floor(uniform((n, Rt), 0, 30)),
             torch.floor(uniform((n, Rt), 0, 30)),
             torch.cos(tori), torch.sin(tori)], dim=2)
    for v in t.values():
        if v is not None:
            v[G:] = 0
    codes, dec = t.pop("tex_codes"), t.pop("tex_dec")
    minu_scale = None if scale is None else torch.full((1,), scale, **f32)

    def gallery(**tex):
        return DeviceGallery(names=[str(i) for i in range(G)], n_real=G,
                             minu_scale=minu_scale, **t, **tex)
    if both_layouts:
        return gallery(tex_dec=dec), gallery(tex_codes=codes)
    return gallery(tex_codes=codes) if codes_resident \
        else gallery(tex_dec=dec)


def plant_gallery_entries(gallery, engine, packed_mates,
                          positions: Sequence[int]) -> None:
    """Overwrite gallery rows at ``positions`` in place with real packed
    templates (planted mates); ``packed_mates`` holds len(positions)
    entries. Every tensor the gallery holds is written, in either layout
    and in the engine's mode (an int8 gallery's minutiae descriptors with
    the gallery's own scale); per-entry axes are zero-padded up to the
    gallery's capacity."""
    from ..matcher.kernels.ops import true_div
    loaded = engine.load_gallery(packed_mates)
    codes = torch.as_tensor(packed_mates.tex_codes, device=engine.device)
    small = {f: getattr(loaded, f) for f in gallery.TENSORS}
    small.update(tex_codes=codes, tex_dec=engine.predecode(codes))
    mdes = torch.as_tensor(np.asarray(packed_mates.minu_des, np.float32),
                           device=engine.device)
    if gallery.minu_scale is not None:
        mdes = torch.clamp(torch.round(true_div(
            mdes, gallery.minu_scale.expand_as(mdes))), -127, 127)
    small["minu_des"] = mdes.to(gallery.minu_des.dtype)
    pos = torch.as_tensor(list(positions), dtype=torch.long,
                          device=gallery.minu_des.device)
    n = len(positions)
    for f in gallery.TENSORS:
        big = getattr(gallery, f)
        if big is None:
            continue
        sm = small[f][:n]
        pad = []
        for b, s in zip(reversed(big.shape[1:]), reversed(sm.shape[1:])):
            if s > b:
                raise ValueError(f"{f}: planted entry wider than gallery")
            pad += [0, b - s]
        if pad:
            sm = torch.nn.functional.pad(sm, pad)
        big.index_copy_(0, pos, sm.to(big.dtype))
    for i, p in enumerate(positions):
        gallery.names[p] = packed_mates.names[i]


def random_compnet(seed: int, in_dims: int = 192, out_dims: int = 96):
    """A CompNet in eval mode with seeded weights and non-trivial batch
    statistics (running means N(0, 0.1), variances U(0.05, 2), scales
    U(0.5, 1.5)), drawn on the CPU from ``torch.Generator(seed)``."""
    from ..models.compnet import CompNet
    gen = torch.Generator().manual_seed(seed)
    net = CompNet(in_dims, out_dims)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) * 1.95 + 0.05)
            elif name.endswith("running_mean") or name.endswith("bias"):
                t.normal_(0.0, 0.1, generator=gen)
            elif t.dim() == 2:                       # Linear weight
                t.normal_(0.0, t.shape[1] ** -0.5, generator=gen)
            else:                                     # BatchNorm scale
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    return net.eval()


def render_ridge_image(rng: np.random.Generator, h: int = 512, w: int = 512,
                       spacing: float = 9.0, block: int = 16,
                       noise_sigma: float = 12.0):
    """A ridge-wave image [h, w] in [0, 255] and its orientation field
    [ceil(h / block), ceil(w / block)]: the port's copy of the JAX
    package's ``training/synthetic_data.render_ridge_image``, draw for
    draw. A smooth random normal field, its phase integrated by an FFT
    Poisson solve (with the mean gradient split off), rendered as the
    ridge / valley asymmetric wave of the quality dictionary
    (get_maps.py:271-283), plus Gaussian noise of ``noise_sigma``."""
    from scipy.ndimage import gaussian_filter, zoom
    blkH, blkW = -(-h // block), -(-w // block)
    smooth = 5
    vx = gaussian_filter(rng.standard_normal((blkH, blkW)), smooth)
    vy = gaussian_filter(rng.standard_normal((blkH, blkW)), smooth)
    vx = zoom(vx, block, order=1)[:h, :w]
    vy = zoom(vy, block, order=1)[:h, :w]
    vn = np.sqrt(vx * vx + vy * vy) + 1e-9
    vx, vy = vx / vn, vy / vn
    theta = np.arctan2(vy, vx) - np.pi / 2
    sp = float(np.round(spacing))
    gx = (2 * np.pi / sp) * vx
    gy = (2 * np.pi / sp) * vy
    gx0, gy0 = float(gx.mean()), float(gy.mean())
    ky = np.fft.fftfreq(h)[:, None] * 2 * np.pi
    kx = np.fft.fftfreq(w)[None, :] * 2 * np.pi
    k2 = kx * kx + ky * ky
    k2[0, 0] = 1.0
    div_hat = (1j * kx * np.fft.fft2(gx - gx0)
               + 1j * ky * np.fft.fft2(gy - gy0))
    phi = np.real(np.fft.ifft2(-div_hat / k2))
    yy0, xx0 = np.mgrid[0:h, 0:w].astype(np.float64)
    phi = phi + gx0 * xx0 + gy0 * yy0
    dist = phi * sp / (2 * np.pi)
    valley = max(2.0, np.floor(sp / 2) - 1)
    ridge = sp - valley
    x_off = np.remainder(dist, sp)
    y1 = np.where(x_off <= ridge, x_off, 0.0)
    y2 = np.where(x_off > ridge, x_off - ridge, 0.0)
    img = -np.sin(2 * np.pi * (y1 / ridge / 2.0)) \
        + np.sin(2 * np.pi * (y2 / valley / 2.0))
    img = (img * 0.5 + 0.5) * 255.0
    if noise_sigma > 0:
        img = img + rng.standard_normal((h, w)) * noise_sigma
    return np.clip(img, 0, 255), theta


def random_flax_variables(net, seed: int, gains=None) -> dict:
    """Seeded Flax-layout variables (numpy, nested) for the architecture of
    ``net`` (a port net with ``flax_modules()``): kernels N(0, 1 / fan_in)
    (times ``gains[path]`` for the Flax module paths it names), biases
    N(0, 0.05), BatchNorm scales U(0.5, 1.5), biases N(0, 0.1), running
    means N(0, 0.1) and variances U(0.5, 2)."""
    from ..models.weights import flatten, to_flax, unflatten
    rng = np.random.default_rng(seed)
    gains = gains or {}
    flat = flatten(to_flax(net))
    for key in sorted(flat):
        shape = flat[key].shape
        coll, *path, leaf = key.split("/")
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) * gains.get("/".join(path), 1.0) \
                / np.sqrt(fan_in)
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 2.0, shape)
        elif leaf == "mean" or coll == "params" and "BatchNorm" in path[-1]:
            v = rng.normal(0.0, 0.1, shape)
        else:                                        # conv / dense bias
            v = rng.normal(0.0, 0.05, shape)
        flat[key] = v.astype(np.float32)
    return unflatten(flat)


# the minutiae nets' last deconv at 4x: seeded nets then put peaks above the
# rolled threshold (0.15) at every width, and every print yields minutiae
MINUTIAE_GAINS = {"ConvTranspose_0": 4.0}


def random_bundle_variables(seed: int, nf_enh: int = 16, nf_minu: int = 64,
                            widths=(32, 64, 128, 256),
                            patch_types=(2, 8, 11)) -> dict:
    """Seeded Flax-layout variables of every net of a ModelBundle, keyed by
    the config field that names its weight file (full widths by default)."""
    from ..models.compnet import CompNet
    from ..models.descriptor_net import DescriptorNet
    from ..models.enhancement import EnhancementAEC
    from ..models.minutiae_net import MinutiaeAEC, MinutiaeAEC64
    nets = {"EnhancementModel": EnhancementAEC(nf_enh),
            "MinutiaeExtractionModelLatentSTFT": MinutiaeAEC(nf_minu),
            "MinutiaeExtractionModel": MinutiaeAEC(nf_minu),
            "MinutiaeExtractionModelRolled": MinutiaeAEC64(nf_minu),
            "DimensionalityReductionModel": CompNet()}
    for pt in patch_types:
        nets[f"DescriptorModelPatch{pt}"] = DescriptorNet(64, widths)
    return {key: random_flax_variables(
                net, seed + i, MINUTIAE_GAINS if "Minutiae" in key else None)
            for i, (key, net) in enumerate(nets.items())}


def write_bundle_npz(directory: str, variables: dict) -> dict:
    """Each net's variables as ``directory/<field>.npz``; -> {config
    field: path}."""
    import os
    from ..models.weights import save_npz
    os.makedirs(directory, exist_ok=True)
    paths = {}
    for key, tree in variables.items():
        paths[key] = os.path.join(directory, key + ".npz")
        save_npz(paths[key], tree)
    return paths


class PassThroughEnhancement(torch.nn.Module):
    """A stand-in for a trained enhancement net: tanh of a 1 x 1
    convolution of weight ``gain``, so ``ModelBundle.enhance`` returns its
    input's ridges saturated toward black and white, as a trained net's
    output is. Seeded weights make the autoencoder's output noise, whose
    dictionary quality (~0.03) never reaches the latent mask's 0.45; with
    this in its place the mask, the Gabor stage and the texture template
    see ridges."""

    def __init__(self, gain: float = 8.0):
        super().__init__()
        self.conv = torch.nn.Conv2d(1, 1, 1, bias=False)
        with torch.no_grad():
            self.conv.weight.fill_(gain)

    def forward(self, x):
        return torch.tanh(self.conv(x))


def latent_image(rng: np.random.Generator, rolled: np.ndarray, h: int,
                 w: int, contrast: float = 0.35,
                 noise_sigma: float = 20.0) -> np.ndarray:
    """A partial, low-contrast crop of a rolled print [h, w] (uint8), as a
    latent: the crop at a random offset (zero-padded where the print is
    smaller), its ridges scaled by ``contrast`` about mid-grey inside a
    random ellipse covering about half of it, flat grey outside, plus
    Gaussian noise."""
    rh, rw = rolled.shape
    canvas = np.full((max(h, rh), max(w, rw)), 128.0)
    canvas[:rh, :rw] = rolled
    y0 = int(rng.integers(0, canvas.shape[0] - h + 1))
    x0 = int(rng.integers(0, canvas.shape[1] - w + 1))
    crop = canvas[y0:y0 + h, x0:x0 + w]
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(0.35, 0.65) * h, rng.uniform(0.35, 0.65) * w
    ry, rx = rng.uniform(0.3, 0.4) * h, rng.uniform(0.3, 0.4) * w
    inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    img = np.where(inside, 128.0 + (crop - 128.0) * contrast, 128.0)
    img = img + rng.standard_normal((h, w)) * noise_sigma
    return np.round(np.clip(img, 0, 255)).astype(np.uint8)
