"""The port's training path against the JAX package on the CPU: the
cylinder targets, the synthetic data (same seed, same draws), the losses,
the augment given JAX's draws, one train-mode step of each pipeline net
(outputs, gradients, the new batch statistics against Flax's mutable
update), Adam given JAX's gradients against optax, the sharded step on two
gloo ranks against the unsharded step, checkpoints, datasets, markup,
evaluate, show, and ``pretrain.main`` end to end with its weight files
read back by ``ModelBundle.initialize``.

Tolerances (u = 2^-24):
- the cylinder: atol 1e-5; the losses rtol 1e-5; the augment atol 1e-4;
- the synthetic images: equal where both packages run the same NumPy; the
  STFT within test_torch_latent's per-pixel reconstruction bound carried
  through the normalization, the cartoon texture and local contrast
  within test_torch_extract's bounds; a Gabor rendition within
  4 * 255 * S * d / (hi - lo) (S the largest kernel's l1 norm, d the
  input's difference, hi - lo the filtered image's range: the linear
  filter, then the min-max scaling); a patch within 1.3 / 128 of its
  rendition's difference (a convex interpolation, the contrast jitter <=
  1.3, the / 128);
- the train-mode nets: every compared array within 2 K u max|array|, K the
  sums' length along the step: the forward's dot lengths (in * kh * kw of
  every layer) added up, plus the longest weight-gradient sum (batch x
  output pixels). Batch statistics and outputs against their own largest
  value; each gradient leaf within 2 K u min(c max|leaf|, max|any
  gradient|), c the largest E[x^2] / var of the BatchNorms' channels (the
  E[x^2] - E[x]^2 variance magnifies its sums' rounding by c, which XLA's
  sums on the CPU show); a conv or dense bias whose exact gradient is 0
  (it reaches the loss through BatchNorms only, shown by an f64 step)
  within 2 K u max|any gradient| of 0, its computed value being rounding
  alone;
- Adam: within 4 u |p| + 32 u lr per step taken of optax's parameters
  (an update is about ten rounded operations a side, and the moments
  carry their rounding from step to step);
- the sharded step: its losses, the first step's gradients (leaf by
  leaf) and the new batch statistics within the rules above of the
  unsharded step's; each step's parameters within the Adam rule of Adam
  replayed in f64 on the sharded run's own gradients.
"""
import copy
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from msu_latentafis_tpu import models as jmod
from msu_latentafis_tpu.models.minutiae_net import MinutiaeAEC64 as JAEC64
from msu_latentafis_tpu.ops import contrast as jc
from msu_latentafis_tpu.ops import cylinder as jcyl
from msu_latentafis_tpu.ops import fft as jf
from msu_latentafis_tpu.ops import gabor as jg
from msu_latentafis_tpu.training import augment as jaug
from msu_latentafis_tpu.training import losses as jl
from msu_latentafis_tpu.training import synthetic_data as jsd
from msu_latentafis_tpu_torch.models import weights
from msu_latentafis_tpu_torch.models.compnet import CompNet
from msu_latentafis_tpu_torch.models.descriptor_net import DescriptorNet
from msu_latentafis_tpu_torch.models.enhancement import EnhancementAEC
from msu_latentafis_tpu_torch.models.minutiae_net import (
    MinutiaeAEC, MinutiaeAEC64, MinutiaeUNet)
from msu_latentafis_tpu_torch.ops import cylinder as tcyl
from msu_latentafis_tpu_torch.ops import fft as tf
from msu_latentafis_tpu_torch.ops import gabor as tg
from msu_latentafis_tpu_torch.training import augment as taug
from msu_latentafis_tpu_torch.training import losses as tl
from msu_latentafis_tpu_torch.training import pretrain
from msu_latentafis_tpu_torch.training import synthetic_data as tsd
from msu_latentafis_tpu_torch.training.trainer import (
    create_train_state, l2_train_step, make_sharded_train_step,
    make_train_mesh, normalized, standard_layout, triplet_train_step)
from msu_latentafis_tpu_torch.utils.synthetic import random_flax_variables
from test_torch_latent import stft_bound


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _uncached_dft_mats(monkeypatch):
    """The JAX package's ``ops.fft._dft_mats`` caches arrays made while a
    jit traces; a second image shape then reads the first trace's tracers
    (ROADMAP Queue 3): the same matrices, uncached, here."""
    monkeypatch.setattr(jf, "_dft_mats", jf._dft_mats.__wrapped__)


U = 2.0 ** -24
U64 = 2.0 ** -53


def jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def npy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= tol), (float(err.max()), float(np.min(tol)))


# ---------------------------------------------------------------------------
# cylinder, synthetic data
# ---------------------------------------------------------------------------

def test_cylinder_matches_jax():
    rng = np.random.default_rng(0)
    m = np.stack([rng.uniform(-5, 60, 40), rng.uniform(-5, 50, 40),
                  rng.uniform(-1.0, 7.5, 40)], axis=1).astype(np.float32)
    m[3, 0] = -2.0                       # off the image: contributes nothing
    for n in (0, 1, 40):
        got = tcyl.make_cylinder_target(m[:n], 48, 56, max_minutiae=64)
        want = np.asarray(jcyl.make_cylinder_target(m[:n], 48, 56,
                                                    max_minutiae=64))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.shape == (48, 56, 12) and got.max() > 0.5
    np.testing.assert_allclose(got, tsd.cylinder_target_np(m, 48, 56),
                               rtol=0, atol=1e-5)


def stft_tol(img: np.ndarray) -> float:
    """test_torch_latent's STFT bound: the reconstruction's per-pixel
    bound, through the median / std normalization to N(127, 14)."""
    padded = np.pad(np.asarray(img, np.float32), 24)
    h0, w0 = img.shape
    d_rec = float(stft_bound(padded)[24:24 + h0, 24:24 + w0].max())
    rec = tf._stft_core(torch.as_tensor(padded)[None])[0][
        24:24 + h0, 24:24 + w0]
    std = float(rec.std(correction=0))
    d_std = d_rec + 2 * rec.numel() * U * std
    return 14 * 2 * d_rec / std + 128 * d_std / std + 8 * 255 * U


def cartoon_tol(n: int) -> float:
    return 4 * n * U * 255 * 255 / 40


CONTRAST_TOL = 4 * 15 * U * 255 * (1 + 0.075 * 127.5)


@pytest.mark.parametrize("preprocess", ["none", "stft", "cartoon"])
def test_minutiae_sample_matches_jax(preprocess):
    """Same seed: the same minutiae and targets, the images equal before
    the preprocessing and within its bound after; the generators end in
    the same state."""
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    img_t, cyl_t, m_t = tsd.synthetic_minutiae_sample(
        ra, size=128, n_minutiae=9, preprocess=preprocess)
    img_j, cyl_j, m_j = jsd.synthetic_minutiae_sample(
        rb, size=128, n_minutiae=9, preprocess=preprocess)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(cyl_t, cyl_j)
    assert ra.bit_generator.state == rb.bit_generator.state
    if preprocess == "none":
        np.testing.assert_array_equal(img_t, img_j)
        return
    raw, _, _ = tsd.synthetic_minutiae_sample(
        np.random.default_rng(5), size=128, n_minutiae=9)
    tol = stft_tol(raw[..., 0]) if preprocess == "stft" else cartoon_tol(128)
    close(img_t, img_j, tol)


def test_latent_and_enhancement_samples_match_jax():
    for fn in ("synthetic_latent_sample", "synthetic_enhancement_sample"):
        ra, rb = np.random.default_rng(8), np.random.default_rng(8)
        for a, b in zip(getattr(tsd, fn)(ra, size=64),
                        getattr(jsd, fn)(rb, size=64)):
            np.testing.assert_array_equal(a, b)
        assert ra.bit_generator.state == rb.bit_generator.state
    a = tsd.random_orientation_field(np.random.default_rng(2), 6, 7)
    np.testing.assert_array_equal(
        a, jsd.random_orientation_field(np.random.default_rng(2), 6, 7))


def jax_renditions(rng, big, sp):
    """The JAX package's renditions of one finger, drawn in its order (its
    ``synthetic_descriptor_batch`` computes them inline)."""
    base, theta = jsd.render_ridge_image(rng, big, big, spacing=sp,
                                         noise_sigma=0.0)
    noisy = np.clip(base + rng.standard_normal(base.shape) * 10, 0, 255)
    lifted = jsd.add_latent_clutter(rng, noisy,
                                    strength=float(rng.uniform(0.4, 1.0)))
    cartoon_l = np.asarray(jf.fast_cartoon_texture(lifted), np.float64)
    contrast_l = np.asarray(jc.local_contrast_enhancement_gaussian(lifted),
                            np.float64)
    bucket, active = jg.gabor_plan_host(theta + np.pi / 2,
                                        np.full((big, big), 1.0 / sp),
                                        (big, big))
    rolled = [noisy, np.asarray(jc.local_contrast_enhancement_gaussian(noisy),
                                np.float64)]
    latent = [np.asarray(jf.stft_enhance(lifted), np.float64), cartoon_l,
              jg.gabor_apply_host(contrast_l, bucket, active).astype(
                  np.float64),
              jg.gabor_apply_host(cartoon_l, bucket, active).astype(
                  np.float64)]
    return rolled, latent, lifted, (bucket, active), (contrast_l, cartoon_l)


def gabor_tol(img, bucket, active, d_in: float) -> float:
    """4 * 255 * S * d / (hi - lo) for the host Gabor filtering of ``img``
    (module docstring)."""
    from scipy.signal import fftconvolve
    bank = tg.get_gabor_filters(3, 30).reshape(-1, tg.KMAX, tg.KMAX)
    used = np.unique(bucket[active])
    s = max(float(np.abs(bank[int(b)]).sum()) for b in used)
    enh = np.zeros_like(img)
    for b in used:
        sel = (bucket == b) & active
        enh[sel] = fftconvolve(img, bank[int(b)][::-1, ::-1],
                               mode="same")[sel]
    return 4 * 255 * s * d_in / float(enh.max() - enh.min())


def test_descriptor_batch_matches_jax():
    """One finger (4 ids x 3 samples): equal labels and draws; every
    rendition within its bound; every patch within 1.3 / 128 of the
    largest rendition difference."""
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    x_t, y_t = tsd.synthetic_descriptor_batch(ra, n_ids=4, samples_per_id=3)
    x_j, y_j = jsd.synthetic_descriptor_batch(rb, n_ids=4, samples_per_id=3)
    np.testing.assert_array_equal(y_t, y_j)
    assert ra.bit_generator.state == rb.bit_generator.state
    assert x_t.shape == (12, 96, 96, 1)

    # the renditions, each package drawing its own copy of the stream
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    sp = float(np.round(ra.uniform(8, 10.5)))
    assert sp == float(np.round(rb.uniform(8, 10.5)))
    rolled, latent = tsd.finger_renditions(ra, 256, sp)
    j_rolled, j_latent, lifted, plan, (j_contrast, j_cartoon) = \
        jax_renditions(rb, 256, sp)
    assert ra.bit_generator.state == rb.bit_generator.state
    np.testing.assert_array_equal(rolled[0], j_rolled[0])
    d = [0.0] + [float(np.abs(a - b).max()) for a, b in
                 zip(rolled[1:] + latent, j_rolled[1:] + j_latent)]
    assert d[1] <= CONTRAST_TOL, d
    assert d[2] <= stft_tol(lifted.astype(np.float32)), d
    assert d[3] <= cartoon_tol(256), d
    assert d[4] <= gabor_tol(j_contrast, *plan, CONTRAST_TOL), d
    assert d[5] <= gabor_tol(j_cartoon, *plan, cartoon_tol(256)), d
    close(x_t, x_j, 1.3 * max(d) / 128 + 4 * U)


# ---------------------------------------------------------------------------
# losses, augment
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((12, 16)).astype(np.float32)
    lab = np.array([0, 0, 1, 1, 1, 2, 2, 3, 4, 4, 5, 5])
    lab_one = np.arange(12)                    # no positives: loss 0
    w = rng.standard_normal((16, 6)).astype(np.float32)
    cls = lab % 6
    x1, x2 = (rng.standard_normal((8, 192)).astype(np.float32)
              for _ in range(2))
    y1, y2 = (rng.standard_normal((8, 96)).astype(np.float32)
              for _ in range(2))
    mu, lv, tgt = (rng.standard_normal((8, 5)).astype(np.float32)
                   for _ in range(3))
    T = torch.as_tensor
    cases = [
        ("l2_reconstruction", (emb, emb[::-1].copy()), {}),
        ("_pairwise_sq_dists", (emb,), {}),
        ("batch_hard_triplet", (emb, lab), {}),
        ("batch_hard_triplet", (emb, lab_one), {}),
        ("batch_hard_triplet", (emb, lab), {"margin": 5.0}),
        ("batch_all_triplet", (emb, lab), {}),
        ("batch_all_triplet", (emb, lab), {"margin": 0.0}),
        ("angular_margin_softmax", (emb, w, cls), {}),
        ("angular_margin_softmax", (emb, w, cls), {"m": 2}),
        ("classification_loss", (emb[:, :6], cls), {}),
        ("regression_loss", (y1, y2), {}),
        ("l2norm_pair_loss", (x1, x2, y1, y2), {}),
        ("l2norm_pair_loss", (x1, x2, x1, x2), {}),
        ("batch_hard_pair_l2norm", (x1, x2, y1, y2), {}),
        ("batch_hard_pair_l2norm", (x1, x2, y1, y2),
         {"metric": "euclidean", "threshold": 0.5}),
        ("batch_hard_pair_l2norm", (x1, x2, x1, x2), {"metric": "euclidean"}),
        ("uncertainty_loss", (mu, lv, tgt), {"wsigma": 0.3}),
    ]
    for name, args, kw in cases:
        got = getattr(tl, name)(*[T(a) for a in args], **kw)
        want = np.asarray(getattr(jl, name)(*[jnp.asarray(a) for a in args],
                                            **kw))
        # the squared distances cancel on the diagonal: there the scale is
        # the terms' (|a|^2 + |b|^2), so atol 1e-5 of the largest
        atol = 1e-5 * float(np.abs(want).max()) if name.startswith("_") \
            else 1e-7
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol,
                                   err_msg=f"{name} {kw}")
    with pytest.raises(ValueError):
        tl.batch_hard_pair_l2norm(T(x1), T(x2), T(y1), T(y2), metric="l1")


def test_augment_apply_matches_jax_given_its_draws():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (150, 140, 1)).astype(np.float32)
    tgt = rng.standard_normal((150, 140, 12)).astype(np.float32)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = jaug.make_training_pair(key, jnp.asarray(img), jnp.asarray(tgt),
                                       crop=128)
        # JAX's draws, made as make_training_pair makes them
        k1, k2 = jax.random.split(key)
        ky, kx = jax.random.split(k1)
        kb, kc, ks = jax.random.split(k2, 3)
        d = taug.Draws(int(jax.random.randint(ky, (), 0, 150 - 128 + 1)),
                       int(jax.random.randint(kx, (), 0, 140 - 128 + 1)),
                       float(jax.random.uniform(kb, ())),
                       float(jax.random.uniform(kc, ())),
                       int(jax.random.randint(ks, (), 0, 4)))
        got = taug.apply_training_pair(torch.as_tensor(img),
                                       torch.as_tensor(tgt), d, crop=128)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(taug._gauss_bank(),
                                  np.asarray(jaug._gauss_kernel(0)))
    gen = torch.Generator().manual_seed(0)
    draws = [taug.draw(gen, 150, 140, 128) for _ in range(50)]
    assert {d.kernel for d in draws} == {0, 1, 2, 3}
    assert all(0 <= d.y0 <= 22 and 0 <= d.x0 <= 12 for d in draws)
    again = taug.draw(torch.Generator().manual_seed(0), 150, 140, 128)
    assert again == draws[0]
    x, t = taug.make_training_pair(torch.Generator().manual_seed(0),
                                   torch.as_tensor(img), torch.as_tensor(tgt))
    assert x.shape == (128, 128, 1) and t.shape == (128, 128, 12)


# ---------------------------------------------------------------------------
# train mode: one step of each pipeline net against Flax
# ---------------------------------------------------------------------------

def dot_lengths(net) -> list:
    out = []
    for m in net.modules():
        if isinstance(m, torch.nn.ConvTranspose2d):
            out.append(m.weight[:, 0].numel())
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            out.append(m.weight[0].numel())
    return out


def sums_k(net, x_shape, out_shape) -> int:
    """The forward's dot lengths added up, plus the longest weight-gradient
    sum (batch x output pixels at the input's resolution, or the rows of a
    dense net)."""
    longest = x_shape[0] * int(np.prod(x_shape[2:])) if len(x_shape) == 4 \
        else x_shape[0]
    longest = max(longest, out_shape[0] * int(np.prod(out_shape[2:])))
    return sum(dot_lengths(net)) + longest


def flax_grads(net) -> dict:
    """The port net's parameter gradients in the Flax layout, flat."""
    flat = {}
    for path, mod in net.flax_modules().items():
        for coll, leaf, attr, _, to_flax in weights._leaves(mod):
            t = getattr(mod, attr)
            if coll != "params" or t is None:
                continue
            g = t.grad.numpy()
            flat[f"params/{path}/{leaf}"] = to_flax(g) if to_flax else g
    return flat


def flax_names(net) -> dict:
    """Parameter name -> its Flax key."""
    names = {id(m): n for n, m in net.named_modules()}
    return {f"{names[id(mod)]}.{attr}": f"params/{path}/{leaf}"
            for path, mod in net.flax_modules().items()
            for coll, leaf, attr, _, _ in weights._leaves(mod)
            if coll == "params"}


def grads_by_name(net) -> dict:
    return {n: p.grad.detach().double().numpy()
            for n, p in net.named_parameters()}


def bias_names(net) -> set:
    """Parameter names of the conv and dense biases."""
    return {f"{n}.bias" for n, m in net.named_modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                              torch.nn.Linear)) and m.bias is not None}


def f64_step(net, x, loss_of):
    """A copy of ``net`` in f64 after a train-mode forward and backward of
    ``loss_of`` on ``x``."""
    net64 = copy.deepcopy(net).double().train()
    net64.zero_grad(set_to_none=True)
    loss_of(net64(x.double())).backward()
    return net64.eval()


def bn_condition(net, x) -> float:
    """The largest E[x^2] / var over the channels of the net's BatchNorms
    on a train-mode forward of ``x`` (1 without one): the factor by which
    the E[x^2] - E[x]^2 variance magnifies the rounding of its sums."""
    from msu_latentafis_tpu_torch.models.batchnorm import _FlaxBatchNorm
    conds = [1.0]

    def hook(mod, args, out):
        a = args[0].double()
        axes = [0] + list(range(2, a.dim()))
        mean2 = (a * a).mean(axes)
        conds.append(float((mean2 / (mean2 - a.mean(axes) ** 2)).max()))
    probe = copy.deepcopy(net).train()
    for m in probe.modules():
        if isinstance(m, _FlaxBatchNorm):
            m.register_forward_hook(hook)
    with torch.no_grad():
        probe(x)
    return max(conds)


def nought(grads64: dict, biases: set, K: int) -> set:
    """The biases whose f64 gradient is within 2 K u64 max|any gradient| of
    0: their exact gradient is 0, as their layer reaches the loss only
    through BatchNorms (sums pass a per-channel shift on, and a BatchNorm
    subtracts it with the batch mean)."""
    gmax = max(float(np.abs(v).max()) for v in grads64.values())
    return {k for k in biases
            if float(np.abs(grads64[k]).max()) <= 2 * K * U64 * gmax}


def check_grads(got: dict, want: dict, tol: float, c: float,
                zero: set) -> None:
    """Each gradient within ``tol`` min(c max|its own reference|, max|any
    reference gradient|). A key of ``zero`` (a bias of exact gradient 0,
    computed as rounding alone) within ``tol`` max|any reference gradient|
    of 0, on both sides."""
    assert set(got) == set(want) and zero < set(want)
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        if k in zero:
            worst = max(float(np.abs(got[k]).max()),
                        float(np.abs(want[k]).max()))
            assert worst <= tol * gmax, (k, worst)
        else:
            close(got[k], want[k],
                  tol * min(c * float(np.abs(want[k]).max()), gmax))


def jax_step_parts(jnet, variables, x, loss_of, dtype=np.float32):
    """Flax's train-mode forward, the loss's gradients and the mutable
    batch statistics, in ``dtype`` (f64 inside ``jax.enable_x64``)."""
    v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), variables)

    def loss_fn(params):
        out, upd = jnet.apply({"params": params,
                               "batch_stats": v["batch_stats"]},
                              jnp.asarray(x, dtype), train=True,
                              mutable=["batch_stats"])
        return loss_of(out), (out, upd)
    (loss, (out, upd)), g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    return (float(loss), np.asarray(out),
            weights.flatten({"params": npy(g)}),
            weights.flatten({"batch_stats": npy(upd["batch_stats"])}))


def nhwc(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


NET_CASES = {
    "MinutiaeAEC": (lambda: MinutiaeAEC(8), lambda: jmod.MinutiaeAEC(nf=8),
                    (4, 64, 64, 1), "l2"),
    "MinutiaeAEC64": (lambda: MinutiaeAEC64(8), lambda: JAEC64(nf=8),
                      (4, 48, 48, 1), "l2"),
    "MinutiaeUNet": (lambda: MinutiaeUNet(4), lambda: jmod.MinutiaeUNet(nf=4),
                     (4, 64, 64, 1), "l2"),
    "EnhancementAEC": (lambda: EnhancementAEC(4),
                       lambda: jmod.EnhancementAEC(nf=4), (4, 64, 64, 1),
                       "l2"),
    "DescriptorNet": (lambda: DescriptorNet(16, (4, 8)),
                      lambda: jmod.DescriptorNet(embedding_size=16,
                                                 widths=(4, 8)),
                      (8, 96, 96, 1), "triplet"),
    "CompNet": (lambda: CompNet(), lambda: jmod.CompNet(), (32, 192),
                "compnet"),
}
LABELS = np.repeat(np.arange(4), 2)


def losses_for(kind, x, y):
    """(JAX loss of the output, port loss of the output)."""
    if kind == "l2":
        yt = torch.as_tensor(y).permute(0, 3, 1, 2)
        return (lambda o: jl.l2_reconstruction(o, jnp.asarray(y)),
                lambda o: tl.l2_reconstruction(o, yt))
    if kind == "triplet":
        return (lambda o: jl.batch_hard_triplet(
                    o / (jnp.linalg.norm(o, axis=1, keepdims=True) + 1e-8),
                    jnp.asarray(LABELS)),
                lambda o: tl.batch_hard_triplet(normalized(o),
                                                torch.as_tensor(LABELS)))
    xn = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-8)

    def jax_loss(z):
        zn = z / (jnp.linalg.norm(z, axis=1, keepdims=True) + 1e-8)
        return jnp.mean((zn @ zn.T - xn @ xn.T) ** 2)
    return jax_loss, lambda z: pretrain.cosine_structure_loss(
        z, torch.as_tensor(x))


@pytest.mark.parametrize("name", list(NET_CASES))
def test_train_mode_step_matches_flax(name):
    make, jmake, shape, kind = NET_CASES[name]
    rng = np.random.default_rng(len(name))
    net = make()
    variables = random_flax_variables(net, 7)
    weights.load_flax(net, variables)
    x = rng.standard_normal(shape).astype(np.float32)
    jnet = jmake()
    y = None
    if kind == "l2":
        out_shape = jax.eval_shape(lambda v: jnet.apply(v, jnp.asarray(x)),
                                   jx(variables)).shape
        y = np.abs(rng.standard_normal(out_shape)).astype(np.float32)
    jloss, tloss = losses_for(kind, x, y)
    loss_j, out_j, g_j, bs_j = jax_step_parts(jnet, variables, x, jloss)

    xt = torch.as_tensor(x)
    xt = standard_layout(xt.permute(0, 3, 1, 2)) if xt.dim() == 4 else xt
    net.train()
    out = net(xt)
    loss = tloss(out)
    loss.backward()
    net.eval()
    K = sums_k(net, tuple(xt.shape), tuple(out.shape))
    close(nhwc(out), out_j, 2 * K * U * float(np.abs(out_j).max()))
    assert abs(float(loss.detach()) - loss_j) <= 2 * K * U * abs(loss_j)
    # the gradients leaf by leaf, within 2 K u min(c max|leaf|, max|any
    # gradient|) (c the BatchNorms' condition); the biases whose f64
    # gradient is nought within 2 K u max|any gradient| of 0
    x64 = x.astype(np.float64)
    y64 = None if y is None else y.astype(np.float64)
    g_t64 = flax_grads(f64_step(net, xt, losses_for(kind, x64, y64)[1]))
    names = flax_names(net)
    zero = nought(g_t64, {names[b] for b in bias_names(net)}, K)
    check_grads(flax_grads(net), g_j, 2 * K * U, bn_condition(net, xt),
                zero)
    bs_t = weights.flatten({"batch_stats": weights.to_flax(net)
                            ["batch_stats"]})
    assert set(bs_t) == set(bs_j)
    for k in bs_j:
        close(bs_t[k], bs_j[k], 2 * K * U * float(np.abs(bs_j[k]).max()))
    # the running variance moved as Flax moves it: 0.99 old + 0.01 biased
    # batch variance, not torch's 0.9 old + 0.1 unbiased
    old = weights.flatten({"batch_stats": variables["batch_stats"]})
    k = next(iter(bs_j))
    moved = np.abs(bs_j[k] - old[k]).max()
    assert 0 < moved < 0.05 * max(float(np.abs(old[k]).max()), 1.0)


def test_eval_mode_unchanged_by_training_batchnorm():
    """Eval mode runs ``nn.BatchNorm2d.forward`` on the running statistics,
    the same bits as a plain BatchNorm."""
    from msu_latentafis_tpu_torch.models.batchnorm import FlaxBatchNorm2d
    bn = FlaxBatchNorm2d(5)
    ref = torch.nn.BatchNorm2d(5, eps=1e-5)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in (bn, ref):
            t.weight.copy_(torch.rand(5, generator=torch.Generator()
                                      .manual_seed(1)) + 0.5)
            t.running_var.copy_(torch.rand(5, generator=torch.Generator()
                                           .manual_seed(2)) + 0.5)
    x = torch.randn(3, 5, 7, 6, generator=gen)
    assert torch.equal(bn.eval()(x), ref.eval()(x))


# ---------------------------------------------------------------------------
# Adam, steps
# ---------------------------------------------------------------------------

def test_adam_update_matches_optax_given_the_same_gradients():
    import optax
    net = DescriptorNet(16, (4, 8))
    variables = random_flax_variables(net, 3)
    weights.load_flax(net, variables)
    params = jx(variables["params"])
    rng = np.random.default_rng(4)
    tx = optax.adam(1e-4, b1=0.5, b2=0.9)
    opt = tx.init(params)
    update = jax.jit(tx.update)
    state = create_train_state(net)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape)
                                  * 10.0 ** rng.integers(-8, 2),
                                  jnp.float32), params)
        upd, opt = update(grads, opt, params)
        params = optax.apply_updates(params, upd)
        gflat = weights.flatten({"params": npy(grads)})
        for path, mod in net.flax_modules().items():
            for coll, leaf, attr, to_torch, _ in weights._leaves(mod):
                if coll != "params" or getattr(mod, attr) is None:
                    continue
                g = gflat[f"params/{path}/{leaf}"]
                g = to_torch(g) if to_torch else g
                getattr(mod, attr).grad = torch.tensor(np.array(g))
        state.tx.step()
        want = weights.flatten({"params": npy(params)})
        got = weights.flatten({"params": weights.to_flax(net)["params"]})
        for k in want:
            close(got[k], want[k],
                  4 * U * np.abs(want[k]) + 32 * U * 1e-4 * (step + 1))


@pytest.mark.parametrize("name,tf32", [("highest", False), ("float32", False),
                                       ("F32_F32_F32", False),
                                       ("tensorfloat32", True),
                                       ("default", True), ("bogus", None)])
def test_step_precision_follows_jax_names(monkeypatch, name, tf32):
    """PRETRAIN_PRECISION as jax_default_matmul_precision reads it: full f32
    names keep TF32 off, lower ones allow it, unknown ones raise."""
    from msu_latentafis_tpu_torch.training.trainer import step_precision
    monkeypatch.setenv("PRETRAIN_PRECISION", name)
    if tf32 is None:
        with pytest.raises(ValueError, match="PRETRAIN_PRECISION"):
            step_precision()
        return
    old = torch.backends.cudnn.allow_tf32
    with step_precision():
        assert torch.backends.cudnn.allow_tf32 is tf32
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    assert torch.backends.cudnn.allow_tf32 is old


def test_five_l2_steps_lower_the_loss():
    rng = np.random.default_rng(1)
    with weights.seeded(1):
        net = MinutiaeAEC(4)
    x = torch.as_tensor(rng.standard_normal((4, 1, 64, 64)), dtype=torch.float32)
    y = torch.relu(torch.as_tensor(rng.standard_normal((4, 12, 64, 64)),
                                   dtype=torch.float32))
    state = create_train_state(net)
    _, loss0 = l2_train_step(state, x, y)
    for _ in range(5):
        state, loss = l2_train_step(state, x, y)
    assert float(loss) < float(loss0) and state.step == 6
    assert not net.training
    with weights.seeded(2):
        dnet = DescriptorNet(16, (4, 8))
    xd = torch.as_tensor(rng.standard_normal((8, 1, 96, 96)),
                         dtype=torch.float32)
    state = create_train_state(dnet)
    _, loss = triplet_train_step(state, xd, torch.as_tensor(LABELS))
    assert np.isfinite(float(loss))


# ---------------------------------------------------------------------------
# the sharded step on two gloo ranks
# ---------------------------------------------------------------------------

SHARD_STEPS = 2


def shard_case(kind):
    """(net, Flax variables, x, y) of one sharded-step case."""
    rng = np.random.default_rng(21 if kind == "l2" else 22)
    if kind == "l2":
        net = MinutiaeAEC(8)
        x = rng.standard_normal((4, 1, 64, 64)).astype(np.float32)
        y = np.abs(rng.standard_normal((4, 12, 64, 64))).astype(np.float32)
    else:
        net = DescriptorNet(16, (8, 16))
        x = rng.standard_normal((8, 1, 96, 96)).astype(np.float32)
        y = LABELS.copy()
    variables = random_flax_variables(net, 5)
    weights.load_flax(net, variables)
    return net, x, y


def _shard_worker(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store"), 2), rank=rank, world_size=2)
    out = {}
    try:
        for n_data, n_model in ((2, 1), (1, 2)):
            mesh = make_train_mesh(n_data, n_model, device_type="cpu")
            for kind in ("l2", "triplet"):
                tag = f"{kind}_{n_data}x{n_model}"
                net, x, y = shard_case(kind)
                state, step = make_sharded_train_step(net, mesh, kind)
                # the Flax shape of each leaf as this rank holds it
                for k, v in weights.flatten(
                        {"params": weights.to_flax(net)["params"]}).items():
                    out[f"{tag}/local/{k}"] = np.asarray(v.shape)
                for i in range(SHARD_STEPS):
                    state, loss = step(state, torch.as_tensor(x),
                                       torch.as_tensor(y))
                    out[f"{tag}/loss{i}"] = np.float64(loss)
                    # the whole gradient Adam took, and the parameters after
                    for n, g in state.full_parameters(grads=True).items():
                        out[f"{tag}/grad{i}/{n}"] = g.numpy().copy()
                    for n, p in state.full_parameters().items():
                        out[f"{tag}/param{i}/{n}"] = p.detach().numpy().copy()
                for k, v in weights.flatten(state.variables()).items():
                    if k.startswith("batch_stats/"):
                        out[f"{tag}/{k}"] = v
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_train_shard"))
    mp.start_processes(_shard_worker, args=(root,), nprocs=2, join=True,
                       start_method="spawn")
    return [dict(np.load(os.path.join(root, f"rank{r}.npz")))
            for r in range(2)]


def adam_replay(before: dict, grads: dict, t: int, moments: dict,
                lr: float = 1e-4, b1: float = 0.5, b2: float = 0.9,
                eps: float = 1e-8) -> dict:
    """Adam's step ``t`` (from 1) in f64 from the parameters ``before``
    and the gradients; ``moments`` (name -> (m, v)) carried over."""
    out = {}
    for n, g in grads.items():
        m, v = moments.get(n, (0.0, 0.0))
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        moments[n] = (m, v)
        out[n] = before[n] - lr * (m / (1 - b1 ** t)) / (
            np.sqrt(v / (1 - b2 ** t)) + eps)
    return out


@pytest.mark.parametrize("kind", ["l2", "triplet"])
@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_sharded_step_equals_unsharded(sharded_runs, kind, mesh):
    from msu_latentafis_tpu.training.trainer import _param_spec
    net, x, y = shard_case(kind)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    out_shape = (x.shape[0], 12, 64, 64) if kind == "l2" else (8, 16)
    K = sums_k(net, x.shape, out_shape)
    yt64 = yt.double() if kind == "l2" else yt
    net64 = f64_step(net, xt, (lambda o: tl.l2_reconstruction(o, yt64))
                     if kind == "l2" else
                     (lambda o: tl.batch_hard_triplet(normalized(o), yt)))
    zero = nought(grads_by_name(net64), bias_names(net), K)
    c = bn_condition(net, xt)
    init = {n: p.detach().double().numpy()
            for n, p in net.named_parameters()}
    full = weights.flatten({"params": weights.to_flax(net)["params"]})
    state = create_train_state(net)
    step = l2_train_step if kind == "l2" else triplet_train_step
    ref_losses = []
    for i in range(SHARD_STEPS):
        state, loss = step(state, xt, yt)
        ref_losses.append(float(loss))
        if i == 0:
            ref_grads = grads_by_name(net)
    # one step moves the loss by more than its bound: the check can fail
    assert abs(ref_losses[1] - ref_losses[0]) > \
        2 * K * U * abs(ref_losses[1])
    stats = weights.flatten(state.variables())
    tag = f"{kind}_{mesh}"
    n_model = int(mesh[-1])
    for run in sharded_runs:
        for i, ref in enumerate(ref_losses):
            assert abs(run[f"{tag}/loss{i}"] - ref) <= 2 * K * U * abs(ref)
        # the first step's gradients, leaf by leaf
        check_grads({n: run[f"{tag}/grad0/{n}"] for n in ref_grads},
                    ref_grads, 2 * K * U, c, zero)
        # Adam took those gradients, its moments carried over: each step's
        # parameters from the last within 4 u |p| + 32 u lr (the Adam rule)
        before, moments = init, {}
        for i in range(SHARD_STEPS):
            grads = {n: run[f"{tag}/grad{i}/{n}"].astype(np.float64)
                     for n in init}
            want = adam_replay(before, grads, i + 1, moments)
            before = {n: run[f"{tag}/param{i}/{n}"].astype(np.float64)
                      for n in init}
            for n in init:
                close(before[n], want[n], 4 * U * np.abs(want[n]) + 32 * U
                      * 1e-4)
        for k, v in stats.items():
            if k.startswith("batch_stats/"):
                close(run[f"{tag}/{k}"], v,
                      2 * K * U * float(np.abs(v).max()))
        # each rank holds 1 / n_model of the leaves JAX's rule shards, on
        # their Flax last axis (a ConvTranspose2d's torch dim 1)
        sharded = 0
        for k, v in full.items():
            want = list(v.shape)
            if _param_spec(None, v, n_model) != jax.sharding.PartitionSpec():
                want[-1] //= n_model
                sharded += 1
            assert list(run[f"{tag}/local/{k}"]) == want, k
        assert sharded > 0 or n_model == 1


# ---------------------------------------------------------------------------
# checkpoints, datasets, markup, evaluate, show
# ---------------------------------------------------------------------------

def test_checkpoint_manager_prunes_as_jax(tmp_path):
    from msu_latentafis_tpu.training.checkpoints import CheckpointManager \
        as JaxManager
    from msu_latentafis_tpu_torch.training.checkpoints import \
        CheckpointManager
    net = CompNet()
    v = weights.to_flax(net)
    seq = [(1, 5.0), (2, 3.0), (3, 4.0), (4, 6.0), (5, None), (6, 2.5),
           (7, 9.0)]
    port = CheckpointManager(str(tmp_path / "port"), keep=2)
    jaxm = JaxManager(str(tmp_path / "jax"), keep=2)
    for step, metric in seq:
        port.save(step, v, metric=metric)
        jaxm.save(step, jx(v), metric=metric)
        assert port._meta() == jaxm._meta()
    kept = sorted(f for f in os.listdir(tmp_path / "port") if f != "meta.json")
    assert kept == [f"step_{s:08d}.npz" for s in (6, 7)]
    assert sorted(os.listdir(tmp_path / "jax")) == ["meta.json"] + [
        f"step_{s:08d}" for s in (6, 7)]
    assert port.latest_step() == 7
    got = port.restore(v)
    for a, b in zip(weights.flatten(got).values(),
                    weights.flatten(v).values()):
        np.testing.assert_array_equal(a, b)
    assert port.restore_best(v) is not None
    with pytest.raises(ValueError):
        port.restore(weights.to_flax(CompNet(192, 48)))
    empty = CheckpointManager(str(tmp_path / "empty"))
    assert empty.restore("target") == "target"


def test_datasets_match_jax(tmp_path):
    from msu_latentafis_tpu.training import datasets as jd
    from msu_latentafis_tpu_torch.training import datasets as td
    from msu_latentafis_tpu_torch.utils.image_io import write_bmp, write_png
    rng = np.random.default_rng(0)
    for cls in ("a", "b"):
        (tmp_path / cls).mkdir()
        for i in range(3):
            img = rng.integers(0, 255, (16, 20), np.uint8)
            if i == 2:
                write_bmp(str(tmp_path / cls / f"{i}.bmp"), img)
            else:
                write_png(str(tmp_path / cls / f"{i}.png"), img)
    (tmp_path / "list.txt").write_text("a/0.png 0\nb/1.png 1\n\nb/2.bmp\n")
    (tmp_path / "list.csv").write_text("a/0.png,0\nb/2.bmp,1\n")
    pairs = [(td.FolderListDataset(str(tmp_path)),
              jd.FolderListDataset(str(tmp_path))),
             (td.FileListDataset(str(tmp_path / "list.txt"), str(tmp_path)),
              jd.FileListDataset(str(tmp_path / "list.txt"), str(tmp_path))),
             (td.CsvListDataset(str(tmp_path / "list.csv"), str(tmp_path)),
              jd.CsvListDataset(str(tmp_path / "list.csv"), str(tmp_path)))]
    for a, b in pairs:
        assert a.items == b.items and len(a) == len(b)
        for i in range(len(a)):
            np.testing.assert_array_equal(a[i][0], b[i][0])
            assert a[i][1] == b[i][1]
    ta, tb = td.TripletDataset(pairs[0][0]), jd.TripletDataset(pairs[0][1])
    for x, y in zip(ta.sample(random.Random(0)), tb.sample(random.Random(0))):
        np.testing.assert_array_equal(x, y)
    feats = rng.standard_normal((10, 4))
    for a, b in zip(td.batches(td.FeatArrayDataset(feats), 4,
                               np.random.default_rng(1)),
                    jd.batches(jd.FeatArrayDataset(feats), 4,
                               np.random.default_rng(1))):
        np.testing.assert_array_equal(a, b)
    folder = [(td.batches(pairs[0][0], 2, np.random.default_rng(2),
                          drop_last=False)),
              (jd.batches(pairs[0][1], 2, np.random.default_rng(2),
                          drop_last=False))]
    for a, b in zip(*folder):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    labels = rng.integers(0, 3, 10)
    for a, b in zip(td.FeatPairDataset(feats, labels).sample_pairs(
                        np.random.default_rng(3), 6),
                    jd.FeatPairDataset(feats, labels).sample_pairs(
                        np.random.default_rng(3), 6)):
        np.testing.assert_array_equal(a, b)
    img = pairs[0][0][0][0]
    for name in ("random_crop", "random_flip"):
        args = (8,) if name == "random_crop" else ()
        fa = td.compose(getattr(td, name)(np.random.default_rng(4), *args),
                        td.normalize)
        fb = jd.compose(getattr(jd, name)(np.random.default_rng(4), *args),
                        jd.normalize)
        for _ in range(3):
            np.testing.assert_array_equal(fa(img), fb(img))
    for cls in ("c", "d"):
        (tmp_path / "feat" / cls).mkdir(parents=True)
        for i in range(3):
            np.save(str(tmp_path / "feat" / cls / f"f{i}.npy"),
                    rng.normal(size=(6,)))
    ca = td.ClassPairsDataset(str(tmp_path / "feat"), 3, if_norm=True)
    cb = jd.ClassPairsDataset(str(tmp_path / "feat"), 3, if_norm=True)
    for i in (0, 1, 1, 0, 1):
        np.testing.assert_array_equal(ca[i][0], cb[i][0])


def test_markup_matches_jax(tmp_path):
    import scipy.io
    from msu_latentafis_tpu.training import markup as jm
    from msu_latentafis_tpu_torch.training import markup as tm
    from msu_latentafis_tpu_torch.utils.image_io import write_png
    txt = tmp_path / "m.txt"
    txt.write_text("# x y ori\nx,y,ori\n10 20 1.5 extra\n30,40,0.5\nbad\n"
                   "12 30 6.0\n")
    mat = tmp_path / "m.mat"
    scipy.io.savemat(str(mat), {"note": np.array([[1.0]]),
                                "minutiae": np.array([[5.0, 6.0, 0.25, 9.0],
                                                      [25.0, 16.0, 3.0, 1]])})
    for p in (txt, mat):
        np.testing.assert_array_equal(tm.parse_markup(str(p)),
                                      jm.parse_markup(str(p)))
    bad = tmp_path / "bad.mat"
    scipy.io.savemat(str(bad), {"v": np.array([1.0, 2.0])})
    with pytest.raises(ValueError):
        tm.parse_markup(str(bad))
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (32, 48)).astype(np.float32)
    roi = (rng.random((32, 48)) > 0.5).astype(np.float32)
    m = tm.parse_markup(str(txt))
    for k in range(-1, 6):
        for a, b in zip(tm.rotate_sample(img, m, roi, k),
                        jm.rotate_sample(img, m, roi, k)):
            np.testing.assert_array_equal(a, b)
        im_k, m_k, roi_k = tm.rotate_sample(img, m, roi, k)
        np.testing.assert_array_equal(
            tm.build_training_tensor(im_k, m_k, roi_k),
            jm.build_training_tensor(im_k, m_k, roi_k))
    write_png(str(tmp_path / "a.png"),
              rng.integers(0, 255, (40, 36), np.uint8))
    pairs = [(str(tmp_path / "a.png"), str(txt))]
    for rot, hull in ((True, True), (False, False)):
        a = tm.convert_markup_dataset(pairs, str(tmp_path / f"t{rot}"),
                                      rotate_augment=rot,
                                      roi_from_markup_hull=hull)
        b = jm.convert_markup_dataset(pairs, str(tmp_path / f"j{rot}"),
                                      rotate_augment=rot,
                                      roi_from_markup_hull=hull)
        assert [os.path.basename(f) for f in a] == \
            [os.path.basename(f) for f in b]
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(np.load(fa), np.load(fb))
        again = tm.convert_markup_dataset(pairs, str(tmp_path / f"t{rot}"),
                                          rotate_augment=rot)
        assert again == a


def test_evaluate_matches_jax(tmp_path):
    from msu_latentafis_tpu import evaluate as je
    from msu_latentafis_tpu.evaluate import classification as jcl
    from msu_latentafis_tpu_torch import evaluate as te
    from msu_latentafis_tpu_torch.evaluate import classification as tcl
    rng = np.random.default_rng(0)
    scores = np.round(rng.standard_normal(200), 2)       # ties
    labels = rng.random(200) < 0.3
    for fn in ("roc_curve",):
        for a, b in zip(getattr(te, fn)(scores, labels),
                        getattr(je, fn)(scores, labels)):
            np.testing.assert_array_equal(a, b)
    assert te.tar_at_far(scores, labels) == je.tar_at_far(scores, labels)
    assert te.eer(scores, labels) == je.eer(scores, labels)
    assert te.verification_metrics(scores, labels) == \
        je.verification_metrics(scores, labels)
    sm = rng.standard_normal((12, 30))
    mate = rng.integers(0, 30, 12)
    np.testing.assert_array_equal(te.cumulative_match_curve(sm, mate, 10),
                                  je.cumulative_match_curve(sm, mate, 10))
    assert te.rank_k_accuracy(sm, mate, 5) == je.rank_k_accuracy(sm, mate, 5)
    rel = rng.random((12, 30)) < 0.1
    rel[3] = False
    assert te.mean_average_precision(sm, rel) == \
        je.mean_average_precision(sm, rel)
    assert te.mean_average_precision(sm, rel & False) == 0.0
    feats = rng.standard_normal((20, 8)).astype(np.float32)
    idx = rng.integers(0, 20, (40, 2))
    same = rng.random(40) < 0.5
    for metric in ("cos_dist", "l2_norm"):
        np.testing.assert_array_equal(te.pair_scores(feats, idx, metric),
                                      je.pair_scores(feats, idx, metric))
        assert te.kfold_verification(feats, idx, same, metric, 5) == \
            je.kfold_verification(feats, idx, same, metric, 5)
    s = te.pair_scores(feats, idx)
    assert te.best_threshold_accuracy(s, same) == \
        je.best_threshold_accuracy(s, same)
    assert te.best_threshold_accuracy(s, same, 0.1) == \
        je.best_threshold_accuracy(s, same, 0.1)
    assert te.best_threshold_accuracy(s, same & False) == \
        je.best_threshold_accuracy(s, same & False)
    paths = tmp_path / "paths.txt"
    paths.write_text("\n".join(f"d/p{i}_{j:04d}.png" for i in range(3)
                               for j in range(1, 4)) + "\n")
    pf = tmp_path / "pairs.txt"
    pf.write_text("2\np0 1 2\np1 3 p2 1\nbad line here too much\n")
    ia, ib = te.read_index_dict(str(paths)), je.read_index_dict(str(paths))
    assert ia == ib
    for a, b in zip(te.read_pairs_file(str(pf), ia),
                    je.read_pairs_file(str(pf), ib)):
        np.testing.assert_array_equal(a, b)
    logits = rng.standard_normal((30, 7))
    lab = rng.integers(0, 7, 30)
    assert tcl.topk_accuracy(logits, lab, (1, 3)) == \
        jcl.topk_accuracy(logits, lab, (1, 3))


def test_show_writes_the_jax_figures(tmp_path):
    from msu_latentafis_tpu import show as js
    from msu_latentafis_tpu_torch import show as ts
    from msu_latentafis_tpu_torch.utils.image_io import read_image
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (64, 64))
    mask = np.zeros((64, 64))
    mask[8:50, 10:60] = 1
    mnt = np.array([[20.0, 30.0, 0.5], [40.0, 12.0, 2.0]])
    dir_map = rng.uniform(-np.pi / 2, np.pi / 2, (4, 4))
    dir_map[0, 0] = -10
    calls = [("show_mask", (mask, img)), ("show_mask", (mask,)),
             ("show_image", (img, mask)),
             ("show_minutiae", (img, mnt, mask)),
             ("show_minutiae_sets", (img, [mnt, mnt[:1], np.zeros((0, 3))])),
             ("show_orientation_field", (img, dir_map, mask))]
    for i, (name, args) in enumerate(calls):
        a, b = str(tmp_path / f"t{i}.png"), str(tmp_path / f"j{i}.png")
        getattr(ts, name)(*args, fname=a)
        getattr(js, name)(*args, fname=b)
        np.testing.assert_array_equal(read_image(a), read_image(b))
        assert read_image(a).shape[0] > 64


# ---------------------------------------------------------------------------
# pretrain end to end
# ---------------------------------------------------------------------------

# pretrain's cuts: small pools, the descriptor's steps; its nets at small
# widths (patched into the module)
SMALL = dict(minutiae=dict(pool=6), minutiae64=dict(pool=6),
             enhancement=dict(pool=4), descriptor=dict(steps=2))
SMALL_NETS = dict(MinutiaeAEC=lambda nf: MinutiaeAEC(4),
                  MinutiaeAEC64=lambda nf: MinutiaeAEC64(4),
                  EnhancementAEC=lambda: EnhancementAEC(4),
                  DescriptorNet=lambda: DescriptorNet(16, (4, 8)))


def jax_init_shapes(model, x) -> dict:
    """The paths and shapes of the Flax net's ``init`` variables."""
    v = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                          jnp.zeros(x), train=False))
    out = {}

    def walk(tree, prefix):
        for k, a in tree.items():
            if isinstance(a, dict) or hasattr(a, "items"):
                walk(a, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = tuple(a.shape)
    walk(v, "")
    return out


def test_pretrain_writes_weights_that_extraction_reads(tmp_path, monkeypatch,
                                                       capsys):
    from msu_latentafis_tpu_torch.config import AfisConfig
    from msu_latentafis_tpu_torch.pipeline import ModelBundle
    from msu_latentafis_tpu_torch.scripts import gen_descriptor_pool
    stream = str(tmp_path / "stream")
    assert gen_descriptor_pool.main(
        ["--out", stream, "--max-shards", "2", "--batches-per-shard", "1",
         "--n-ids", "4", "--samples-per-id", "2", "--seed", "1",
         "--device", "cpu"]) == 0
    shards = sorted(os.listdir(stream))
    assert shards == ["shard_w0_000000.npz", "shard_w0_000001.npz"]
    with np.load(os.path.join(stream, shards[0])) as z:
        assert z["x"].shape == (1, 8, 96, 96, 1) and z["y"].shape == (1, 8)
    for name, make in SMALL_NETS.items():
        monkeypatch.setattr(pretrain, name, make)
    monkeypatch.setenv("PRETRAIN_STREAM_DIR", stream)
    monkeypatch.delenv("PRETRAIN_CPU", raising=False)
    out = str(tmp_path / "w")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain.main(["--out", out, "--steps", "2"], **SMALL)
    infos = pretrain.main(["--out", out, "--steps", "2", "--device", "cpu"],
                          **SMALL)
    assert set(infos) == set(pretrain.NETS)
    assert all(len(i["losses"]) == 2 and np.all(np.isfinite(i["losses"]))
               for i in infos.values())
    paths = pretrain.config_paths(out)
    assert sorted(os.listdir(out)) == sorted(f"{n}.npz"
                                             for n in pretrain.FILES)
    want = {
        "MinutiaeExtractionModel": jax_init_shapes(jmod.MinutiaeAEC(nf=4),
                                                   (1, 128, 128, 1)),
        "MinutiaeExtractionModelRolled": jax_init_shapes(JAEC64(nf=4),
                                                         (1, 64, 64, 1)),
        "EnhancementModel": jax_init_shapes(jmod.EnhancementAEC(nf=4),
                                            (1, 64, 64, 1)),
        "DescriptorModelPatch2": jax_init_shapes(
            jmod.DescriptorNet(embedding_size=16, widths=(4, 8)),
            (1, 96, 96, 1)),
        "DimensionalityReductionModel": jax_init_shapes(jmod.CompNet(),
                                                        (2, 192))}
    want["MinutiaeExtractionModelLatentSTFT"] = \
        want["MinutiaeExtractionModel"]
    for pt in (8, 11):
        want[f"DescriptorModelPatch{pt}"] = want["DescriptorModelPatch2"]
    for field, shapes in want.items():
        with np.load(paths[field]) as z:
            assert {k: z[k].shape for k in z.files} == shapes, field
    bundle = ModelBundle.initialize(AfisConfig(**paths), device="cpu")
    assert bundle.descriptors[0].fc.out_features == 16
    assert bundle.minutiae[2].enc[0].conv.out_channels == 4
    with np.load(paths["DimensionalityReductionModel"]) as z:
        np.testing.assert_array_equal(
            z["params/Dense_0/kernel"],
            bundle.compnet.fc_in.weight.detach().numpy().T)

    capsys.readouterr()
    before = dict(np.load(paths["EnhancementModel"]))
    pretrain.main(["--out", out, "--steps", "1", "--device", "cpu",
                   "--which", "enhancement", "--resume"], **SMALL)
    assert f"resumed weights from {paths['EnhancementModel']}" in \
        capsys.readouterr().out
    after = dict(np.load(paths["EnhancementModel"]))
    moved = max(float(np.abs(after[k] - before[k]).max()) for k in before
                if k.startswith("params/"))
    assert 0 < moved <= 2e-4        # one Adam step from the saved weights
    with open(paths["MinutiaeExtractionModelRolled"], "wb") as f:
        f.write(b"not an npz")
    with pytest.raises(Exception):
        pretrain.main(["--out", out, "--steps", "1", "--device", "cpu",
                       "--which", "minutiae64", "--resume"], **SMALL)
    monkeypatch.setenv("PRETRAIN_CPU", "1")
    with pytest.raises(ValueError, match="no cut"):
        pretrain.main(["--out", str(tmp_path / "w2"), "--steps", "1"],
                      compnet=dict(batch=8))
    pretrain.main(["--out", str(tmp_path / "w2"), "--steps", "1",
                   "--which", "compnet"])
    assert os.listdir(tmp_path / "w2") == ["compnet.npz"]
