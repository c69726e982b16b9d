"""The tolerance of the screens the card runs on the tensor cores.

With a bf16 latent side the minutiae screen and the predecoded ADC screen
(bf16 or int8 gallery), with a bf16 codebook the codes ADC screen, and the
experiment's transposed bf16 screen run mma.sync on the card: the products
are exact (an int8 gallery widens to bf16 exactly), but each dot is summed
in the tensor cores' order, not the plain versions' index order. Here the
plain versions are recomputed on the CPU with two other f32 orders,
reversed index order and an mma-like k-step (16-long chunks summed
pairwise, the chunk sums added in order), at the serving prescreen's and
the reference cap's shapes:

- the minutiae screen stays within ops.KERNEL_TOL (rtol 1e-5 / atol 1e-4):
  its maxima are exact in any order and only the dots' roundings move;
- the ADC screens round each row maximum to bf16, so a reordered sum can
  land on the other side of a rounding boundary: a crafted case moves the
  screen by two bf16 ulps, past KERNEL_TOL, and ops.screen_slack covers
  it, as it covers the reordered sums of the codes and predecoded screens;
- the transposed screen keeps f32 maxima, so its reordered dots move by
  the f32 roundings alone, within ops.screen_t_tol; a crafted dot with
  cancellation moves by 2^-8, past KERNEL_TOL.

Then the plain versions against the Pallas kernels in interpret mode where
no other test holds them: the minutiae screen [bf16, int8] at R = 128 and
the bf16 codes screen at the descriptors' D = 96 with Rt = 100, not a
multiple of the 64-column tiles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msu_latentafis_tpu.matcher import pallas_kernels as pk
from msu_latentafis_tpu.matcher.texture_match import block_diag_codebook
from msu_latentafis_tpu_torch.matcher.graph_filter import seq_sum
from msu_latentafis_tpu_torch.matcher.kernels import ops
from msu_latentafis_tpu_torch.utils.synthetic import random_codebook

BF16 = torch.bfloat16
TOL = ops.KERNEL_TOL


def dots_reversed(a, b):
    """seq_dots with the D-long sums in reversed index order."""
    a, b = a.float(), b.float()
    acc = torch.zeros((a.shape[0], b.shape[0], a.shape[1], b.shape[1]))
    for d in reversed(range(a.shape[-1])):
        acc = acc + a[:, None, :, None, d] * b[None, :, None, :, d]
    return acc


def dots_kstep(a, b, k=16):
    """seq_dots as an mma k-step sums: each 16-long chunk of products summed
    pairwise, the chunk sums added to the accumulator in order."""
    a, b = a.float(), b.float()
    acc = torch.zeros((a.shape[0], b.shape[0], a.shape[1], b.shape[1]))
    for c in range(0, a.shape[-1], k):
        p = a[:, None, :, None, c:c + k] * b[None, :, None, :, c:c + k]
        while p.shape[-1] > 1:
            if p.shape[-1] % 2:
                p = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
            p = p[..., 0::2] + p[..., 1::2]
        acc = acc + p[..., 0]
    return acc


ORDERS = {"reversed": dots_reversed, "kstep16": dots_kstep}


def adc_screen_in(dots, x, lsq, lvalid, dec, rsq, rvalid, block=0):
    """ops.adc_screen_plain (tau 0) with the dots summed by ``dots``."""
    a1, a2 = ops.screen_aug(rsq, rvalid, x.dtype, dec.dtype, block)
    v = (dots(x, dec) + a1[None, :, None, :]) + a2[None, :, None, :]
    raw = v.max(dim=-1).values.to(x.dtype).float()
    term = torch.clamp(2.0 * raw + (6.0 - lsq)[:, None, :], min=0.0) \
        * lvalid[:, None, :]
    return seq_sum(term, dim=2)


def screen_t_in(dots, xt, dect, k=96):
    """ops.screen_t_bf16_plain with the first ``k`` products of each dot
    summed by ``dots`` and the rest added after them in index order (the
    card's order: 96 features on the tensor cores, then the tail)."""
    a, b = xt.float().t()[None], dect.float()
    acc = dots(a[..., :k], b[..., :k])[0]                  # [B, M, Rt]
    for d in range(k, a.shape[-1]):
        acc = acc + a[0, None, :, None, d] * b[:, None, :, d]
    return acc.max(dim=-1).values


def minu_screen_in(dots, ldes, lvalid, rdes, rvalid):
    """ops.minu_screen_plain with the dots summed by ``dots``."""
    s = dots(ldes.float() * lvalid[..., None],
             rdes.float() * rvalid[..., None])
    rb = seq_sum(torch.clamp(s.max(dim=-1).values, min=0.0), dim=-1)
    cb = seq_sum(torch.clamp(s.max(dim=-2).values, min=0.0), dim=-1)
    return torch.minimum(rb, cb)


def within(got, want, atol):
    return bool(((got - want).abs() <= atol + TOL["rtol"] * want.abs())
                .all())


def _codes_case(rng, NL, Lt, B, Rt, C=256):
    """bf16 latents and codebook (S 16, sub_dim 6: D 96), uint8 codes."""
    cb = random_codebook(rng, n_subs=16, n_clusters=C, sub_dim=6)
    codes = rng.integers(0, C, (B, Rt, 16)).astype(np.uint8)
    x = (0.3 * rng.standard_normal((NL, Lt, 96))).astype(np.float32)
    cbk = torch.as_tensor(cb).to(BF16)
    xb = torch.as_tensor(x).to(BF16)
    dec = ops.decode_pq(torch.as_tensor(codes), cbk)
    lsq = xb.float().pow(2).sum(-1)
    lval = torch.as_tensor((rng.random((NL, Lt)) > 0.1).astype(np.float32))
    rval = torch.as_tensor((rng.random((B, Rt)) > 0.1).astype(np.float32))
    rsq = dec.float().pow(2).sum(-1)
    return cb, codes, xb, cbk, dec, lsq, lval, rsq, rval


@pytest.mark.parametrize("order", list(ORDERS))
def test_codes_screen_reordered_within_slack(order):
    """The bf16 codes screen at the cap's prescreen shape (Lt 64 rows of 2
    latents against Rt 1000) with its dots in another order: within
    ops.screen_slack of the plain version."""
    rng = np.random.default_rng(20261017)
    _, codes, xb, cbk, dec, lsq, lval, rsq, rval = _codes_case(
        rng, NL=2, Lt=64, B=3, Rt=1000)
    plain = ops.adc_screen_codes_plain(xb, lsq, lval,
                                       torch.as_tensor(codes), cbk, rsq,
                                       rval)
    got = adc_screen_in(ORDERS[order], xb, lsq, lval, dec, rsq, rval)
    slack = ops.screen_slack(xb, lval,
                             ops.screen_rowmax_plain(xb, dec, rsq, rval))
    assert within(got, plain, slack)


def _adc_case(rng, NL, Lt, B, Rt, gallery):
    """bf16 latents against a predecoded gallery (bf16, or int8 with one
    scale over the B entries), D 96, random validity."""
    x = torch.as_tensor((0.3 * rng.standard_normal((NL, Lt, 96)))
                        .astype(np.float32)).to(BF16)
    if gallery == "int8":
        dec = torch.as_tensor(rng.integers(-127, 128, (B, Rt, 96))
                              .astype(np.int8))
    else:
        dec = torch.as_tensor((0.3 * rng.standard_normal((B, Rt, 96)))
                              .astype(np.float32)).to(BF16)
    lval = torch.as_tensor((rng.random((NL, Lt)) > 0.1).astype(np.float32))
    rval = torch.as_tensor((rng.random((B, Rt)) > 0.1).astype(np.float32))
    return dict(x=x, lsq=x.float().pow(2).sum(-1), lvalid=lval, dec=dec,
                rsq=dec.float().pow(2).sum(-1), rvalid=rval,
                block=B if gallery == "int8" else 0)


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("gallery", ["bf16", "int8"])
@pytest.mark.parametrize("Rt", [448, 1000])
def test_adc_screen_reordered_within_slack(order, gallery, Rt):
    """The predecoded screen [bf16, bf16] and [bf16, int8] at the serving
    prescreen's rows (2 latents x Lt 64) against Rt 448 and the cap's
    Rt 1000, its dots in another order: within ops.screen_slack of
    adc_screen_plain."""
    rng = np.random.default_rng(Rt + len(gallery))
    a = _adc_case(rng, NL=2, Lt=64, B=3, Rt=Rt, gallery=gallery)
    plain = ops.adc_screen_plain(**a)
    got = adc_screen_in(ORDERS[order], **a)
    slack = ops.screen_slack(a["x"], a["lvalid"], ops.screen_rowmax_plain(
        a["x"], a["dec"], a["rsq"], a["rvalid"], a["block"]))
    assert within(got, plain, slack)


def test_int8_widens_to_bf16_exactly():
    """Every int8 value, widened to bf16 and then to f32, is the value
    widened to f32 directly: the tensor-core screens stage an int8 gallery
    in bf16 and their products x dec stay exact."""
    v = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    assert torch.equal(v.to(BF16).float(), v.float())
    assert torch.equal(v.float(), torch.arange(-128.0, 128.0))


@pytest.mark.parametrize("order", list(ORDERS))
def test_screen_t_reordered_within_tol(order):
    """screen_t_bf16 at the script's Da 98 (D 96 + two aug columns against
    xt's ones rows, as ops.screen_t_operands builds them) with its first 96
    products in another order: within ops.screen_t_tol of the plain
    version."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((1, 512, 96))
                        .astype(np.float32)).to(BF16)
    dec = torch.as_tensor(rng.integers(-127, 127, (2, 448, 96))
                          .astype(np.int8))
    xt, dect = ops.screen_t_operands(
        x, dec, torch.as_tensor(rng.random((2, 448)).astype(np.float32)),
        torch.as_tensor((rng.random((2, 448)) > 0.1).astype(np.float32)))
    plain = ops.screen_t_bf16_plain(xt, dect)
    got = screen_t_in(ORDERS[order], xt, dect)
    assert within(got, plain, ops.screen_t_tol(xt, dect))


@pytest.mark.parametrize("order", list(ORDERS))
def test_screen_t_reordered_sum_breaks_kernel_tol(order):
    """A dot with cancellation: 64 x 64, fifteen 2^-6 x 2^-6, then
    64 x -64. In index order each 2^-12 is half an ulp of 4096 and lost
    (ties to even), so the dot is 0; reversed, the small products add
    below 4096, where they are exact (15 2^-12), and as a k-step the
    pairwise sums survive (7 2^-11). The screen moves by ~2^-8, past
    KERNEL_TOL, and ops.screen_t_tol (4 Da 2^-24 sum |p|) covers it."""
    xv = np.zeros(98, np.float32)
    dv = np.zeros(98, np.float32)
    xv[0], dv[0] = 64.0, 64.0
    xv[1:16], dv[1:16] = 2 ** -6, 2 ** -6
    xv[16], dv[16] = 64.0, -64.0
    xt = torch.as_tensor(xv).reshape(98, 1).to(BF16)
    dect = torch.as_tensor(dv).reshape(1, 1, 98).to(BF16)
    plain = ops.screen_t_bf16_plain(xt, dect)
    got = screen_t_in(ORDERS[order], xt, dect)
    want = {"reversed": 15 * 2 ** -12, "kstep16": 7 * 2 ** -11}[order]
    assert float(plain) == 0.0 and float(got) == want
    assert not within(got, plain, TOL["atol"])
    assert within(got, plain, ops.screen_t_tol(xt, dect))


@pytest.mark.parametrize("order", list(ORDERS))
def test_reordered_sum_crosses_a_bf16_boundary(order):
    """One dot whose exact value lies just past the midpoint between two
    bf16 values: in index order the small terms are lost and the row
    maximum 1 + 2^-8 rounds down to 1 (ties to even); reversed, or summed
    pairwise as a k-step, they survive and it rounds up to 1 + 2^-7. The
    screen moves by two bf16 ulps (2^-6), past KERNEL_TOL, and
    ops.screen_slack covers it."""
    xv = np.array([1.0, 2 ** -4] + [2 ** -12] * 14, np.float32)
    dv = np.array([1.0, 2 ** -4] + [2 ** -13] * 14, np.float32)
    x = torch.as_tensor(xv).reshape(1, 1, 16).to(BF16)
    dec = torch.as_tensor(dv).reshape(1, 1, 16).to(BF16)
    lsq, lval = torch.zeros(1, 1), torch.ones(1, 1)
    rsq, rval = torch.zeros(1, 1), torch.ones(1, 1)
    plain = ops.adc_screen_plain(x, lsq, lval, dec, rsq, rval)
    got = adc_screen_in(ORDERS[order], x, lsq, lval, dec, rsq, rval)
    assert float(plain) == 8.0 and float(got) == 8.0 + 2 ** -6
    assert not within(got, plain, TOL["atol"])
    slack = ops.screen_slack(x, lval, ops.screen_rowmax_plain(x, dec, rsq,
                                                              rval))
    assert within(got, plain, slack)


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("gallery", ["bf16", "int8"])
def test_minu_screen_reordered_within_tol(order, gallery):
    """The bf16 minutiae screen at the cap shape (P = R = 128, D 96), the
    gallery bf16 or int8 with its scale folded into the latent side, its
    dots in another order: within KERNEL_TOL of the plain version."""
    rng = np.random.default_rng(7)
    ld = rng.standard_normal((2, 128, 96)).astype(np.float32)
    rd = rng.standard_normal((3, 128, 96)).astype(np.float32)
    rd[0, :64] = ld[0, :64] + 0.2 * rng.standard_normal((64, 96))
    ld /= np.linalg.norm(ld, axis=-1, keepdims=True)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    if gallery == "int8":
        scale = float(np.abs(rd).max()) / 127.0
        rdes = torch.as_tensor(np.clip(np.round(rd / scale), -127, 127)
                               .astype(np.int8))
        ld = ld * np.float32(scale)
    else:
        rdes = torch.as_tensor(rd).to(BF16)
    ldes = torch.as_tensor(ld).to(BF16)
    lval = torch.as_tensor((rng.random((2, 128)) > 0.1).astype(np.float32))
    rval = torch.as_tensor((rng.random((3, 128)) > 0.1).astype(np.float32))
    plain = ops.minu_screen_plain(ldes, lval, rdes, rval)
    got = minu_screen_in(ORDERS[order], ldes, lval, rdes, rval)
    assert float(plain[0, 0]) > 10.0          # the mated pair
    assert within(got, plain, TOL["atol"])


def test_minu_screen_bf16_int8_at_r128_matches_pallas():
    """minu_screen_plain [bf16, int8] at R = 128 against the Pallas fast
    path in interpret mode."""
    rng = np.random.default_rng(11)
    lat = rng.standard_normal((2, 128, 96)).astype(np.float32)
    lat /= np.linalg.norm(lat, axis=-1, keepdims=True)
    rol = rng.integers(-127, 128, (2, 128, 96)).astype(np.int8)
    lat = (lat * np.float32(0.0123)).astype(np.float32)
    lval = (rng.random((2, 128)) > 0.1).astype(np.float32)
    rval = (rng.random((2, 128)) > 0.1).astype(np.float32)
    want = pk.fused_minu_screen(
        jnp.asarray(lat).astype(jnp.bfloat16), jnp.asarray(lval),
        jnp.asarray(np.swapaxes(rol, 1, 2)), jnp.asarray(rval),
        interpret=True)
    got = ops.minu_screen(torch.as_tensor(lat).to(BF16),
                          torch.as_tensor(lval), torch.as_tensor(rol),
                          torch.as_tensor(rval))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_codes_screen_bf16_ragged_rt_matches_pallas():
    """adc_screen_codes_plain with a bf16 codebook at D 96 and Rt 100 (not a
    multiple of 64) against the Pallas codes screen in interpret mode,
    within ops.screen_slack (each side sums in its own order)."""
    rng = np.random.default_rng(13)
    cb, codes, xb, cbk, dec, lsq, lval, rsq, rval = _codes_case(
        rng, NL=2, Lt=16, B=2, Rt=100, C=16)
    tdec = np.ascontiguousarray(np.asarray(block_diag_codebook(cb),
                                           np.float32)
                                .reshape(16 * 16, 96).T)
    want = pk.fused_adc_screen_codes(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(lsq.numpy()), jnp.asarray(lval.numpy()),
        jnp.asarray(np.swapaxes(codes, 1, 2).copy()),
        jnp.asarray(tdec).astype(jnp.bfloat16), jnp.asarray(rsq.numpy()),
        jnp.asarray(rval.numpy()), n_clusters=16, interpret=True)
    got = ops.adc_screen_codes(xb, lsq, lval, torch.as_tensor(codes), cbk,
                               rsq, rval)
    slack = ops.screen_slack(xb, lval,
                             ops.screen_rowmax_plain(xb, dec, rsq, rval))
    assert within(torch.as_tensor(np.array(want)), got, slack)
