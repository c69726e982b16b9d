"""The kernels of the ported experiment and probe scripts, and the launch
canary, on the CPU against the JAX side.

The JAX scripts (scripts/exp_screen_mfu.py, scripts/microbench_h1_probe.py)
define their Pallas kernels as closures inside ``main()``, so the bodies are
restated here, with the script lines cited, and run through
``pl.pallas_call(..., interpret=True)`` on the same NumPy-made inputs as the
port's plain versions. Tolerances: the transposed bf16 screen's raw maxima
rtol 1e-5 / atol 1e-4 (bf16 x bf16 products are exact in f32; the sums run
in another order); the int8 screen's int32 maxima exactly; the end-to-end
screens rtol 1e-5 / atol 1e-3 (sums of a few hundred terms); the H1 probe
rtol 1e-5 / atol 1e-4. A NumPy model of the int8 screen's tensor-core
fragments (csrc/screen_t.cu, mma.sync.m16n8k32 s8) rebuilds every dot
exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from msu_latentafis_tpu_torch.matcher.kernels import ops
from msu_latentafis_tpu_torch.scripts import exp_screen_mfu, \
    microbench_h1_probe

TOL = dict(rtol=1e-5, atol=1e-4)
NL, Lt, D, Rt, B, E = 2, 8, 8, 12, 4, 2
M = NL * Lt


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


# ---------------------------------------------------------------------------
# exp_screen_mfu: the transposed screens
# ---------------------------------------------------------------------------

def kernel_bf16(xt_ref, dect_ref, best_ref):
    # scripts/exp_screen_mfu.py:89-99
    xt = xt_ref[...]
    for e in range(E):
        d = dect_ref[e]
        if d.dtype != xt.dtype:
            d = d.astype(xt.dtype)
        dots = jnp.dot(d, xt, preferred_element_type=jnp.float32)
        best_ref[e:e + 1, :] = jnp.max(dots, axis=0, keepdims=True)


def kernel_int8(xt_ref, dect_ref, corr_ref, best_ref):
    # scripts/exp_screen_mfu.py:101-111
    xt = xt_ref[...]
    for e in range(E):
        dots = jnp.dot(dect_ref[e], xt, preferred_element_type=jnp.int32)
        dots = dots + corr_ref[e]
        best_ref[e:e + 1, :] = jnp.max(dots, axis=0, keepdims=True)


def pallas_t_bf16(xt, dect):
    """The script's bf16 pallas_call (:154), one latent chunk."""
    Da = xt.shape[0]
    return pl.pallas_call(
        kernel_bf16, grid=(B // E, 1),
        in_specs=[pl.BlockSpec((Da, M), lambda b, c: (0, c)),
                  pl.BlockSpec((E, Rt, Da), lambda b, c: (b, 0, 0))],
        out_specs=pl.BlockSpec((E, M), lambda b, c: (b, c)),
        out_shape=jax.ShapeDtypeStruct((B, M), jnp.float32),
        interpret=True)(xt, dect)


def pallas_t_int8(xt, dect, corr):
    """The script's int8 pallas_call (:124), one latent chunk; xt [D_, M_],
    dect [B_, Rt_, D_] (B_ a multiple of E), corr [B_, Rt_, 1]."""
    D_, M_ = xt.shape
    B_, Rt_, _ = dect.shape
    return pl.pallas_call(
        kernel_int8, grid=(B_ // E, 1),
        in_specs=[pl.BlockSpec((D_, M_), lambda b, c: (0, c)),
                  pl.BlockSpec((E, Rt_, D_), lambda b, c: (b, 0, 0)),
                  pl.BlockSpec((E, Rt_, 1), lambda b, c: (b, 0, 0))],
        out_specs=pl.BlockSpec((E, M_), lambda b, c: (b, c)),
        out_shape=jax.ShapeDtypeStruct((B_, M_), jnp.int32),
        interpret=True)(xt, dect, corr)


def script_run(x, dect_bdr, rol_sq, rol_va, lat_sq, lat_va, int8):
    """The script's ``run`` (:113-170) with dect in its [B, D, Rt] layout."""
    rsqm = rol_sq * 0.5
    if int8:
        sx = jnp.max(jnp.abs(x.astype(jnp.float32))) / 126.0 + 1e-9
        xq = jnp.clip(jnp.round(x.astype(jnp.float32) / sx),
                      -127, 127).astype(jnp.int8)
        xt = xq.reshape(M, D).T
        dect_t = jnp.swapaxes(dect_bdr, 1, 2)
        corr = (jnp.round(-rsqm / sx).astype(jnp.int32)
                + jnp.where(rol_va > 0, 0, -(1 << 28))
                .astype(jnp.int32)).reshape(B, Rt, 1)
        raw = pallas_t_int8(xt, dect_t, corr)
        raw = jnp.swapaxes(raw.reshape(B, NL, Lt), 0, 1)
        best = 2.0 * raw.astype(jnp.float32) * sx + (6.0 - lat_sq)[:, None, :]
    else:
        xdt = jnp.bfloat16
        aug1 = (-rsqm).astype(xdt).reshape(B, 1, Rt)
        aug2 = jnp.where(rol_va > 0, 0.0, -1e4).astype(xdt).reshape(B, 1, Rt)
        dect_aug = jnp.concatenate([dect_bdr.astype(xdt), aug1, aug2], axis=1)
        dect_t = jnp.swapaxes(dect_aug, 1, 2)
        cols = jnp.ones((NL, Lt, 2), xdt)
        x_aug = jnp.concatenate([x.astype(xdt), cols], axis=2)
        xt = x_aug.reshape(M, D + 2).T
        raw = pallas_t_bf16(xt, dect_t)
        raw = jnp.swapaxes(raw.reshape(B, NL, Lt), 0, 1)
        best = 2.0 * raw + (6.0 - lat_sq)[:, None, :]
    contrib = jnp.maximum(best, 0.0) * lat_va[:, None, :]
    return jnp.sum(contrib, axis=2)


@pytest.fixture
def screen_inputs(rng):
    x = rng.standard_normal((NL, Lt, D)).astype(np.float32)
    dect = rng.integers(-127, 127, (B, D, Rt)).astype(np.int8)
    rol_sq = (rng.random((B, Rt)) * 50).astype(np.float32)
    rol_va = (rng.random((B, Rt)) > 0.2).astype(np.float32)
    lat_sq = rng.random((NL, Lt)).astype(np.float32)
    lat_va = (rng.random((NL, Lt)) > 0.1).astype(np.float32)
    return x, dect, rol_sq, rol_va, lat_sq, lat_va


def test_screen_t_bf16_plain_matches_pallas(rng):
    xt = rng.standard_normal((D + 2, M)).astype(np.float32)
    dect = rng.standard_normal((B, Rt, D + 2)).astype(np.float32)
    want = pallas_t_bf16(jnp.asarray(xt).astype(jnp.bfloat16),
                         jnp.asarray(dect).astype(jnp.bfloat16))
    got = ops.screen_t_bf16(T(xt).to(torch.bfloat16),
                            T(dect).to(torch.bfloat16), entries=E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ops.screen_t_bf16.launches == 0        # CPU tensors: plain path


def int8_case(rng, case):
    """(xt [D, M], dect [B, Rt, D], corr [B, Rt]) int8 / int32 operands:
    random at the module's shapes; the extremes (dect all -128 against xt
    +-127, D 96); a ragged case (M 600, Rt 100, D 36); an entry whose every
    column carries -2^28 in corr (an invalid entry)."""
    D_, M_, Rt_ = dict(random=(D, M, Rt), extremes=(96, 64, 12),
                       ragged=(36, 600, 100), invalid=(D, M, Rt))[case]
    xt = rng.integers(-127, 128, (D_, M_)).astype(np.int8)
    dect = rng.integers(-128, 128, (B, Rt_, D_)).astype(np.int8)
    corr = rng.integers(-2000, 2000, (B, Rt_)).astype(np.int32)
    corr[1, 3] -= 1 << 28
    if case == "extremes":
        xt = np.where(rng.random((D_, M_)) < 0.5, -127, 127).astype(np.int8)
        dect = np.full((B, Rt_, D_), -128, np.int8)
    if case == "invalid":
        corr[2] -= 1 << 28
    return xt, dect, corr


@pytest.mark.parametrize("case", ["random", "extremes", "ragged", "invalid"])
def test_screen_t_int8_plain_equals_pallas(rng, case):
    xt, dect, corr = int8_case(rng, case)
    want = pallas_t_int8(jnp.asarray(xt), jnp.asarray(dect),
                         jnp.asarray(corr)[..., None])
    got = ops.screen_t_int8(T(xt, torch.int8), T(dect, torch.int8),
                            T(corr, torch.int32), entries=E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the int8 screen's tensor-core fragments (csrc/screen_t.cu), modelled
# ---------------------------------------------------------------------------

KCT, KLD8, KROWS, KWARPS = 128, 112, 512, 8    # screen_t.cu / screen_body.cuh
LANE = np.arange(32)
G, C = LANE >> 2, LANE & 3


def u8(a):
    return np.asarray(a).astype(np.int8).view(np.uint8).astype(np.uint32)


def s8(reg, byte):
    return ((reg >> (8 * byte)) & 0xFF).astype(np.uint8).view(np.int8) \
        .astype(np.int64)


def kernel_a(xt, r0, ks):
    """[32, 4] registers of the A fragment of rows m r0 .. r0 + 15 at k-step
    ks as screen_t.cu packs them (pack_k4): register h of lane 4 g + c
    holds xt[k .. k + 3, m], k = 32 ks + 4 c + 16 (h / 2), m = r0 + g +
    8 (h % 2), lowest k in the lowest byte, zero past D or M."""
    D_, M_ = xt.shape
    regs = np.zeros((32, 4), np.uint32)
    for h in range(4):
        k = 32 * ks + 4 * C + 16 * (h >> 1)
        m = r0 + G + 8 * (h & 1)
        ok = (k < D_) & (m < M_)
        for q in range(4):
            v = u8(xt[np.minimum(k + q, D_ - 1), np.minimum(m, M_ - 1)])
            regs[:, h] |= np.where(ok, v, 0).astype(np.uint32) << (8 * q)
    return regs


def ldmatrix(smem, addr, nmat):
    """ldmatrix.m8n8.x{nmat}.b16: register i of lane l holds the 4 bytes at
    4 (l % 4) of the 16-byte row whose address lane 8 i + l / 4 gave."""
    out = np.zeros((32, nmat), np.uint32)
    for i in range(nmat):
        row = addr[8 * i + LANE // 4] + 4 * (LANE % 4)
        for q in range(4):
            out[:, i] |= smem[row + q].astype(np.uint32) << (8 * q)
    return out


def mma_s8(a, b, c):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 by the PTX ISA's fragment
    tables: a_i (i < 16, register i / 4, byte i % 4) at row g + 8 [4 <= i <
    8 or i >= 12], col 4 c + i % 4 + 16 [i >= 8]; b_i (i < 8) at k 4 c +
    i % 4 + 16 [i >= 4], col g; c_i / d_i at row g + 8 [i >= 2], col
    2 c + i % 2."""
    A = np.zeros((16, 32), np.int64)
    Bm = np.zeros((32, 8), np.int64)
    Cm = np.zeros((16, 8), np.int64)
    for i in range(16):
        A[G + 8 * int(4 <= i < 8 or i >= 12),
          4 * C + (i & 3) + 16 * int(i >= 8)] = s8(a[:, i // 4], i % 4)
    for i in range(8):
        Bm[4 * C + (i & 3) + 16 * int(i >= 4), G] = s8(b[:, i // 4], i % 4)
    for i in range(4):
        Cm[G + 8 * int(i >= 2), 2 * C + (i & 1)] = c[:, i]
    Dm = A @ Bm + Cm
    return np.stack([Dm[G + 8 * int(i >= 2), 2 * C + (i & 1)]
                     for i in range(4)], axis=1)


def model_screen_t_int8(xt, dect, corr, rng):
    """The kernel's walk for every entry: 128-column tiles stored [n][112
    bytes] (rows past the tile's columns hold stale bytes, here random), the
    B fragments by its ldmatrix addresses, corr as the first k-step's C
    operand, the masked maximum; returns (dots + corr [B, Rt, M] as the
    fragments give them, raw [B, M])."""
    D_, M_ = xt.shape
    B_, Rt_, _ = dect.shape
    KS = -(-D_ // 32)
    dots = np.full((B_, Rt_, M_), np.iinfo(np.int64).min)
    raw = np.full((B_, M_), np.iinfo(np.int32).min, np.int64)
    for b in range(B_):
        for c0 in range(0, Rt_, KCT):
            ncols = min(KCT, Rt_ - c0)
            smem = u8(rng.integers(-128, 128, KCT * KLD8)).astype(np.uint8)
            cs = rng.integers(-2 ** 31, 2 ** 31, KCT)
            for n in range(ncols):
                smem[n * KLD8:n * KLD8 + D_] = u8(dect[b, c0 + n])
                cs[n] = corr[b, c0 + n]
            smem[np.arange(KCT)[:, None] * KLD8
                 + np.arange(D_, 32 * KS)[None]] = 0     # zeroed at start
            for g0 in range(0, M_, KROWS):
                gn = min(KROWS, M_ - g0)
                wr = -(-gn // 64)
                wc = KWARPS // wr
                for warp in range(KWARPS):
                    rw, cw = warp % wr, warp // wr
                    if cw >= wc:
                        continue
                    for n in range(cw, -(-ncols // 8), wc):
                        rows = (8 * n + (LANE & 7)) * KLD8
                        bf = []
                        for j in range(KS // 2):
                            r = ldmatrix(smem, rows + 64 * j
                                         + 16 * (LANE >> 3), 4)
                            bf += [r[:, :2], r[:, 2:]]
                        if KS & 1:
                            bf.append(ldmatrix(
                                smem, rows + 64 * (KS // 2)
                                + 16 * ((LANE >> 3) & 1), 2))
                        col = 8 * n + 2 * C
                        cin = np.stack([cs[col], cs[col + 1], cs[col],
                                        cs[col + 1]], axis=1)
                        for m in range(4):
                            r0 = g0 + rw * 64 + 16 * m
                            acc = mma_s8(kernel_a(xt, r0, 0), bf[0], cin)
                            for ks in range(1, KS):
                                acc = mma_s8(kernel_a(xt, r0, ks), bf[ks],
                                             acc)
                            for i in range(4):
                                row = r0 + G + 8 * int(i >= 2)
                                cl = col + (i & 1)
                                ok = (row < M_) & (cl < ncols)
                                dots[b, c0 + cl[ok], row[ok]] = acc[ok, i]
                                np.maximum.at(raw[b], row[ok], acc[ok, i])
    return dots, raw


@pytest.mark.parametrize("case", ["ragged", "D96"])
def test_int8_fragment_model_rebuilds_every_dot(rng, case):
    """The kernel's fragment packing and ldmatrix addresses, run through the
    PTX ISA's m16n8k32 s8 tables, give every dot xt.T @ dect plus corr, and
    the masked maximum gives the plain version's raw: a ragged case (M 600:
    a last row group of 88 split over column slots; Rt 100: a ragged last
    n-tile; D 36: two k-steps, padded) and D 96 (three k-steps: ldmatrix x4
    and x2) with two column tiles (Rt 130)."""
    D_, M_, Rt_ = dict(ragged=(36, 600, 100), D96=(96, 80, 130))[case]
    xt = rng.integers(-128, 128, (D_, M_)).astype(np.int8)
    dect = rng.integers(-128, 128, (2, Rt_, D_)).astype(np.int8)
    corr = rng.integers(-5000, 5000, (2, Rt_)).astype(np.int32)
    dots, raw = model_screen_t_int8(xt, dect, corr, rng)
    want = np.einsum("brd,dm->brm", dect.astype(np.int64),
                     xt.astype(np.int64)) + corr[:, :, None]
    np.testing.assert_array_equal(dots, want)
    np.testing.assert_array_equal(raw, ops.screen_t_int8_plain(
        T(xt, torch.int8), T(dect, torch.int8), T(corr, torch.int32)).numpy())


@pytest.mark.parametrize("int8", [False, True])
def test_screen_t_end_to_end_matches_script(screen_inputs, int8):
    """ops.screen_t (operands, kernel, epilogue) against the script's run
    on the same inputs."""
    x, dect, rol_sq, rol_va, lat_sq, lat_va = screen_inputs
    want = script_run(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(dect),
                      jnp.asarray(rol_sq), jnp.asarray(rol_va),
                      jnp.asarray(lat_sq), jnp.asarray(lat_va), int8)
    got = ops.screen_t(T(x).to(torch.bfloat16), T(lat_sq), T(lat_va),
                       T(np.swapaxes(dect, 1, 2), torch.int8), T(rol_sq),
                       T(rol_va), int8=int8, entries=E)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


def test_exp_screen_variants_on_the_cpu():
    """The ported script's five variants run on its inputs (cut to two
    latent rows and 8 entries here); base and base_e16 are one call, the
    transposed variants agree with each other."""
    a = exp_screen_mfu.make_inputs(np.random.default_rng(0), "cpu", B=8)
    a = {k: v[:, :2].contiguous() if k in ("x", "lsq", "lvalid") else v
         for k, v in a.items()}
    out = {k: f() for k, f in exp_screen_mfu.variants(a).items()}
    assert set(out) == {"base", "transposed", "transposed_e16",
                        "transposed_int8", "base_e16"}
    assert torch.equal(out["base"], out["base_e16"])
    assert torch.equal(out["transposed"], out["transposed_e16"])
    rel = float((out["transposed_int8"] - out["base"]).abs().max()
                / out["base"].abs().max())
    assert all(v.shape == (exp_screen_mfu.NL, 8) for v in out.values())
    assert rel < 0.01, rel


# ---------------------------------------------------------------------------
# microbench_h1_probe
# ---------------------------------------------------------------------------

TP, KP, NPP = 2, 16, 4


def _tail(d1, d2, vf):
    # scripts/microbench_h1_probe.py:40-46
    dist = jnp.abs(d1 - d2)
    H1 = jnp.clip((30.0 - dist) / 25.0, 0.0, 1.0)
    pairf = vf[:, None, :] * vf[:, :, None]
    gatef = (dist <= 30.0).astype(jnp.float32) * pairf
    return jnp.sum(jnp.sum(H1 * gatef, axis=2), axis=1)


def k_bcast(lx_ref, ly_ref, rx_ref, ry_ref, vf_ref, o_ref):
    # scripts/microbench_h1_probe.py:48-57
    lx, ly, rx, ry = lx_ref[...], ly_ref[...], rx_ref[...], ry_ref[...]
    dxl = lx[:, :, None] - lx[:, None, :]
    dyl = ly[:, :, None] - ly[:, None, :]
    dxr = rx[:, :, None] - rx[:, None, :]
    dyr = ry[:, :, None] - ry[:, None, :]
    d1 = jnp.sqrt(dxl * dxl + dyl * dyl)
    d2 = jnp.sqrt(dxr * dxr + dyr * dyr)
    o_ref[...] = _tail(d1, d2, vf_ref[...])[:, None]


def k_matmul(lx_ref, ly_ref, rx_ref, ry_ref, vf_ref, o_ref):
    # scripts/microbench_h1_probe.py:59-76
    ones = jnp.ones((KP, 1), jnp.float32)

    def deltas(x):
        outs = []
        for t in range(TP):
            a = jnp.concatenate([x[t][:, None], -ones], axis=1)
            b = jnp.concatenate([ones.T, x[t][None, :]], axis=0)
            outs.append(jnp.dot(a, b, preferred_element_type=jnp.float32))
        return jnp.stack(outs)

    dxl, dyl = deltas(lx_ref[...]), deltas(ly_ref[...])
    dxr, dyr = deltas(rx_ref[...]), deltas(ry_ref[...])
    d1 = jnp.sqrt(dxl * dxl + dyl * dyl)
    d2 = jnp.sqrt(dxr * dxr + dyr * dyr)
    o_ref[...] = _tail(d1, d2, vf_ref[...])[:, None]


def k_gram(lx_ref, ly_ref, rx_ref, ry_ref, vf_ref, o_ref):
    # scripts/microbench_h1_probe.py:78-94
    ones = jnp.ones((KP, 1), jnp.float32)

    def dsq(x, y):
        outs = []
        for t in range(TP):
            s = (x[t] * x[t] + y[t] * y[t])[:, None]
            a = jnp.concatenate([s, ones, -2.0 * x[t][:, None],
                                 -2.0 * y[t][:, None]], axis=1)
            b = jnp.concatenate([ones.T, s.T, x[t][None, :],
                                 y[t][None, :]], axis=0)
            outs.append(jnp.maximum(
                jnp.dot(a, b, preferred_element_type=jnp.float32), 0.0))
        return jnp.stack(outs)

    d1 = jnp.sqrt(dsq(lx_ref[...], ly_ref[...]))
    d2 = jnp.sqrt(dsq(rx_ref[...], ry_ref[...]))
    o_ref[...] = _tail(d1, d2, vf_ref[...])[:, None]


@pytest.mark.parametrize("variant,kern", [("bcast", k_bcast),
                                          ("matmul", k_matmul),
                                          ("gram", k_gram)])
def test_h1_probe_plain_matches_pallas(rng, variant, kern):
    a = microbench_h1_probe.make_inputs(rng, "cpu", NP=NPP)
    a = {k: v[:, :KP].contiguous() for k, v in a.items()}
    spec = pl.BlockSpec((TP, KP), lambda t: (t, 0))
    fn = functools.partial(
        pl.pallas_call, kern, grid=(NPP // TP,), in_specs=[spec] * 5,
        out_specs=pl.BlockSpec((TP, 1), lambda t: (t, 0)),
        out_shape=jax.ShapeDtypeStruct((NPP, 1), jnp.float32),
        interpret=True)()
    want = fn(*(jnp.asarray(a[k].numpy()) for k in ("lx", "ly", "rx", "ry",
                                                    "vf")))
    got = ops.h1_probe(**a, variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], **TOL)


def test_h1_probe_matmul_equals_bcast(rng):
    """The outer-product form's products are exact and its sum rounds once,
    as the subtraction does: bit for bit the broadcast form; the Gram form
    is not exact."""
    a = microbench_h1_probe.make_inputs(rng, "cpu", NP=8)
    got = {v: ops.h1_probe(**a, variant=v) for v in ops.H1_VARIANTS}
    assert torch.equal(got["bcast"], got["matmul"])
    assert not torch.equal(got["bcast"], got["gram"])
    np.testing.assert_allclose(got["gram"].numpy(), got["bcast"].numpy(),
                               rtol=1e-3)
    with pytest.raises(ValueError):
        ops.h1_probe(**a, variant="outer")


# ---------------------------------------------------------------------------
# the launch-legality canary
# ---------------------------------------------------------------------------

def test_legality_canary_plain_copies(rng):
    """On the CPU the canary is its plain version, a copy, whatever the
    plan: the plan is refused or taken by the card alone
    (tests/test_torch_cuda.py)."""
    x = T(rng.standard_normal((8, 128, 448)).astype(np.float32))
    for plan in (dict(), dict(threads=128, smem_bytes=4096),
                 dict(threads=256, smem_bytes=10 ** 6)):
        y = ops.legality_canary(x, **plan)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert ops.legality_canary.launches == 0
    with pytest.raises(TypeError):
        ops.legality_canary(x.double())


@pytest.mark.parametrize("n,offset", [(1, 0), (1, 1), (3, 1),
                                      (458753, 1)])
def test_legality_canary_plain_copies_edges(rng, n, offset):
    """The plain copy of a view ``offset`` floats into its storage (on the
    card x and y then differ in alignment) and of lengths that are no
    multiple of 4: bit for bit, a new tensor."""
    base = T(rng.standard_normal(n + offset).astype(np.float32))
    x = base[offset:]
    y = ops.legality_canary(x, 128, 4096)
    assert x.storage_offset() == offset and y.shape == (n,)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert ops.legality_canary.launches == 0


def test_mma_peak_needs_the_card(capsys):
    """The tensor-core rate probe counts 2 m n k per instruction and, with
    no card, exits 2 without building anything."""
    from msu_latentafis_tpu_torch.scripts import mma_peak
    assert mma_peak.INSTRUCTIONS == {
        "mma.sync.m16n8k32.s8": (0, 8192), "mma.sync.m16n8k16.bf16": (1, 4096)}
    assert mma_peak.main() == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_h1_phases_cuts_the_probe(capsys):
    """scripts/h1_phases.py finds each cut's anchor in the probe's current
    source once, and needs the card."""
    from msu_latentafis_tpu_torch.matcher.kernels import _build
    from msu_latentafis_tpu_torch.scripts import h1_phases
    src = h1_phases.instrument((_build.CSRC / "h1_probe.cu").read_text())
    for name in h1_phases.CUTS:
        assert src.count(f"{name}\n") >= 1, name
    assert {m for ms in h1_phases.COPIES.values() for m in ms} == \
        set(h1_phases.CUTS)
    assert h1_phases.main() == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_stage_clocks_instruments_the_kernels(tmp_path):
    """scripts/stage_clocks.py finds every anchor in the kernels' current
    sources: one stamp per stage of both match kernels, of the filter body,
    of the minutiae screens' body and of the tensor-core normalized
    screen, a block start in each kernel and every stamp reader."""
    import re
    from pathlib import Path
    from msu_latentafis_tpu_torch.matcher.kernels import _build
    from msu_latentafis_tpu_torch.scripts import stage_clocks as sc
    sc.instrument(Path(_build.CSRC), tmp_path / "csrc")
    stamps = {n: sorted({int(k) for k in re.findall(
        r"STAMP\((\d+)\)", (tmp_path / "csrc" / n).read_text())})
              for n in ("minutiae_match.cu", "texture_match.cu",
                        "filter_body.cuh")}
    assert stamps["minutiae_match.cu"] == list(range(6))
    assert stamps["texture_match.cu"] == list(range(4))
    assert stamps["filter_body.cuh"] == list(
        range(sc.FILTER_SLOT0, sc.FILTER_SLOT0 + len(sc.FILTER_STAGES)))
    body = (tmp_path / "csrc" / "minu_body.cuh").read_text()
    assert sorted({int(k) for k in re.findall(r"STAMP\((\d+)\)", body)}) \
        == list(range(len(sc.STAGES["minu_screen_norm"])))
    tc = (tmp_path / "csrc" / "minu_screen_norm.cu").read_text()
    assert sorted({int(k) for k in re.findall(r"WSTAMP\((\d+)\)", tc)}) \
        == list(range(1, len(sc.STAGES["minu_screen_norm_tc"])))
    for n, reader in sc.READERS.items():
        text = (tmp_path / "csrc" / n).read_text()
        begins = text.count("STAMP_BEGIN();")
        if n.startswith("minu_screen"):      # the body's start, included
            begins += body.count("STAMP_BEGIN();")
        assert begins == (2 if n == "minu_screen_norm.cu" else 1)
        assert f"STAMP_READER({reader})" in text
