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
rtol 1e-5 / atol 1e-4.
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
    """The script's int8 pallas_call (:124), one latent chunk."""
    return pl.pallas_call(
        kernel_int8, grid=(B // E, 1),
        in_specs=[pl.BlockSpec((D, M), lambda b, c: (0, c)),
                  pl.BlockSpec((E, Rt, D), lambda b, c: (b, 0, 0)),
                  pl.BlockSpec((E, Rt, 1), lambda b, c: (b, 0, 0))],
        out_specs=pl.BlockSpec((E, M), lambda b, c: (b, c)),
        out_shape=jax.ShapeDtypeStruct((B, M), jnp.int32),
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


def test_screen_t_int8_plain_equals_pallas(rng):
    xt = rng.integers(-127, 128, (D, M)).astype(np.int8)
    dect = rng.integers(-127, 128, (B, Rt, D)).astype(np.int8)
    corr = rng.integers(-2000, 2000, (B, Rt)).astype(np.int32)
    corr[1, 3] -= 1 << 28
    want = pallas_t_int8(jnp.asarray(xt), jnp.asarray(dect),
                         jnp.asarray(corr)[..., None])
    got = ops.screen_t_int8(T(xt, torch.int8), T(dect, torch.int8),
                            T(corr, torch.int32), entries=E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
