"""The port's TF_C intermediate codec and legacy codecs against the JAX
package's: the same bytes written for the same templates, and each
package's reader turning the other's files into equal templates."""
import numpy as np
import pytest

from msu_latentafis_tpu.templates import codec as jcodec
from msu_latentafis_tpu.templates import legacy_codec as jlegacy
from msu_latentafis_tpu_torch.templates import (
    Template, TextureTemplate, read_template, run_length_decode,
    run_length_encode, write_template)
from msu_latentafis_tpu_torch.templates import legacy_codec as legacy
from msu_latentafis_tpu_torch.utils.synthetic import (
    make_latent_template, make_rolled_template, random_descriptors)

MINU_FIELDS = ("h", "w", "blkH", "blkW", "minutiae", "des", "oimg", "mask")
TEX_FIELDS = ("h", "w", "minutiae", "des")


def _eq(a, b):
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _same_template(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert len(a.minu_template) == len(b.minu_template)
    assert len(a.texture_template) == len(b.texture_template)
    for x, y in zip(a.minu_template, b.minu_template):
        for f in MINU_FIELDS:
            _eq(getattr(x, f), getattr(y, f))
    for x, y in zip(a.texture_template, b.texture_template):
        for f in TEX_FIELDS:
            _eq(getattr(x, f), getattr(y, f))


def _read_both(port_read, jax_read, path, **kw):
    """Both readers on one file: equal templates, or the same exception."""
    outs = []
    for read in (port_read, jax_read):
        try:
            outs.append(read(path, **kw))
        except Exception as e:          # the quirk under test may raise
            outs.append(type(e))
    if isinstance(outs[0], type) or isinstance(outs[1], type):
        assert outs[0] == outs[1]
    else:
        _same_template(*outs)
    return outs[0]


def _cross(tmp_path, template, port_write, jax_write, port_read, jax_read,
           write_kw=None, read_kw=None):
    """Both writers give the same bytes; each reader reads both files into
    the template the other reader sees."""
    write_kw, read_kw = write_kw or {}, read_kw or {}
    pp, jp = str(tmp_path / "port.dat"), str(tmp_path / "jax.dat")
    port_write(pp, template, **write_kw)
    jax_write(jp, template, **write_kw)
    with open(pp, "rb") as f, open(jp, "rb") as g:
        data = f.read()
        assert data == g.read()
    return data, _read_both(port_read, jax_read, pp, **read_kw)


def _masks(rng, t):
    for i, mt in enumerate(t.minu_template):
        mt.mask = np.zeros((mt.h, mt.w), np.uint8)
        mt.mask[40:300, 60 + 10 * i:400] = 1
        mt.mask[rng.integers(0, mt.h, 50), rng.integers(0, mt.w, 50)] = 1
    return t


def _tfc_template(rng, kind: str):
    """A TF_C template before DR: 192-d float descriptors, pixel
    coordinates, a float orientation field."""
    if kind == "latent":
        t = make_latent_template(rng, n_minu=17, n_tex=33, des_dim=192,
                                 n_minu_templates=3)
    else:
        t = make_rolled_template(rng, n_minu=40, n_tex=60, des_dim=192)
        tt = t.texture_template[0]
        tt.des = random_descriptors(rng, 60, 192)
        tt.minutiae = np.asarray(tt.minutiae)[:, :3] * [16, 16, 1] + [24, 24, 0]
        mt = t.minu_template[0]                 # TF_C adds reliability
        mt.minutiae = np.column_stack([mt.minutiae, rng.random(40)])
    for mt in t.minu_template:
        mt.oimg = rng.uniform(-np.pi, np.pi, mt.oimg.shape).astype(np.float32)
    return _masks(rng, t)


@pytest.mark.parametrize("save_mask", [False, True])
@pytest.mark.parametrize("kind", ["latent", "rolled"])
def test_tfc_bytes_and_reads_equal_jax(tmp_path, kind, save_mask):
    rng = np.random.default_rng(101)
    t = _tfc_template(rng, kind)
    is_latent = kind == "latent"
    data, back = _cross(tmp_path, t, write_template, jcodec.write_template,
                        read_template, jcodec.read_template,
                        dict(is_latent=is_latent, save_mask=save_mask),
                        dict(is_latent=is_latent))
    if save_mask:
        # neither reader reads the mask runs, so both parse the run count
        # as the next field and run off the end (ROADMAP.md Queue 3)
        assert back is ValueError
        return
    assert len(back.minu_template) == len(t.minu_template)
    np.testing.assert_array_equal(back.minu_template[0].oimg,
                                  t.minu_template[0].oimg)
    np.testing.assert_array_equal(back.texture_template[0].des,
                                  t.texture_template[0].des)
    assert back.texture_template[0].minutiae.shape[1] == (4 if is_latent
                                                          else 3)


@pytest.mark.parametrize("empty", ["none", "no_minutiae"])
def test_tfc_empty_template_equals_jax(tmp_path, empty):
    t = None if empty == "none" else Template()
    data, back = _cross(tmp_path, t, write_template, jcodec.write_template,
                        read_template, jcodec.read_template)
    assert data == np.zeros(4, np.uint16).tobytes() and back is None


def test_tfc_early_end_and_truncation_equal_jax(tmp_path):
    """An empty texture template ends the parse; a truncated descriptor
    block leaves an empty texture template and stops."""
    rng = np.random.default_rng(102)
    t = _tfc_template(rng, "latent")
    t.texture_template.insert(0, TextureTemplate(h=512, w=512,
                                                 minutiae=np.zeros((0, 4))))
    _, back = _cross(tmp_path, t, write_template, jcodec.write_template,
                     read_template, jcodec.read_template)
    assert len(back.texture_template) == 1
    assert back.texture_template[0].minutiae is None

    t = _tfc_template(rng, "rolled")
    full = str(tmp_path / "full.dat")
    write_template(full, t, is_latent=False)
    with open(full, "rb") as f:
        data = f.read()
    cut = str(tmp_path / "cut.dat")
    with open(cut, "wb") as f:
        f.write(data[:-100])
    back = _read_both(read_template, jcodec.read_template, cut,
                      is_latent=False)
    assert back.texture_template[-1].des is None


def test_rle_equals_jax():
    rng = np.random.default_rng(103)
    for h, w in ((64, 48), (512, 512), (1, 7)):
        mask = (rng.random((h, w)) > 0.7).astype(np.uint8)
        runs = run_length_encode(mask)
        np.testing.assert_array_equal(runs, jcodec.run_length_encode(mask))
        out = run_length_decode(runs, h, w)
        np.testing.assert_array_equal(out,
                                      jcodec.run_length_decode(runs, h, w))
        mask[0, 0] = 0                      # the first run is background
        np.testing.assert_array_equal(out, mask)


def _legacy_template(rng):
    t = make_latent_template(rng, n_minu=9, n_tex=12, n_minu_templates=2)
    for mt in t.minu_template:
        mt.des = np.abs(mt.des) + 1e-3      # positive for the u16 rowmax
    tt = t.texture_template[0]
    tt.des = np.abs(tt.des) + 1e-3
    tt.minutiae[:, 3] = rng.random(12) * 100     # distance to border
    return _masks(rng, t)


@pytest.mark.parametrize("is_latent", [True, False])
def test_byte_format_equals_jax(tmp_path, is_latent):
    t = _legacy_template(np.random.default_rng(104))
    _, back = _cross(tmp_path, t, legacy.write_template_byte,
                     jlegacy.write_template_byte, legacy.read_template_byte,
                     jlegacy.read_template_byte, dict(is_latent=is_latent),
                     dict(is_latent=is_latent))
    np.testing.assert_array_equal(back.minu_template[1].mask,
                                  t.minu_template[1].mask)
    assert back.texture_template[0].minutiae.shape[1] == (4 if is_latent
                                                          else 3)


@pytest.mark.parametrize("save_mask", [True, False])
def test_byte_tf_format_equals_jax(tmp_path, save_mask):
    t = _legacy_template(np.random.default_rng(105))
    _, back = _cross(tmp_path, t, legacy.write_template_tf,
                     jlegacy.write_template_tf, legacy.read_template_tf,
                     jlegacy.read_template_tf,
                     dict(is_latent=True, save_mask=save_mask),
                     dict(is_latent=True, with_mask=save_mask))
    assert (back.minu_template[0].mask is not None) == save_mask


def test_byte_tf_c_old_format_equals_jax(tmp_path):
    rng = np.random.default_rng(106)
    t = _legacy_template(rng)
    t.texture_template[0].des = rng.integers(0, 65535, (12, 16)) \
        .astype(np.uint16)
    _, back = _cross(tmp_path, t, legacy.write_template_legacy,
                     jlegacy.write_template_legacy,
                     legacy.read_template_legacy,
                     jlegacy.read_template_legacy,
                     dict(is_latent=True), dict(is_latent=True))
    np.testing.assert_array_equal(back.texture_template[0].des[0],
                                  t.texture_template[0].des.astype(np.float32))
    _, back = _cross(tmp_path, None, legacy.write_template_legacy,
                     jlegacy.write_template_legacy,
                     legacy.read_template_legacy,
                     jlegacy.read_template_legacy)
    assert back is None
