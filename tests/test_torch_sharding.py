"""The port's sharded gallery on torch.distributed (gloo, CPU) against its
local engine and the JAX package's sharded match on the 8-device CPU mesh;
the port's manifest against the JAX package's.

All ranks run in one module-scoped spawn: two gloo ranks over a FileStore
shard the gallery, match and merge the top-k, then rank 0 alone does the
same at world size 1. Each writes what it computed to an npz that the tests
read. This module imports JAX only inside functions, so that the spawned
ranks import no JAX.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from msu_latentafis_tpu_torch.matcher.engine import MatchEngine
from msu_latentafis_tpu_torch.parallel import (
    assign_shard, build_manifest, gallery_group, load_manifest, make_mesh,
    match_sharded, reshard_plan, save_manifest, shard_gallery,
    topk_collective, verify_manifest)
from msu_latentafis_tpu_torch.parallel.distributed import (
    check_backend, global_gallery_from_local, initialize_multihost)
from msu_latentafis_tpu_torch.templates.packing import (
    PackedGallery, PackedLatent, pack_gallery, pack_latent)
from msu_latentafis_tpu_torch.utils.synthetic import (
    make_latent_template, make_rolled_template, random_codebook)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one intra-op thread: the suite's workers share the host's
    cores, and an intra-op pool in each spins waiting on the others (a
    test ran 7x slower with 8 threads than with 1 beside 8 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAPS = dict(minu_cap=32, tex_cap=48)
BLOCK = 2
ROW_CAP = CAPS["minu_cap"]  # the exact top-120, as the JAX CPU top_k
N_IMPOSTORS = 20          # the mate is entry 20 of 21
K_SMALL, K_LARGE = 5, 20  # K_LARGE > 12 entries a rank at world size 2
TIE_G = 32                # tie vector: shards of 16 (port) and 4 (JAX)
TIES = {5.0: (15, 16), 4.0: (3, 4, 24), 3.0: (7, 8)}


def _tie_scores() -> np.ndarray:
    """Ties planted across the 2-shard boundary (15 | 16) and across the
    8-shard boundaries (3 | 4, 7 | 8), above every other score."""
    v = np.random.default_rng(7).uniform(0.0, 1.0, TIE_G).astype(np.float32)
    for value, idx in TIES.items():
        v[list(idx)] = value
    return v


def _packed(data, prefix, cls):
    fields = [k[len(prefix):] for k in data.files if k.startswith(prefix)]
    return cls(**{f: data[prefix + f] for f in fields})


def _rank_run(engine, packed, lats, mesh, tag: str) -> dict:
    """One rank's sharded work, keyed by ``tag``: scores for one latent and
    for a batch, the top-k at two k, the top-k of the tie vector."""
    gal = shard_gallery(engine, packed, mesh)
    single = match_sharded(engine, lats[0], gal, mesh)
    batch = match_sharded(engine, lats, gal, mesh)
    out = {f"{tag}/single": single.numpy(), f"{tag}/batch": batch.numpy(),
           f"{tag}/local_rows": np.int64(gal.size),
           f"{tag}/n_real": np.int64(gal.n_real)}
    ties = torch.as_tensor(_tie_scores())
    for k in (K_SMALL, K_LARGE, 2 * TIE_G):
        for name, s in (("scores", single), ("ties", ties)):
            v, i = topk_collective(s, k, mesh)
            out[f"{tag}/topk_{name}_{k}/v"] = v.numpy()
            out[f"{tag}/topk_{name}_{k}/i"] = i.numpy()
    return out


def _worker(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    data = np.load(os.path.join(root, "inputs.npz"))
    packed = _packed(data, "gal/", PackedGallery)
    lats = [_packed(data, f"lat{i}/", PackedLatent) for i in range(2)]
    engine = MatchEngine(data["cb"], block_size=BLOCK, row_cap=ROW_CAP,
                         device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store2"), 2), rank=rank, world_size=2)
    try:
        mesh = make_mesh(device_type="cpu")
        out = _rank_run(engine, packed, lats, mesh, "w2")
        planes = global_gallery_from_local(
            {"a": np.full((16, 1), rank, np.float32),
             "b": np.ones((16, 4), np.float32)}, mesh)
        out["w2/plane_a_global"] = np.asarray(planes["a"].global_shape)
        out["w2/plane_a_local"] = planes["a"].local.numpy()
        try:
            global_gallery_from_local({"a": np.zeros((8 + rank, 1))}, mesh)
            out["w2/unequal_raises"] = np.bool_(False)
        except ValueError:
            out["w2/unequal_raises"] = np.bool_(True)
        try:
            check_backend(gallery_group(mesh), "cuda")
            out["w2/mismatch_raises"] = np.bool_(False)
        except ValueError:
            out["w2/mismatch_raises"] = np.bool_(True)
    finally:
        dist.destroy_process_group()
    if rank:
        np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
        return
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, "store1"), 1), rank=0, world_size=1)
    try:
        initialize_multihost(num_processes=1, device="cpu")   # a no-op
        out.update(_rank_run(engine, packed, lats,
                             make_mesh(device_type="cpu"), "w1"))
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(root, "rank0.npz"), **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(11)
    cb = random_codebook(rng)
    latent = make_latent_template(rng, n_minu=16, n_tex=40)
    mate = make_rolled_template(rng, n_minu=24, n_tex=44, mated_latent=latent,
                                codebook=cb)
    gallery = [make_rolled_template(rng, n_minu=24, n_tex=44)
               for _ in range(N_IMPOSTORS)] + [mate]
    packed = pack_gallery(gallery, cb, **CAPS)
    lats = [pack_latent(t, quantize_tex_xy=False, **CAPS) for t in (
        latent, make_latent_template(rng, n_minu=16, n_tex=40))]
    root = str(tmp_path_factory.mktemp("torch_sharding"))
    arrays = {"cb": cb}
    for prefix, obj in [("gal/", packed)] + [(f"lat{i}/", l)
                                            for i, l in enumerate(lats)]:
        arrays.update({prefix + k: v for k, v in vars(obj).items()
                       if isinstance(v, (np.ndarray, np.generic))})
    np.savez(os.path.join(root, "inputs.npz"), **arrays)
    mp.start_processes(_worker, args=(root,), nprocs=2, join=True,
                       start_method="spawn")
    ranks = [dict(np.load(os.path.join(root, f"rank{r}.npz")))
             for r in range(2)]
    engine = MatchEngine(cb, block_size=BLOCK, row_cap=ROW_CAP, device="cpu")
    local_gal = engine.load_gallery(packed)
    local = engine.match_scores_batch(lats, local_gal).numpy()
    return dict(cb=cb, packed=packed, lats=lats, ranks=ranks, local=local,
                G0=packed.size)


@pytest.fixture(scope="module")
def jax_side(runs):
    """The JAX package's sharded match and top-k on its 8-device mesh."""
    import jax
    from msu_latentafis_tpu.matcher.engine import MatchEngine as JaxEngine
    from msu_latentafis_tpu.parallel import (make_mesh as jmake_mesh,
                                             match_sharded as jmatch,
                                             shard_gallery as jshard,
                                             topk_collective as jtopk)
    from msu_latentafis_tpu.templates.packing import (
        PackedGallery as JPG, PackedLatent as JPL)
    assert len(jax.devices()) == 8, "the virtual 8-device CPU mesh"
    mesh = jmake_mesh()
    engine = JaxEngine(runs["cb"], block_size=BLOCK)
    gal = jshard(engine, JPG(**vars(runs["packed"])), mesh)
    lats = [JPL(**vars(l)) for l in runs["lats"]]
    scores = np.asarray(jmatch(engine, lats, gal, mesh))

    def topk(s, k):
        v, i = jtopk(jax.numpy.asarray(s), k, mesh)
        return np.asarray(v), np.asarray(i)
    return dict(scores=scores, topk=topk)


@pytest.mark.parametrize("tag", ["w2", "w1"])
def test_sharded_scores_equal_local_engine(runs, tag):
    """Every rank gets the whole gallery's scores, bit for bit the port's
    unsharded engine's, for one latent and for a batch."""
    G0 = runs["G0"]
    for r in ((0, 1) if tag == "w2" else (0,)):
        out = runs["ranks"][r]
        assert out[f"{tag}/n_real"] == G0
        np.testing.assert_array_equal(out[f"{tag}/batch"][:, :G0],
                                      runs["local"][:, :G0])
        np.testing.assert_array_equal(out[f"{tag}/single"][:G0],
                                      runs["local"][0, :G0])
        assert np.all(out[f"{tag}/batch"][:, G0:] == -1.0)
    assert runs["ranks"][0]["w2/local_rows"] == 12     # 24 padded / 2
    assert runs["ranks"][0]["w1/local_rows"] == 22     # 21 -> block 2
    assert int(np.argmax(runs["local"][0, :G0])) == N_IMPOSTORS


def test_sharded_scores_match_jax(runs, jax_side):
    G0 = runs["G0"]
    np.testing.assert_allclose(runs["ranks"][0]["w2/batch"][:, :G0],
                               jax_side["scores"][:, :G0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tag", ["w2", "w1"])
@pytest.mark.parametrize("k", [K_SMALL, K_LARGE, 2 * TIE_G])
@pytest.mark.parametrize("which", ["scores", "ties"])
def test_topk_collective_equals_jax(runs, jax_side, tag, k, which):
    """The same score vector through both top-k merges: the same indices
    and values, ties (planted across both meshes' shard boundaries)
    ranking the lower index first, k above the entries a shard holds."""
    out = runs["ranks"][0]
    s = _tie_scores() if which == "ties" else out[f"{tag}/single"]
    # the JAX mesh needs a multiple of its 8 shards: pad with -1 entries
    pad = -len(s) % 8
    s_jax = np.concatenate([s, np.full(pad, -1.0, np.float32)])
    jv, ji = jax_side["topk"](s_jax, k)
    v, i = out[f"{tag}/topk_{which}_{k}/v"], out[f"{tag}/topk_{which}_{k}/i"]
    n = min(k, len(s))
    np.testing.assert_array_equal(i, ji[:n])
    np.testing.assert_array_equal(v, jv[:n])
    np.testing.assert_array_equal(runs["ranks"][1].get(
        f"{tag}/topk_{which}_{k}/i", i), i)
    if which == "ties" and k == K_SMALL:
        assert list(i) == [15, 16, 3, 4, 24]
    if which == "scores":
        assert i[0] == N_IMPOSTORS


def test_global_gallery_from_local_and_backend(runs):
    for r, out in enumerate(runs["ranks"]):
        assert list(out["w2/plane_a_global"]) == [32, 1]
        assert np.all(out["w2/plane_a_local"] == r)
        assert out["w2/unequal_raises"] and out["w2/mismatch_raises"]
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_mesh(device_type="cpu")


def test_gallery_manifest_lifecycle_matches_jax(tmp_path):
    """The port's manifest through build / save / load, drift detection,
    contiguous shards and the recovery plan, equal to the JAX package's
    (tests/test_distributed.py)."""
    from msu_latentafis_tpu.parallel import manifest as jm
    gal = tmp_path / "gal"
    gal.mkdir()
    for i in range(10):
        (gal / f"t{i:02d}.dat").write_bytes(b"x" * (100 + i))
    m = build_manifest(str(gal))
    assert len(m) == 10 and m.names[0] == "t00"
    assert m.entries == jm.build_manifest(str(gal)).entries

    p = str(tmp_path / "manifest.json")
    save_manifest(m, p)
    assert not os.path.exists(p + ".tmp")
    assert load_manifest(p).entries == m.entries
    assert jm.load_manifest(p).entries == m.entries

    shards = [assign_shard(m, 4, h) for h in range(4)]
    names = [e["name"] for s in shards for e in s]
    assert sorted(names) == sorted(m.names) and len(set(names)) == 10
    assert shards == [jm.assign_shard(jm.load_manifest(p), 4, h)
                      for h in range(4)]
    with pytest.raises(ValueError):
        assign_shard(m, 4, 4)

    (gal / "t03.dat").unlink()
    (gal / "t05.dat").write_bytes(b"y" * 500)
    (gal / "t99.dat").write_bytes(b"z")
    drift = verify_manifest(m)
    assert drift == dict(missing=["t03"], changed=["t05"], new=["t99"])
    assert drift == jm.verify_manifest(jm.load_manifest(p))

    plan = reshard_plan(m, 4, surviving=[0, 1, 3])
    renames = [e["name"] for s in plan.values() for e in s]
    assert sorted(renames) == sorted(m.names)
    assert plan == jm.reshard_plan(jm.load_manifest(p), 4, surviving=[0, 1, 3])
    with pytest.raises(ValueError):
        reshard_plan(m, 4, surviving=[])


def test_initialize_multihost_maps_the_environment(monkeypatch):
    """The JAX package's variables become init_process_group's arguments,
    the backend follows the device; one process initializes nothing."""
    from msu_latentafis_tpu_torch.parallel import distributed
    calls = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setenv("AFIS_NUM_PROCESSES", "1")
    initialize_multihost(device="cpu")
    assert calls == []
    monkeypatch.setenv("AFIS_NUM_PROCESSES", "2")
    monkeypatch.setenv("AFIS_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("AFIS_PROCESS_ID", "1")
    initialize_multihost(device="cpu")
    assert calls == [(("gloo",), dict(init_method="tcp://10.0.0.1:1234",
                                      world_size=2, rank=1))]
    assert distributed.backend_for("cuda") == "nccl"
    with pytest.raises(ValueError):
        distributed.backend_for("meta")
