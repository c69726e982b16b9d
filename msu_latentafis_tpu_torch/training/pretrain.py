"""Stand-in model pretraining on synthetic ridge data.

Counterpart of the JAX package's ``training/pretrain.py``. The reference
implementation ships no weights, so stand-ins are trained from the
synthetic fingerprint prior (``training.synthetic_data``): the
enhancement net learns to undo latent clutter, the minutiae nets learn
cylinder regression on planted minutiae, the descriptor net learns
identity-discriminative embeddings across enhancement domains, and CompNet
learns a 192 -> 96 projection that keeps the cosine structure.

Run: ``python -m msu_latentafis_tpu_torch.training.pretrain --out DIR
[--steps N] [--which all|minutiae|minutiae64|enhancement|descriptor|compnet]
[--resume] [--device cpu]``. It writes one ``.npz`` per net in the Flax
layout (``models.weights.save_npz``): ``minutiae``, ``minutiae_stft``,
``minutiae64``, ``enhancement``, ``descriptor_patch{2,8,11}`` and
``compnet``; ``config_paths(DIR)`` names them by the config fields that
``ModelBundle.initialize`` reads. The nets train on ``--device`` (the card
by default; without one that raises, there is no CPU fallback);
``PRETRAIN_CPU=1`` means ``--device cpu``. ``PRETRAIN_PRECISION`` naming
a lower precision than f32 allows TF32 (``training.trainer``);
``PRETRAIN_TARGET_GAIN``
scales the minutiae targets (3.0); ``PRETRAIN_POOL_DIR`` caches the pools
as ``.npz`` (the JAX package's file names and layout);
``PRETRAIN_STREAM_DIR`` streams descriptor batches from the shards that
``scripts/gen_descriptor_pool.py`` writes. ``--resume`` continues each
net from its file in DIR where there is one (the optimizer restarts); a
file that is there and cannot be read raises.
"""
from __future__ import annotations

import argparse
import glob
import os
import time
import numpy as np
import torch

from ..models.compnet import CompNet
from ..models.descriptor_net import DescriptorNet
from ..models.enhancement import EnhancementAEC
from ..models.minutiae_net import MinutiaeAEC, MinutiaeAEC64
from ..models.weights import load_flax, load_npz, save_npz, seeded
from ..utils.precision import f32_compute
from .synthetic_data import (synthetic_descriptor_batch,
                             synthetic_latent_sample,
                             synthetic_minutiae_sample)
from .trainer import (create_train_state, l2_train_step, normalized,
                      standard_layout, train_step, triplet_train_step)

NETS = ("minutiae", "minutiae64", "enhancement", "descriptor", "compnet")
# file written -> the config field that names it
FILES = {"enhancement": "EnhancementModel",
         "minutiae_stft": "MinutiaeExtractionModelLatentSTFT",
         "minutiae": "MinutiaeExtractionModel",
         "minutiae64": "MinutiaeExtractionModelRolled",
         "descriptor_patch2": "DescriptorModelPatch2",
         "descriptor_patch8": "DescriptorModelPatch8",
         "descriptor_patch11": "DescriptorModelPatch11",
         "compnet": "DimensionalityReductionModel"}
DESCRIPTOR_MIN_STEPS = 100


def config_paths(out: str) -> dict:
    """{config field: ``out/<net>.npz``} for ``AfisConfig(**...)``."""
    return {field: os.path.join(out, name + ".npz")
            for name, field in FILES.items()}


def check_device(device) -> torch.device:
    """The device to train on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (or set "
                           "PRETRAIN_CPU=1) to train on the CPU")
    return dev


def _nchw(a: np.ndarray, device) -> torch.Tensor:
    return standard_layout(torch.as_tensor(np.asarray(a, np.float32),
                                           device=device).permute(0, 3, 1, 2))


def _pool_cache(name: str, builder):
    """The pool ``builder`` makes, cached as ``PRETRAIN_POOL_DIR/name.npz``
    where that variable is set."""
    root = os.environ.get("PRETRAIN_POOL_DIR", "")
    if not root:
        return builder()
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, name + ".npz")
    if os.path.exists(path):
        z = np.load(path)
        return tuple(z[k] for k in sorted(z.files))
    out = builder()
    np.savez(path, **{f"a{i}": a for i, a in enumerate(out)})
    return out


def _maybe_resume(model, resume_from: str):
    """The weights of ``resume_from`` (a ``.npz`` of this net) where the file
    exists; a fresh start where it does not. A file that cannot be read, or
    does not fit the net, raises."""
    if not resume_from or not os.path.exists(resume_from):
        return model
    load_flax(model, load_npz(resume_from))
    print(f"resumed weights from {resume_from}", flush=True)
    return model


def _timed_pool(name: str, builder):
    t0 = time.perf_counter()
    pool = _pool_cache(name, builder)
    return pool, time.perf_counter() - t0


def _run(state, steps: int, step_of, label: str, log_every: int,
         fmt: str, device, extra_log=None) -> dict:
    """``steps`` steps of ``step_of(i) -> (state, loss)``; the losses, the
    seconds of the loop (synced)."""
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        state, loss = step_of(i)
        losses.append(loss)
        if i % log_every == 0:
            msg = f"{label} step {i}: loss {float(loss):{fmt}}"
            if extra_log is not None:
                msg += extra_log(i)
            print(msg, flush=True)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    step_s = time.perf_counter() - t0
    return {"losses": torch.stack(losses).tolist() if losses else [],
            "step_s": step_s}


def pretrain_minutiae(steps: int = 300, batch: int = 16, size: int = 128,
                      nf: int = 64, seed: int = 0, log_every: int = 50,
                      pool: int = 256, resume_from: str = "",
                      net_cls=None, device="cuda"):
    """-> (model, Flax variables, {"losses", "pool_s", "step_s"}). The net
    is ``net_cls(nf)`` (MinutiaeAEC, the default, or MinutiaeAEC64),
    seeded with ``seed``."""
    device = check_device(device)
    rng = np.random.default_rng(seed)
    with seeded(seed):
        model = (net_cls or MinutiaeAEC)(nf=nf)
    model = _maybe_resume(model.to(device), resume_from)
    state = create_train_state(model)
    print("generating minutiae training pool...", flush=True)

    def build():
        # the deployment's input domains: STFT-enhanced (latent path),
        # cartoon texture (rolled path) and raw ridge images
        domains = ["stft", "stft", "cartoon", "none"]
        data = [synthetic_minutiae_sample(rng, size=size,
                                          n_minutiae=int(rng.integers(4, 14)),
                                          preprocess=domains[i % len(domains)],
                                          device=device)
                for i in range(pool)]
        return (np.stack([d[0] for d in data]) / 128.0 - 1.0,
                np.stack([d[1] for d in data]))

    (xs_all, ys_all), pool_s = _timed_pool(
        f"minutiae_v4_{size}_{pool}_{seed}", build)
    # the decode thresholds assume confident heatmap peaks; an L2-regressed
    # stand-in undershoots the unit-peak cylinders, so the targets are
    # amplified (the JAX package's stand-in calibration)
    gain = float(os.environ.get("PRETRAIN_TARGET_GAIN", "3.0"))
    xs = _nchw(xs_all, device)
    ys = _nchw((gain * ys_all).astype(np.float32), device)

    def step_of(i):
        idx = torch.as_tensor(rng.integers(0, pool, batch), device=device)
        return l2_train_step(state, xs[idx], ys[idx])

    info = _run(state, steps, step_of, "minutiae", log_every, ".1f", device)
    return model, state.variables(), dict(info, pool_s=pool_s)


def pretrain_enhancement(steps: int = 300, batch: int = 16, size: int = 128,
                         seed: int = 0, log_every: int = 50,
                         pool: int = 384, resume_from: str = "",
                         device="cuda"):
    """-> (model, Flax variables, {"losses", "pool_s", "step_s"})."""
    from ..ops.fft import fast_cartoon_texture, stft_enhance
    device = check_device(device)
    rng = np.random.default_rng(seed)
    with seeded(seed):
        model = EnhancementAEC()
    model = _maybe_resume(model.to(device), resume_from)
    state = create_train_state(model)
    print("generating enhancement training pool...", flush=True)

    def build():
        # the deployment path: latent-style clutter -> cartoon texture ->
        # STFT; the target is the clean ridge structure
        data = [synthetic_latent_sample(rng, size=size) for _ in range(pool)]
        raws = np.stack([stft_enhance(fast_cartoon_texture(torch.as_tensor(
            d[0], dtype=torch.float32, device=device))).cpu().numpy()
            [:, :, None] for d in data])
        return raws, np.stack([d[1] for d in data])

    (raws, targets), pool_s = _timed_pool(
        f"enhance_lat4_{size}_{pool}_{seed}", build)
    print(f"pool ready: {raws.shape}; stepping...", flush=True)
    xs, ys = _nchw(raws, device), _nchw(targets, device)

    def step_of(i):
        # brightness / contrast jitter, drawn on the host in the JAX order
        idx = torch.as_tensor(rng.integers(0, len(raws), batch),
                              device=device)
        b = torch.as_tensor((rng.random((batch, 1, 1, 1)) - 0.5) * 50.0,
                            dtype=torch.float32, device=device)
        c = torch.as_tensor(rng.random((batch, 1, 1, 1)) + 0.5,
                            dtype=torch.float32, device=device)
        x = (xs[idx] + b) * c / 128.0 - 1.0
        return l2_train_step(state, x, ys[idx])

    info = _run(state, steps, step_of, "enhancement", log_every, ".1f",
                device)
    return model, state.variables(), dict(info, pool_s=pool_s)


class _ShardStream:
    """Random access over the shard directory ``gen_descriptor_pool``
    fills: each request picks a uniformly random (shard, row) over every
    shard seen so far; the file list is rescanned every ``rescan_every``
    requests, so shards written while training runs join the pool."""

    def __init__(self, root: str, rescan_every: int = 50,
                 cache_shards: int = 512):
        self.root = root
        self.rescan_every = rescan_every
        self.cache_shards = cache_shards
        self._files: list = []
        self._cache: dict = {}
        self._calls = 0
        self._rescan()
        if not self._files:
            raise FileNotFoundError(f"no shards in {root}")

    def _rescan(self):
        self._files = sorted(glob.glob(os.path.join(self.root,
                                                    "shard_*.npz")))

    def sample(self, rng: np.random.Generator):
        self._calls += 1
        if self._calls % self.rescan_every == 0:
            self._rescan()
        path = self._files[int(rng.integers(0, len(self._files)))]
        if path not in self._cache:
            if len(self._cache) >= self.cache_shards:
                self._cache.pop(next(iter(self._cache)))
            with np.load(path) as z:
                self._cache[path] = (z["x"], z["y"])
        x, y = self._cache[path]
        k = int(rng.integers(0, len(x)))
        return x[k], y[k]


def eval_embed(model, xs_ev, ys_ev, device):
    """Held-out retrieval health: recall@1 (the nearest neighbour shares
    the label) and the mean positive / negative cosine."""
    embs, labs = [], []
    for x, y in zip(xs_ev, ys_ev):
        with torch.inference_mode(), f32_compute():
            e = model(_nchw(x, device)).cpu().numpy()
        e /= np.linalg.norm(e, axis=1, keepdims=True) + 1e-8
        sim = e @ e.T
        np.fill_diagonal(sim, -2.0)
        nn_lab = y[np.argmax(sim, axis=1)]
        same = y[:, None] == y[None, :]
        np.fill_diagonal(same, False)
        embs.append(float(np.mean(nn_lab == y)))
        pos = sim[same].mean()
        neg = sim[(~same) & (sim > -2)].mean()
        labs.append((pos, neg))
    pos = float(np.mean([p for p, _ in labs]))
    neg = float(np.mean([n for _, n in labs]))
    return float(np.mean(embs)), pos, neg


def pretrain_descriptor(steps: int = 200, seed: int = 0, log_every: int = 50,
                        resume_from: str = "", device="cuda"):
    """-> (model, Flax variables, {"losses", "pool_s", "step_s"}). The
    held-out set of a streamed run is drawn from the same stream as the
    training batches, as in the JAX package (ROADMAP Queue 3)."""
    device = check_device(device)
    rng = np.random.default_rng(seed)
    with seeded(seed):
        model = DescriptorNet()
    model = _maybe_resume(model.to(device), resume_from)
    state = create_train_state(model)

    stream_dir = os.environ.get("PRETRAIN_STREAM_DIR", "")
    eval_set = None
    pool_s = 0.0
    if stream_dir:
        stream = _ShardStream(stream_dir)
        print(f"streaming descriptor batches from {stream_dir} "
              f"({len(stream._files)} shards)", flush=True)
        draw = lambda: stream.sample(rng)  # noqa: E731
        ev_rng = np.random.default_rng(seed + 777)
        ev = [stream.sample(ev_rng) for _ in range(4)]
        eval_set = ([x for x, _ in ev], [y for _, y in ev])
    else:
        print("generating descriptor training pool...", flush=True)

        def build():
            # 16 identities a batch: the triplet mining needs hard
            # negatives inside it
            data = [synthetic_descriptor_batch(
                rng, n_ids=16, samples_per_id=4, device=device)
                for _ in range(128)]
            return (np.stack([d[0] for d in data]),
                    np.stack([d[1] for d in data]))

        (xs, ys), pool_s = _timed_pool(f"descriptor_v8_{seed}", build)
        draw = lambda: (lambda k: (xs[k], ys[k]))(  # noqa: E731
            int(rng.integers(0, len(xs))))

    def step_of(i):
        x, y = draw()
        # photometric jitter per step, fresh even where a batch repeats
        x = x * float(rng.uniform(0.8, 1.2)) + float(rng.uniform(-0.15, 0.15))
        x = x + rng.standard_normal(x.shape).astype(np.float32) \
            * float(rng.uniform(0.0, 0.08))
        return triplet_train_step(state, _nchw(x, device),
                                  torch.as_tensor(y, device=device))

    def heldout(i):
        if eval_set is None or i % (log_every * 4):
            return ""
        r1, pos, neg = eval_embed(model, *eval_set, device)
        return f"  heldout r@1 {r1:.3f} pos {pos:.3f} neg {neg:.3f}"

    info = _run(state, steps, step_of, "descriptor", log_every, ".3f",
                device, heldout)
    if eval_set is not None:
        r1, pos, neg = eval_embed(model, *eval_set, device)
        print(f"descriptor final: heldout r@1 {r1:.3f} pos {pos:.3f} "
              f"neg {neg:.3f}", flush=True)
        info["heldout"] = (r1, pos, neg)
    return model, state.variables(), dict(info, pool_s=pool_s)


def cosine_structure_loss(z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Mean squared gap between the pairwise cosine matrices of the
    outputs and of the inputs (the DR training objective without
    distillation)."""
    zn, xn = normalized(z), normalized(x)
    return torch.mean((zn @ zn.T - xn @ xn.T) ** 2)


def compnet_train_step(state, x: torch.Tensor):
    return train_step(state, lambda z: cosine_structure_loss(z, x), x)


def pretrain_compnet(steps: int = 500, batch: int = 256, seed: int = 0,
                     log_every: int = 100, device="cuda"):
    """-> (model, Flax variables, {"losses", "pool_s", "step_s"}): unit
    192-d rows drawn fresh each step."""
    device = check_device(device)
    rng = np.random.default_rng(seed)
    with seeded(seed):
        model = CompNet().to(device)
    state = create_train_state(model)

    def step_of(i):
        x = rng.standard_normal((batch, 192)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return compnet_train_step(state, torch.as_tensor(x, device=device))

    info = _run(state, steps, step_of, "compnet", log_every, ".4f", device)
    return model, state.variables(), dict(info, pool_s=0.0)


def main(argv=None, **cuts) -> dict:
    """The entry point. ``cuts`` maps a net of NETS to a smaller ``pool``
    or ``steps`` for its pretrain function than the defaults and the
    command line give. -> {net: info}."""
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True, help="weight file directory")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--which", default="all", choices=("all",) + NETS)
    p.add_argument("--resume", action="store_true",
                   help="continue each net from its .npz in --out")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = check_device("cpu" if os.environ.get("PRETRAIN_CPU") == "1"
                          else args.device)
    os.makedirs(args.out, exist_ok=True)
    unknown = set(cuts) - set(NETS)
    if unknown:
        raise ValueError(f"no net {sorted(unknown)}")
    for net, cut in cuts.items():
        if set(cut) - {"pool", "steps"} or (
                "pool" in cut and net in ("descriptor", "compnet")):
            raise ValueError(f"{net}: no cut {sorted(cut)}")
    path = lambda name: os.path.join(args.out, name + ".npz")  # noqa: E731
    res = lambda name: path(name) if args.resume else ""  # noqa: E731
    kw = lambda net, **d: dict(d, device=device, **cuts.get(net, {}))  # noqa: E731
    infos = {}
    t0 = time.time()
    if args.which in ("all", "minutiae"):
        _, v, infos["minutiae"] = pretrain_minutiae(
            **kw("minutiae", steps=args.steps, resume_from=res("minutiae")))
        save_npz(path("minutiae"), v)
        save_npz(path("minutiae_stft"), v)
    if args.which in ("all", "minutiae64"):
        _, v, infos["minutiae64"] = pretrain_minutiae(
            **kw("minutiae64", steps=args.steps, size=64,
                 net_cls=MinutiaeAEC64, resume_from=res("minutiae64")))
        save_npz(path("minutiae64"), v)
    if args.which in ("all", "enhancement"):
        _, v, infos["enhancement"] = pretrain_enhancement(
            **kw("enhancement", steps=args.steps,
                 resume_from=res("enhancement")))
        save_npz(path("enhancement"), v)
    if args.which in ("all", "descriptor"):
        # steps 0 builds (and caches) the pool only: its random-init
        # weights are not saved over trained ones
        _, v, infos["descriptor"] = pretrain_descriptor(
            **kw("descriptor",
                 steps=max(DESCRIPTOR_MIN_STEPS, args.steps // 2)
                 if args.steps else 0,
                 resume_from=res("descriptor_patch2")))
        if args.steps:
            for pt in (2, 8, 11):
                save_npz(path(f"descriptor_patch{pt}"), v)
    if args.which in ("all", "compnet"):
        _, v, infos["compnet"] = pretrain_compnet(
            **kw("compnet", steps=args.steps))
        save_npz(path("compnet"), v)
    print(f"pretraining done in {time.time() - t0:.0f}s -> {args.out}")
    return infos


if __name__ == "__main__":
    main()
