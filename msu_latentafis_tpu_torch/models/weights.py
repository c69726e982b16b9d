"""Weights carried over from the JAX package's Flax variables.

Counterpart of the JAX package's ``models_bundle._try_restore`` /
``save_checkpoint``. The port never reads Orbax (its reader imports JAX):
it reads one ``.npz`` per net, keyed by the Flax variable paths
(``params/ConvBNRelu_0/Conv_0/kernel``, ``batch_stats/.../mean``), which a
few lines of Python beside the JAX package write from a restored
checkpoint (README, "Weights"). An empty path gives the seeded init; a path
that is given but cannot be read raises (the JAX package's ``_try_restore``
returns the random init on any failure).

Each net names, for every Flax module path, the torch module that takes
its variables (``flax_modules()``); the layouts are:
- ``Conv`` kernel [kh, kw, in, out] -> ``Conv2d.weight`` [out, in, kh, kw];
- ``ConvTranspose`` (``transpose_kernel=False``) kernel [kh, kw, in, out]
  -> ``ConvTranspose2d.weight`` [in, out, kh, kw], flipped in both spatial
  axes (Flax correlates the dilated input with the kernel as it is,
  PyTorch with the kernel flipped);
- ``Dense`` kernel [in, out] -> ``Linear.weight`` [out, in];
- ``BatchNorm`` scale / bias / mean / var -> weight / bias / running_mean /
  running_var (eps 1e-5, Flax's default).
A Flax leaf that no module takes, or a module left without one, raises.
"""
from __future__ import annotations

import contextlib
import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

BN_EPS = 1e-5            # flax.linen.BatchNorm's default epsilon


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """A nested Flax variable tree (or an already flat one) ->
    {"params/Mod_0/kernel": f32 array}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def unflatten(flat: Mapping) -> dict:
    """{"a/b/c": array} -> {"a": {"b": {"c": array}}}."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *heads, leaf = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def _leaves(mod: nn.Module) -> list:
    """(collection, Flax leaf, torch attribute, to torch, to Flax) of one
    module kind."""
    if isinstance(mod, nn.ConvTranspose2d):
        return [("params", "kernel", "weight",
                 lambda k: np.flip(k, (0, 1)).transpose(2, 3, 0, 1),
                 lambda w: np.flip(w.transpose(2, 3, 0, 1), (0, 1))),
                ("params", "bias", "bias", None, None)]
    if isinstance(mod, nn.Conv2d):
        return [("params", "kernel", "weight",
                 lambda k: k.transpose(3, 2, 0, 1),
                 lambda w: w.transpose(2, 3, 1, 0)),
                ("params", "bias", "bias", None, None)]
    if isinstance(mod, nn.Linear):
        return [("params", "kernel", "weight", np.transpose, np.transpose),
                ("params", "bias", "bias", None, None)]
    if isinstance(mod, nn.modules.batchnorm._BatchNorm):
        return [("params", "scale", "weight", None, None),
                ("params", "bias", "bias", None, None),
                ("batch_stats", "mean", "running_mean", None, None),
                ("batch_stats", "var", "running_var", None, None)]
    raise TypeError(f"no Flax layout for {type(mod).__name__}")


def load_flax(net: nn.Module, variables: Mapping) -> nn.Module:
    """Copy Flax variables into ``net`` (which has ``flax_modules()``), in
    eval mode. Raises on a leaf no module takes or a module left without a
    leaf, and on a shape that does not fit."""
    flat = flatten(variables)
    with torch.no_grad():
        for path, mod in net.flax_modules().items():
            for coll, leaf, attr, to_torch, _ in _leaves(mod):
                target = getattr(mod, attr)
                if target is None:
                    continue
                key = f"{coll}/{path}/{leaf}"
                if key not in flat:
                    raise RuntimeError(f"Flax variables lack {key}")
                value = flat.pop(key)
                if to_torch is not None:
                    value = to_torch(value)
                value = torch.tensor(np.ascontiguousarray(value))
                if value.shape != target.shape:
                    raise ValueError(f"{key}: shape {tuple(value.shape)} != "
                                     f"{tuple(target.shape)}")
                target.copy_(value)
    if flat:
        raise ValueError(f"Flax variables with no counterpart in "
                         f"{type(net).__name__}: {sorted(flat)}")
    return net.eval()


def to_flax(net: nn.Module) -> dict:
    """The nested Flax variable tree (numpy) of ``net``'s parameters and
    running statistics: the inverse of ``load_flax``."""
    flat = {}
    for path, mod in net.flax_modules().items():
        for coll, leaf, attr, _, to_flax_ in _leaves(mod):
            t = getattr(mod, attr)
            if t is None:
                continue
            value = t.detach().cpu().numpy()
            if to_flax_ is not None:
                value = to_flax_(value)
            flat[f"{coll}/{path}/{leaf}"] = np.ascontiguousarray(
                value, np.float32)
    return unflatten(flat)


def save_npz(path: str, variables: Mapping) -> None:
    """Write a Flax variable tree as one ``.npz`` keyed by its paths."""
    np.savez(path, **flatten(variables))


def load_npz(path: str) -> dict:
    """The nested Flax variable tree of a ``.npz`` that ``save_npz`` wrote.
    Raises if the file is missing or unreadable."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no weight file {path!r}")
    with np.load(path, allow_pickle=False) as z:
        return unflatten({k: z[k] for k in z.files})


@contextlib.contextmanager
def seeded(seed: int):
    """Torch's initializers inside draw from the CPU generator seeded with
    ``seed``; its state is restored after."""
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        yield
