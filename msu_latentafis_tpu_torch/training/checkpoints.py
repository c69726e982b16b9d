"""Checkpoint management for training runs.

Counterpart of the JAX package's ``training/checkpoints.py`` (after the
reference implementation's checkpoints.py and the Tensorpack ModelSaver
flow, minutiae_AEC.py:775-790): periodic saves, restore of the latest or
the best. ``meta.json`` keeps the JAX package's semantics (``steps``,
``best``, ``best_metric``; a lower metric is better; the last ``keep``
steps and the best are kept, the rest pruned). A checkpoint is
``step_XXXXXXXX.npz``: the variable tree it is given, flattened to its
paths (``models.weights.save_npz``), never Orbax.
"""
from __future__ import annotations

import json
import os
from typing import Any, Mapping, Optional

import numpy as np

from ..models.weights import flatten, load_npz, save_npz


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self._meta_path = os.path.join(self.directory, "meta.json")

    def _meta(self) -> dict:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                return json.load(f)
        return {"steps": [], "best": None, "best_metric": None}

    def _write_meta(self, meta: dict) -> None:
        with open(self._meta_path, "w") as f:
            json.dump(meta, f)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.npz")

    def save(self, step: int, variables: Mapping,
             metric: Optional[float] = None) -> str:
        path = self.path(step)
        tmp = path[:-4] + ".tmp.npz"
        save_npz(tmp, variables)
        os.replace(tmp, path)
        meta = self._meta()
        meta["steps"].append(step)
        if metric is not None and (meta["best_metric"] is None
                                   or metric < meta["best_metric"]):
            meta["best"] = step
            meta["best_metric"] = metric
        keepers = set(meta["steps"][-self.keep:])
        if meta["best"] is not None:
            keepers.add(meta["best"])
        for s in list(meta["steps"]):
            if s not in keepers:
                if os.path.exists(self.path(s)):
                    os.remove(self.path(s))
                meta["steps"].remove(s)
        self._write_meta(meta)
        return path

    def latest_step(self) -> Optional[int]:
        meta = self._meta()
        return meta["steps"][-1] if meta["steps"] else None

    def restore(self, target: Any = None, step: Optional[int] = None) -> Any:
        """The tree saved at ``step`` (the latest by default); ``target``
        when nothing was saved. Given a ``target``, the restored tree must
        have its paths and shapes."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return target
        tree = load_npz(self.path(step))
        if target is not None:
            want = {k: np.shape(v) for k, v in flatten(target).items()}
            got = {k: v.shape for k, v in flatten(tree).items()}
            bad = sorted(k for k in set(want) | set(got)
                         if want.get(k) != got.get(k))
            if bad:
                raise ValueError(f"checkpoint {self.path(step)} does not "
                                 f"fit the target at {bad}")
        return tree

    def restore_best(self, target: Any = None) -> Any:
        meta = self._meta()
        if meta["best"] is None:
            return self.restore(target)
        return self.restore(target, meta["best"])
