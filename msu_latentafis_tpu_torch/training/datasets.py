"""Training datasets and the batching iterator.

Counterpart of the JAX package's ``training/datasets.py`` (after the
reference implementation's dataset zoo: filelist, folderlist, csvlist,
triplet, featpair, featarray, classload_pairs, transforms, and
dataloader.py), as NumPy iterators. BMP and PNG files are read by
``utils.image_io`` (the card's machine has no imageio); any other
extension by imageio, imported when such a file is read.
"""
from __future__ import annotations

import csv
import os
import random
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np


def imread(path: str) -> np.ndarray:
    """The array imageio gives for ``path``: [h, w] grey or [h, w, C]."""
    if path.lower().endswith((".bmp", ".png")):
        from ..utils.image_io import read_image
        return read_image(path)
    import imageio.v2 as imageio
    return np.asarray(imageio.imread(path))


class FileListDataset:
    """Images listed one per line (path [label]) (datasets/filelist.py)."""

    def __init__(self, list_file: str, root: str = "",
                 transform: Optional[Callable] = None):
        self.items: List[Tuple[str, int]] = []
        with open(list_file) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                label = int(parts[1]) if len(parts) > 1 else 0
                self.items.append((os.path.join(root, parts[0]), label))
        self.transform = transform

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        path, label = self.items[i]
        img = np.asarray(imread(path), np.float32)
        if img.ndim == 3:
            img = img @ np.array([0.299, 0.587, 0.114], np.float32)
        if self.transform:
            img = self.transform(img)
        return img, label


class FolderListDataset(FileListDataset):
    """One class per subdirectory (datasets/folderlist.py)."""

    def __init__(self, root: str, transform: Optional[Callable] = None,
                 extensions=(".png", ".bmp", ".jpg", ".jpeg")):
        self.items = []
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        for label, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(extensions):
                    self.items.append((os.path.join(cdir, f), label))
        self.transform = transform


class CsvListDataset(FileListDataset):
    """(path, label) rows of a CSV file (datasets/csvlist.py)."""

    def __init__(self, csv_file: str, root: str = "",
                 transform: Optional[Callable] = None,
                 path_col: int = 0, label_col: int = 1):
        self.items = []
        with open(csv_file) as f:
            for row in csv.reader(f):
                if not row:
                    continue
                self.items.append((os.path.join(root, row[path_col]),
                                   int(row[label_col])))
        self.transform = transform


class FeatArrayDataset:
    """An in-memory descriptor matrix (datasets/featarray.py; the DR
    stage's input, descriptor_DR.py:146)."""

    def __init__(self, features: np.ndarray):
        self.features = np.asarray(features, np.float32)

    def __len__(self):
        return len(self.features)

    def __getitem__(self, i):
        return self.features[i]


class FeatPairDataset:
    """Pairs of feature rows and a same / different label
    (datasets/featpair.py)."""

    def __init__(self, features: np.ndarray, labels: np.ndarray):
        self.features = np.asarray(features, np.float32)
        self.labels = np.asarray(labels)

    def __len__(self):
        return len(self.features)

    def sample_pairs(self, rng: np.random.Generator, n: int):
        idx_a = rng.integers(0, len(self.features), n)
        idx_b = rng.integers(0, len(self.features), n)
        same = (self.labels[idx_a] == self.labels[idx_b]).astype(np.int32)
        return (self.features[idx_a], self.features[idx_b], same)


class ClassPairsDataset:
    """Per-class ``.npy`` features (datasets/classload_pairs.py): one item
    per class, a [batch_size_per_class, ...] stack drawn through cycling
    shuffled iterators, so every file is visited before one repeats;
    index 0 comes from the "neg" stream and the rest from the "pos"
    stream."""

    def __init__(self, root: str, batch_size_per_class: int = 2,
                 if_norm: bool = False, seed: int = 0):
        self.batch = int(batch_size_per_class)
        self.if_norm = if_norm
        self._rng = np.random.default_rng(seed)
        self.by_class = {}
        for cls in sorted(os.listdir(root)):
            d = os.path.join(root, cls)
            if not os.path.isdir(d):
                continue
            files = sorted(os.path.join(d, f) for f in os.listdir(d)
                           if f.endswith(".npy"))
            if files:
                self.by_class[cls] = files
        if not self.by_class:
            raise RuntimeError(f"no per-class .npy files under {root}")
        self.classes = list(self.by_class)
        self._pos = {c: iter([]) for c in self.classes}
        self._neg = {c: iter([]) for c in self.classes}

    def _next(self, stream, cls):
        it = stream[cls]
        nxt = next(it, None)
        if nxt is None:
            order = self._rng.permutation(len(self.by_class[cls]))
            stream[cls] = it = iter(order.tolist())
            nxt = next(it)
        return self.by_class[cls][nxt]

    def __len__(self):
        return len(self.classes)

    def __getitem__(self, index):
        cls = self.classes[index]
        out = []
        for i in range(self.batch):
            path = self._next(self._neg if i == 0 else self._pos, cls)
            feat = np.load(path).astype(np.float32)
            if self.if_norm:
                feat = feat / (np.linalg.norm(feat) + 1e-8)
            out.append(feat)
        return np.stack(out), index


class TripletDataset:
    """(anchor, positive, negative) sampling by class (datasets/triplet.py
    and classload_pairs.py)."""

    def __init__(self, base):
        self.base = base
        self.by_label = {}
        for i, (_, label) in enumerate(getattr(base, "items", [])):
            self.by_label.setdefault(label, []).append(i)
        self.labels = [l for l, v in self.by_label.items() if len(v) >= 2]

    def sample(self, rng: random.Random):
        la = rng.choice(self.labels)
        lneg = rng.choice([l for l in self.labels if l != la])
        a, p = rng.sample(self.by_label[la], 2)
        n = rng.choice(self.by_label[lneg])
        return self.base[a][0], self.base[p][0], self.base[n][0]


# ---------------------------------------------------------------------------
# transforms (datasets/transforms.py)
# ---------------------------------------------------------------------------

def normalize(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 128.0 - 1.0


def random_crop(rng: np.random.Generator, size: int):
    def f(img):
        h, w = img.shape[:2]
        y = rng.integers(0, max(h - size, 0) + 1)
        x = rng.integers(0, max(w - size, 0) + 1)
        return img[y:y + size, x:x + size]
    return f


def random_flip(rng: np.random.Generator):
    def f(img):
        return img[:, ::-1] if rng.random() < 0.5 else img
    return f


def compose(*fns):
    def f(img):
        for fn in fns:
            img = fn(img)
        return img
    return f


# ---------------------------------------------------------------------------
# batching iterator (dataloader.py)
# ---------------------------------------------------------------------------

def batches(dataset, batch_size: int, rng: Optional[np.random.Generator] = None,
            shuffle: bool = True, drop_last: bool = True) -> Iterator:
    idx = np.arange(len(dataset))
    if shuffle and rng is not None:
        rng.shuffle(idx)
    end = len(idx) - (len(idx) % batch_size if drop_last else 0)
    for i in range(0, end, batch_size):
        chunk = [dataset[int(j)] for j in idx[i:i + batch_size]]
        if isinstance(chunk[0], tuple):
            cols = list(zip(*chunk))
            yield tuple(np.stack(c) for c in cols)
        else:
            yield np.stack(chunk)
