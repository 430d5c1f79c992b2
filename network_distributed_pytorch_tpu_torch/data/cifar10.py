"""CIFAR-10 from disk, or a deterministic synthetic stand-in.

Reads both on-disk forms, the ``cifar-10-batches-py`` pickle batches and the
``cifar-10-batches-bin`` binary records, normalises with the reference's
``Normalize((.5,.5,.5), (.5,.5,.5))`` and returns NHWC float32, as the JAX
package's ``data/cifar10.py`` does. The binary form is decoded by the
native runtime (``native.decode_cifar10_bin``, numpy where it is off), in
place into one preallocated array. ``synthetic_cifar10`` makes the same numpy calls in the same order as
the JAX package's, so its draws are bit-identical.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

_MEAN = 0.5
_STD = 0.5


def _normalize(images_u8: np.ndarray) -> np.ndarray:
    return ((images_u8.astype(np.float32) / 255.0) - _MEAN) / _STD


def cifar10_on_disk(data_dir: str = "./data", train: Optional[bool] = None) -> Optional[str]:
    """Path of a usable extracted CIFAR-10 directory (pickle or binary form)
    holding the split asked for (``None``: either)."""
    for name, suffix in (("cifar-10-batches-py", ""), ("cifar-10-batches-bin", ".bin")):
        p = os.path.join(data_dir, name)
        train_files = [f"data_batch_{i}{suffix}" for i in range(1, 6)]
        test_files = [f"test_batch{suffix}"]
        candidates = (
            [train_files, test_files] if train is None else [train_files if train else test_files]
        )
        if any(all(os.path.isfile(os.path.join(p, f)) for f in files) for files in candidates):
            return p
    return None


def _load_pickle_batches(base: str, names) -> Tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    for name in names:
        # the CIFAR-10 python batches are pickles; only files the dataset's
        # own layout names are opened
        with open(os.path.join(base, name), "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        xs.append(np.asarray(entry["data"], dtype=np.uint8))
        ys.append(np.asarray(entry["labels"], dtype=np.int32))
    data = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NCHW -> NHWC
    return _normalize(data), np.concatenate(ys)


def _load_bin_batches(base: str, names) -> Tuple[np.ndarray, np.ndarray]:
    """``cifar-10-batches-bin`` records: ``[label u8][3072 CHW bytes]``,
    decoded and normalised (as :func:`_normalize`) by the native runtime.
    One preallocated output: each file decodes in place into its slice
    (a slice of the outer axis of a C-contiguous array is contiguous), with
    no concatenation and no float32 temporary a file."""
    from ..native import decode_cifar10_bin

    raws = []
    for name in names:
        raw = np.fromfile(os.path.join(base, name), dtype=np.uint8)
        if raw.size == 0 or raw.size % 3073 != 0:
            raise ValueError(
                f"{name}: {raw.size} bytes is not a positive whole number of 3073-byte records"
            )
        raws.append(raw.reshape(-1, 3073))
    total = sum(r.shape[0] for r in raws)
    images = np.empty((total, 32, 32, 3), np.float32)
    labels = np.empty((total,), np.int32)
    at = 0
    for raw in raws:
        n = raw.shape[0]
        decode_cifar10_bin(
            raw, mean=_MEAN, std=_STD, out_images=images[at : at + n], out_labels=labels[at : at + n]
        )
        at += n
    return images, labels


def load_cifar10(data_dir: str = "./data", train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(images NHWC float32 normalised, labels int32); raises if absent."""
    base = cifar10_on_disk(data_dir, train=train)
    if base is None:
        raise FileNotFoundError(
            f"CIFAR-10 not found under {data_dir!r} "
            "(expected cifar-10-batches-py/ or cifar-10-batches-bin/)"
        )
    if base.endswith("-bin"):
        names = [f"data_batch_{i}.bin" for i in range(1, 6)] if train else ["test_batch.bin"]
        return _load_bin_batches(base, names)
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    return _load_pickle_batches(base, names)


def synthetic_cifar10(
    n: int = 50000,
    seed: int = 0,
    num_classes: int = 10,
    class_sep: float = 0.5,
    noise: float = 0.25,
    label_noise: float = 0.0,
    return_means: bool = False,
):
    """Deterministic CIFAR-shaped class-blob data (32x32x3, normalised
    range), learnable by the real models.

    ``label_noise`` resamples that fraction of labels after the images are
    drawn (the pixels keep the original class's blob). ``return_means=True``
    appends the true class means, the inputs of the Bayes (nearest-mean)
    rule; it draws nothing more, so every draw is the same either way."""
    rng = np.random.RandomState(seed)
    means = rng.randn(num_classes, 32, 32, 3).astype(np.float32) * class_sep
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    images = means[labels] + noise * rng.randn(n, 32, 32, 3).astype(np.float32)
    if label_noise > 0.0:
        flip = rng.rand(n) < label_noise
        labels = np.where(flip, rng.randint(0, num_classes, size=n).astype(np.int32), labels)
    images = np.clip(images, -1.0, 1.0)
    if return_means:
        return images, labels, means
    return images, labels


def load_cifar10_or_synthetic(
    data_dir: str = "./data", train: bool = True, synthetic_n: int = 4096, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """(images, labels, is_real): real data when on disk, synthetic otherwise."""
    try:
        x, y = load_cifar10(data_dir, train)
        return x, y, True
    except FileNotFoundError:
        x, y = synthetic_cifar10(synthetic_n, seed=seed)
        return x, y, False
