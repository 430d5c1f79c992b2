"""The PyTorch port's data modules against the JAX package's: the same
partition indices, bit-identical synthetic images, the same batch order,
and the same decoded CIFAR-10 from both on-disk forms."""

import os
import pickle

import numpy as np
import pytest

from network_distributed_pytorch_tpu.data import cifar10 as jax_cifar10
from network_distributed_pytorch_tpu.data import loader as jax_loader
from network_distributed_pytorch_tpu.data import partition as jax_partition
from network_distributed_pytorch_tpu_torch.data import cifar10, loader, partition


@pytest.mark.parametrize("n,world", [(100, 4), (4096, 2), (10, 3)])
def test_partition_indices_match_jax(n, world):
    data = list(range(n))
    for rank in range(world):
        ours = partition.partition_dataset(data, world, rank)
        ref = jax_partition.partition_dataset(data, world, rank)
        assert ours.index == ref.index
        assert [ours[i] for i in range(len(ours))] == [ref[i] for i in range(len(ref))]
    assert partition.split_indices(n, [0.7, 0.2, 0.1]) == jax_partition.split_indices(n, [0.7, 0.2, 0.1])
    assert partition.per_worker_batch_size(512, world) == jax_partition.per_worker_batch_size(512, world)


def test_synthetic_images_bit_identical_to_jax():
    for kw in ({}, {"label_noise": 0.2, "class_sep": 0.1}):
        ours = cifar10.synthetic_cifar10(257, seed=3, **kw)
        ref = jax_cifar10.synthetic_cifar10(257, seed=3, **kw)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    x, y, real = cifar10.load_cifar10_or_synthetic("/nonexistent", synthetic_n=64)
    xr, yr, realr = jax_cifar10.load_cifar10_or_synthetic("/nonexistent", synthetic_n=64)
    assert not real and not realr and np.array_equal(x, xr) and np.array_equal(y, yr)


@pytest.mark.parametrize("label_noise", [0.0, 0.15])
def test_synthetic_return_means_bit_identical_to_jax(label_noise):
    """``return_means=True`` appends the true class means and draws nothing
    more: the images and labels are those of the default call, and all three
    arrays are the JAX function's bit for bit."""
    kw = dict(seed=5, class_sep=0.5, label_noise=label_noise)
    ours = cifar10.synthetic_cifar10(300, return_means=True, **kw)
    ref = jax_cifar10.synthetic_cifar10(300, return_means=True, **kw)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ours[2].shape == (10, 32, 32, 3)
    plain = cifar10.synthetic_cifar10(300, **kw)
    assert len(plain) == 2
    assert np.array_equal(plain[0], ours[0]) and np.array_equal(plain[1], ours[1])


@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_order_matches_jax(drop_last):
    xs, ys = cifar10.synthetic_cifar10(100, seed=1)
    for epoch in range(2):
        assert np.array_equal(
            loader.epoch_order(100, 16, seed=5, epoch=epoch, drop_last=drop_last),
            jax_loader.epoch_order(100, 16, seed=5, epoch=epoch, drop_last=drop_last),
        )
        ours = list(loader.iterate_batches([xs, ys], 16, seed=5, epoch=epoch, drop_last=drop_last))
        ref = list(jax_loader.iterate_batches([xs, ys], 16, seed=5, epoch=epoch, drop_last=drop_last))
        assert len(ours) == len(ref) == loader.steps_per_epoch(100, 16, drop_last)
        for a, b in zip(ours, ref):
            assert all(np.array_equal(u, v) for u, v in zip(a, b))


def _write_fake_cifar(root, n=10):
    """Both on-disk forms of the same tiny dataset."""
    rng = np.random.RandomState(0)
    py, bn = os.path.join(root, "cifar-10-batches-py"), os.path.join(root, "cifar-10-batches-bin")
    os.makedirs(py)
    os.makedirs(bn)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rng.randint(0, 256, size=(n, 3072)).astype(np.uint8)
        labels = rng.randint(0, 10, size=n)
        with open(os.path.join(py, name), "wb") as f:
            pickle.dump({"data": data, "labels": list(labels)}, f)
        recs = np.concatenate([labels.astype(np.uint8)[:, None], data], axis=1)
        recs.tofile(os.path.join(bn, name + ".bin"))
    return py, bn


def test_pickle_and_binary_decoders_match_jax(tmp_path):
    py, bn = _write_fake_cifar(str(tmp_path))
    for train in (True, False):
        x, y = cifar10.load_cifar10(str(tmp_path), train=train)  # the pickle form is found first
        xr, yr = jax_cifar10.load_cifar10(str(tmp_path), train=train)
        assert x.shape[1:] == (32, 32, 3) and x.dtype == np.float32
        assert np.array_equal(x, xr) and np.array_equal(y, yr)
        names = [f"data_batch_{i}.bin" for i in range(1, 6)] if train else ["test_batch.bin"]
        xb, yb = cifar10._load_bin_batches(bn, names)
        assert np.array_equal(xb, x) and np.array_equal(yb, y)


def test_truncated_binary_record_raises(tmp_path):
    path = tmp_path / "bad.bin"
    np.zeros(3073 + 5, np.uint8).tofile(path)
    with pytest.raises(ValueError, match="3073"):
        cifar10._load_bin_batches(str(tmp_path), ["bad.bin"])
