"""The port's data layer (igm_tpu_torch.data) against igm_tpu's: the same
arrays, the same batch order, the same pickle parsing; and the prefetcher."""
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from igm_tpu.data.cifar10 import CIFAR10DataModule as JaxCIFAR  # noqa: E402
from igm_tpu.data.loader import epoch_batches as jax_epoch_batches  # noqa: E402
from igm_tpu_torch.data.cifar10 import CIFAR10DataModule  # noqa: E402
from igm_tpu_torch.data.loader import DevicePrefetcher, epoch_batches  # noqa: E402

torch.set_num_threads(1)


def _setup(cls, data_dir, **kw):
    dm = cls(data_dir=str(data_dir), channels=3, width=32, height=32,
             batch_size=32, **kw)
    dm.prepare_data()
    dm.setup()
    return dm


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_arrays_are_byte_identical(tmp_path, monkeypatch, split):
    monkeypatch.setenv("IGM_SYNTHETIC_DATA", "1")
    ours = getattr(_setup(CIFAR10DataModule, tmp_path), f"{split}_arrays")()
    theirs = getattr(_setup(JaxCIFAR, tmp_path), f"{split}_arrays")()
    assert ours[0].dtype == np.uint8 and ours[0].shape[1:] == (32, 32, 3)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_missing_files_raise_without_synthetic(tmp_path, monkeypatch):
    monkeypatch.setenv("IGM_SYNTHETIC_DATA", "0")
    with pytest.raises(FileNotFoundError):
        _setup(CIFAR10DataModule, tmp_path)


def _write_cifar(root: Path, seed: int):
    """The dataset's python-pickle layout: (N, 3072) planes R|G|B, labels."""
    rng = np.random.default_rng(seed)
    bdir = root / "cifar-10-batches-py"
    bdir.mkdir(parents=True)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        data = rng.integers(0, 256, (7, 3072), dtype=np.uint8)
        labels = rng.integers(0, 10, 7).tolist()
        with open(bdir / name, "wb") as fh:
            pickle.dump({b"data": data, b"labels": labels}, fh)


def test_cifar_pickle_parser_matches(tmp_path, monkeypatch):
    monkeypatch.setenv("IGM_SYNTHETIC_DATA", "0")
    _write_cifar(tmp_path, 0)
    ours, theirs = _setup(CIFAR10DataModule, tmp_path), _setup(JaxCIFAR, tmp_path)
    for split in ("train_arrays", "val_arrays"):
        for a, b in zip(getattr(ours, split)(), getattr(theirs, split)()):
            np.testing.assert_array_equal(a, b)
    imgs, labels = ours.train_arrays()
    assert imgs.shape == (35, 32, 32, 3) and labels.dtype == np.int32
    with open(tmp_path / "cifar-10-batches-py" / "data_batch_1", "rb") as fh:
        raw = pickle.load(fh, encoding="bytes")
    # planes -> NHWC: pixel (0, 0) of image 0 is (R, G, B) at 0, 1024, 2048
    np.testing.assert_array_equal(imgs[0, 0, 0], raw[b"data"][0, [0, 1024, 2048]])


def test_epoch_batches_follow_igm_tpu_order():
    """One generator across epochs, one permutation per epoch, as the
    trainers of both packages draw them."""
    rng = np.random.default_rng(0)
    arrays = (rng.integers(0, 256, (50, 2, 2, 1), np.uint8),
              np.arange(50, dtype=np.int32))
    ours, theirs = np.random.default_rng(42), np.random.default_rng(42)
    for _ in range(2):
        got = list(epoch_batches(arrays, 8, rng=ours, shuffle=True, limit=4))
        want = list(jax_epoch_batches(arrays, 8, rng=theirs, shuffle=True, limit=4))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    plain = list(epoch_batches(arrays, 16))
    assert len(plain) == 3 and plain[0][1].tolist() == list(range(16))


def test_prefetcher_on_cpu_yields_the_batches():
    batches = [(np.full((2, 3), i, np.uint8), np.array([i, i], np.int32))
               for i in range(5)]
    got = list(DevicePrefetcher(iter(batches), torch.device("cpu")))
    assert len(got) == 5
    for i, (imgs, labels) in enumerate(got):
        assert imgs.dtype == torch.uint8 and int(imgs[0, 0]) == i
        assert labels.tolist() == [i, i]


def test_prefetcher_reraises_a_worker_failure():
    def broken():
        yield (np.zeros((1,), np.uint8),)
        raise OSError("disk gone")

    it = DevicePrefetcher(broken(), torch.device("cpu"))
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
