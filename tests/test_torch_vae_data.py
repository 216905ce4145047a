"""The port's CelebA and dSprites datamodules against igm_tpu's, on files
that igm_tpu.data.packaged.ensure makes in tmp_path (scikit-learn's bundled
digit scans in each dataset's container): the arrays and the split, exactly;
the CelebA cache; and the port's own ``packaged.ensure`` through
``prepare_data``."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from igm_tpu.data import packaged as jax_packaged  # noqa: E402
from igm_tpu.data.celeba import CelebADataModule as JaxCelebA  # noqa: E402
from igm_tpu.data.dsprite import DataModule as JaxDSprites  # noqa: E402
from igm_tpu_torch.data.celeba import CelebADataModule  # noqa: E402
from igm_tpu_torch.data.dsprite import DataModule as DSprites  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    jax_packaged.ensure(root, celeba_n=40)
    return root


def _arrays(dm):
    dm.prepare_data()
    dm.setup()
    return dm.train_arrays(), dm.val_arrays()


def _equal(got, want):
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype == np.uint8 and gl.dtype == wl.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("size", [64, 32])
def test_celeba_arrays_equal_igm_tpus(files, tmp_path, monkeypatch, size):
    """Decoded (bicubic to size x size), then read back from the cache."""
    monkeypatch.setenv("IGM_SYNTHETIC_DATA", "0")
    import shutil
    root = tmp_path / "celeba_copy"
    shutil.copytree(files / "celeba", root / "celeba")
    kw = dict(width=size, height=size, channels=3, batch_size=4,
              transforms={"convert": True, "normalize": True})
    want = _arrays(JaxCelebA(data_dir=str(files), **kw))
    got = _arrays(CelebADataModule(data_dir=str(root), **kw))
    _equal(got, want)
    assert len(got[0][0]) == 32 and len(got[1][0]) == 8
    assert (root / "celeba" / f"cache_train_{size}x{size}.npz").exists()
    _equal(_arrays(CelebADataModule(data_dir=str(root), **kw)), want)   # from the cache


def test_dsprites_arrays_and_split_equal_igm_tpus(files, monkeypatch):
    monkeypatch.setenv("IGM_SYNTHETIC_DATA", "0")
    kw = dict(width=64, height=64, channels=1, batch_size=4,
              transforms={"grayscale": True, "normalize": False})
    want = _arrays(JaxDSprites(data_dir=str(files), **kw))
    got = _arrays(DSprites(data_dir=str(files), **kw))
    _equal(got, want)
    n = len(got[0][0]) + len(got[1][0])
    assert len(got[0][0]) == int(0.8 * n) and set(np.unique(got[0][0])) <= {0, 1}


def test_prepare_data_packages_the_same_files_as_igm_tpu(files, tmp_path, monkeypatch):
    """IGM_SYNTHETIC_DATA=0 and no files: the port's prepare_data makes
    every container (the port's own packaged.ensure); each parses to
    igm_tpu's arrays from igm_tpu's files."""
    monkeypatch.setenv("IGM_SYNTHETIC_DATA", "0")
    root = tmp_path / "port_data"
    kw = dict(width=64, height=64, channels=1, batch_size=4)
    got = _arrays(DSprites(data_dir=str(root), **kw))
    for sentinel in ("MNIST/raw/train-images-idx3-ubyte.gz",
                     "cifar-10-batches-py/data_batch_1", "celeba/list_eval_partition.txt"):
        assert (root / sentinel).exists(), sentinel
    _equal(got, _arrays(JaxDSprites(data_dir=str(files), **kw)))
    from igm_tpu.data.mnist import MNISTDataModule as JaxMNIST
    from igm_tpu_torch.data.mnist import MNISTDataModule
    _equal(_arrays(MNISTDataModule(data_dir=str(root))),
           _arrays(JaxMNIST(data_dir=str(files))))
    names = sorted(p.name for p in (root / "celeba" / "img_align_celeba").iterdir())
    assert len(names) == 256
    for name in names[:40]:        # the same scans, the same JPEG bytes
        assert ((root / "celeba" / "img_align_celeba" / name).read_bytes()
                == (files / "celeba" / "img_align_celeba" / name).read_bytes()), name


def test_missing_files_fall_back_to_the_synthetic_set(tmp_path, monkeypatch):
    monkeypatch.setenv("IGM_SYNTHETIC_DATA", "1")
    kw = dict(width=64, height=64, channels=1, batch_size=4)
    got = _arrays(DSprites(data_dir=str(tmp_path / "none"), **kw))
    want = _arrays(JaxDSprites(data_dir=str(tmp_path / "none"), **kw))
    _equal(got, want)
    assert not (tmp_path / "none").exists()
