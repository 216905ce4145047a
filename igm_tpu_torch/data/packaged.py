"""Dataset files from the 1,797 real 8x8 digit scans: the port's own copy
of ``igm_tpu/data/packaged.py``.

With no network, ``prepare_data`` cannot download MNIST, CIFAR-10, CelebA
or dSprites.  ``ensure(data_dir)`` packages the scans into each dataset's
official on-disk container (IDX.gz, pickled batches, npz, JPEG + partition
file), byte for byte as ``igm_tpu`` does, so every parser reads real
container bytes.  A seed-0 shuffle and fixed split sizes (1437 / 360).

The scans are the UCI "Optical Recognition of Handwritten Digits" test
set as scikit-learn ships it (``sklearn.datasets.load_digits``), kept in
``digits.npz`` beside this module (uint8 ``images`` with values 0-16 and
``target``), so neither the port nor the card's machine needs
scikit-learn.  PIL is imported only when CelebA's files are made.
"""
from __future__ import annotations

import gzip
import pickle
import struct
from pathlib import Path

import numpy as np

N_TRAIN = 1437
CELEBA_N = 256


SCANS = Path(__file__).resolve().parent / "digits.npz"


def load_real_digits():
    """The scans scaled to 0-255 as ``igm_tpu`` scales them, and their
    labels, in the seed-0 order."""
    with np.load(SCANS) as d:
        images, target = d["images"], d["target"]
    imgs = (images / 16.0 * 255.0).round().astype(np.uint8)        # (1797, 8, 8)
    labels = target.astype(np.int32)
    order = np.random.default_rng(0).permutation(len(imgs))
    return imgs[order], labels[order]


def upscale(imgs: np.ndarray, factor: int) -> np.ndarray:
    return np.kron(imgs, np.ones((1, factor, factor), np.uint8))


def write_idx(path: Path, arr: np.ndarray) -> None:
    """IDX: magic byte 3 = 0x08 (unsigned bytes), byte 4 = ndim; big-endian
    dimensions."""
    path.parent.mkdir(parents=True, exist_ok=True)
    header = struct.pack(">I", 0x0800 | arr.ndim) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    with gzip.open(path, "wb") as fh:
        fh.write(header + arr.tobytes())


def make_mnist(out: Path, imgs, labels) -> None:
    x28 = np.pad(upscale(imgs, 3), ((0, 0), (2, 2), (2, 2)))        # 8 -> 24 -> 28
    raw = out / "MNIST" / "raw"
    write_idx(raw / "train-images-idx3-ubyte.gz", x28[:N_TRAIN])
    write_idx(raw / "train-labels-idx1-ubyte.gz", labels[:N_TRAIN].astype(np.uint8))
    write_idx(raw / "t10k-images-idx3-ubyte.gz", x28[N_TRAIN:])
    write_idx(raw / "t10k-labels-idx1-ubyte.gz", labels[N_TRAIN:].astype(np.uint8))


def make_cifar10(out: Path, imgs, labels) -> None:
    x32 = upscale(imgs, 4)
    flat = np.repeat(x32[:, None], 3, axis=1).reshape(len(x32), -1)  # R|G|B planes
    bdir = out / "cifar-10-batches-py"
    bdir.mkdir(parents=True, exist_ok=True)
    for i, idx in enumerate(np.array_split(np.arange(N_TRAIN), 5), 1):
        with open(bdir / f"data_batch_{i}", "wb") as fh:
            pickle.dump({b"data": flat[idx], b"labels": labels[idx].tolist()}, fh)
    with open(bdir / "test_batch", "wb") as fh:
        pickle.dump({b"data": flat[N_TRAIN:], b"labels": labels[N_TRAIN:].tolist()}, fh)


def make_dsprites(out: Path, imgs) -> None:
    binary = (upscale(imgs, 8) > 127).astype(np.uint8)                # (N, 64, 64)
    path = out / "dsprite" / "dsprites_64x64.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, imgs=binary)


def make_celeba(out: Path, imgs, n: int = CELEBA_N) -> None:
    from PIL import Image
    img_dir = out / "celeba" / "img_align_celeba"
    img_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for i in range(min(n, len(imgs))):
        im = Image.fromarray(upscale(imgs[i:i + 1], 8)[0]).convert("RGB")
        im = im.resize((178, 218), Image.BICUBIC)          # the aligned-CelebA geometry
        name = f"{i + 1:06d}.jpg"
        im.save(img_dir / name, quality=92)
        names.append(name)
    n_tr = int(0.8 * len(names))
    lines = [f"{nm} {0 if i < n_tr else 2}" for i, nm in enumerate(names)]
    (out / "celeba" / "list_eval_partition.txt").write_text("\n".join(lines))


_SENTINELS = (Path("MNIST/raw/train-images-idx3-ubyte.gz"),
              Path("cifar-10-batches-py/data_batch_1"),
              Path("dsprite/dsprites_64x64.npz"),
              Path("celeba/list_eval_partition.txt"))


def ensure(data_dir: Path, celeba_n: int = CELEBA_N) -> None:
    """Make every dataset that is missing under ``data_dir`` (idempotent)."""
    out = Path(data_dir)
    missing = [s for s in _SENTINELS if not (out / s).exists()]
    if not missing:
        return
    imgs, labels = load_real_digits()
    if not (out / _SENTINELS[0]).exists():
        make_mnist(out, imgs, labels)
    if not (out / _SENTINELS[1]).exists():
        make_cifar10(out, imgs, labels)
    if not (out / _SENTINELS[2]).exists():
        make_dsprites(out, imgs)
    if not (out / _SENTINELS[3]).exists():
        make_celeba(out, imgs, celeba_n)
