"""The port's C++ host batcher (igm_tpu_torch/data/native.py,
igm_tpu_torch/csrc/batcher.cpp): gather_rows equals numpy's indexing,
shuffle_perm equals igm_tpu's splitmix64 Fisher-Yates bit for bit, the
library lands in igm_tpu_torch/_build/, a failing compile raises with the
compiler's output, and epoch_batches yields the same epoch as before (one
rng.permutation, numpy's rows)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu.data import native as jax_native  # noqa: E402
from igm_tpu_torch.data import native  # noqa: E402
from igm_tpu_torch.data.loader import epoch_batches  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (300, 32, 32, 3)),
                                         (np.float32, (257, 28, 28, 1)),
                                         (np.uint8, (10,))])
def test_gather_rows_equals_numpy(dtype, shape):
    rng = np.random.default_rng(0)
    src = (rng.integers(0, 256, shape) if dtype == np.uint8
           else rng.normal(size=shape)).astype(dtype)
    for n, threads in ((128, 0), (shape[0], 3), (1, 8), (0, 0)):
        idx = rng.integers(0, shape[0], n)
        got = native.gather_rows(src, idx, n_threads=threads)
        assert got.dtype == src.dtype and got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, src[idx])
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([shape[0]]))


@pytest.mark.parametrize("n,seed", [(1437, 0), (50_000, 7), (97, 2 ** 64 - 1)])
def test_shuffle_perm_equals_igm_tpu(n, seed):
    assert jax_native.available()           # igm_tpu's C++ one, not its numpy fallback
    got = native.shuffle_perm(n, seed)
    np.testing.assert_array_equal(got, jax_native.shuffle_perm(n, seed))
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


def test_build_lands_in_build_dir_and_a_failing_compile_raises(tmp_path):
    lib = native.build()
    assert lib.parent == native.BUILD_DIR == REPO / "igm_tpu_torch" / "_build"
    assert lib.name.startswith("batcher-") and lib.suffix == ".so"
    assert native.build() == lib                    # built once, then found
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" void f() { undeclared_name(); }\n')
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build(bad, tmp_path / "out")
    assert not list((tmp_path / "out").iterdir())   # no library, no temporary left


@pytest.mark.parametrize("shuffle,limit", [(True, None), (False, None), (True, 3)])
def test_epoch_batches_unchanged(shuffle, limit):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (103, 8, 8, 3), np.uint8)
    labels = rng.integers(0, 10, 103).astype(np.int32)
    got = list(epoch_batches([imgs, labels], 16, np.random.default_rng(5), shuffle, limit))
    order = (np.random.default_rng(5).permutation(103) if shuffle else np.arange(103))
    want = [(imgs[order[i * 16:(i + 1) * 16]], labels[order[i * 16:(i + 1) * 16]])
            for i in range(6 if limit is None else limit)]
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        assert gi.flags["C_CONTIGUOUS"] and gl.dtype == np.int32
