"""The port's digit scorer (igm_tpu_torch/utils/digit_score.py) and its scans
file against igm_tpu's: the scans equal scikit-learn's and the packaged
dataset files igm_tpu's; DigitCNN on igm_tpu's params equals Flax's
forward at 28x28 and at 20x24 (Flax's asymmetric SAME padding at stride 2
and its HWC flatten); score_samples equals igm_tpu's (coverage exactly,
the rest within 1e-5); two epochs of training from the same initial
params end where igm_tpu's do; the port's own classifier passes 0.90 and
is cached under its own name.
"""
import gzip
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from igm_tpu.data import packaged as jax_packaged  # noqa: E402
from igm_tpu.utils import digit_score as jds  # noqa: E402
from igm_tpu_torch.data import packaged  # noqa: E402
from igm_tpu_torch.utils import digit_score as tds  # noqa: E402

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
# two epochs (22 Adam steps at lr 1e-3): Adam's normalised step moves a
# weight by up to lr a step whatever its gradient's size, so float32
# reassociation in near-zero gradients leaves some Dense_0 weights up to
# 6e-3 apart (observed); the validation logits, what the score reads, stay
# within 0.4% of the largest (observed 0.035 of 9.7)
TRAIN_LOGIT_TOL = 1e-2


def test_scans_equal_sklearn_and_ensure_writes_igm_tpus_files(tmp_path):
    from sklearn.datasets import load_digits
    d = load_digits()
    with np.load(packaged.SCANS) as scans:
        assert scans["images"].dtype == np.uint8 and scans["images"].max() == 16
        np.testing.assert_array_equal(scans["images"], d.images)
        np.testing.assert_array_equal(scans["target"], d.target)
    for got, want in zip(packaged.load_real_digits(), jax_packaged.load_real_digits()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    packaged.ensure(tmp_path / "port", celeba_n=8)
    jax_packaged.ensure(tmp_path / "igm", celeba_n=8)
    files = sorted(p.relative_to(tmp_path / "igm") for p in (tmp_path / "igm").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(files) > 10
    for rel in files:
        got, want = (tmp_path / "port" / rel).read_bytes(), (tmp_path / "igm" / rel).read_bytes()
        if rel.suffix == ".gz":                 # the header's mtime (bytes 4-7) aside
            assert gzip.decompress(got) == gzip.decompress(want), rel
            got, want = got[:4] + got[8:], want[:4] + want[8:]
        assert got == want, rel


def _init(h: int, w: int):
    return jds.DigitCNN().init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 1)))


@pytest.mark.parametrize("h,w", [(28, 28), (20, 24)])
def test_digit_cnn_matches_flax(h, w):
    """Both hazards show here: a symmetric pad shifts every window, an NCHW
    flatten permutes Dense_0's inputs."""
    params = _init(h, w)
    x = np.random.default_rng(h).uniform(-1, 1, (6, h, w, 1)).astype(np.float32)
    want = np.asarray(jds.DigitCNN().apply(params, x))
    leaves = {f"p{i}": np.asarray(v) for i, v in enumerate(jax.tree_util.tree_leaves(params))}
    got = tds.classifier(tds.params_from_igm_tpu(leaves), h, w)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=RTOL)
    by_path = tds.params_from_igm_tpu(
        {"/".join(k.key for k in path): np.asarray(v)
         for path, v in jax.tree_util.tree_flatten_with_path(params)[0]})
    for k, v in tds.params_from_igm_tpu(leaves).items():
        assert torch.equal(by_path[k], v), k


@pytest.fixture(scope="module")
def trained():
    """igm_tpu's classifier after two epochs, and its initial params."""
    x, _ = jds._digits_at(28, 28)
    init = jds.DigitCNN().init(jax.random.PRNGKey(0), x[:1])    # as train_classifier draws it
    params, acc = jds.train_classifier(28, 28, epochs=2, seed=0)
    return init, params, acc


def test_score_samples_matches_igm_tpu(trained):
    _, params, _ = trained
    tparams = tds.params_from_igm_tpu(jax.tree_util.tree_leaves(params))
    x, _ = jds._digits_at(28, 28)
    noise = np.random.default_rng(0).uniform(-1, 1, (40, 28, 28, 3)).astype(np.float32)
    for imgs in (x[1437:1557], noise):               # real digits and RGB noise
        want, got = jds.score_samples(params, imgs), tds.score_samples(tparams, imgs)
        assert set(got) == set(want) and got["n"] == want["n"]
        assert got["coverage"] == want["coverage"]
        for key in ("mean_confidence", "inception_score"):
            assert got[key] == pytest.approx(want[key], rel=RTOL, abs=ATOL), key
    assert tds.score_samples(tparams, x[1437:1557])["coverage"] == 10


def test_train_classifier_two_epochs_matches_igm_tpu(trained):
    init, want, want_acc = trained
    got, acc = tds.train_classifier(
        28, 28, epochs=2, seed=0,
        init=tds.params_from_igm_tpu(jax.tree_util.tree_leaves(init)))
    assert acc == want_acc
    x, _ = jds._digits_at(28, 28)
    want_logits = np.asarray(jds.DigitCNN().apply(want, x[1437:]))
    got_logits = tds.validation_logits(got, 28, 28).numpy()
    np.testing.assert_allclose(got_logits, want_logits,
                               atol=TRAIN_LOGIT_TOL * np.abs(want_logits).max())


def test_load_or_train_passes_090_and_keeps_its_own_cache(tmp_path, monkeypatch):
    # an igm_tpu cache in the same directory is never read
    np.savez(tmp_path / "digit_classifier_28x28.npz", p0=np.zeros(1))
    params = tds.load_or_train(tmp_path, 28, 28, "cpu")
    assert tds.validation_accuracy(params, 28, 28) > 0.90
    assert tds.cache_path(tmp_path, 28, 28).name == "digit_classifier_torch_28x28.npz"
    assert tds.cache_path(tmp_path, 28, 28).exists()

    def refuse(*args, **kwargs):
        raise AssertionError("trained again")
    monkeypatch.setattr(tds, "train_classifier", refuse)
    again = tds.load_or_train(tmp_path, 28, 28, "cpu")
    for k, v in params.items():
        assert torch.equal(again[k], v), k
