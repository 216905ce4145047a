"""The port's FID pieces against igm_tpu's on the CPU: ``FeatureStats`` and
``frechet_distance`` (float64, to 1e-10), the random conv features and
InceptionV3 on the same weights (1e-4 relative to the largest feature; the
weights of tests/_torch_fid_inception.py's mirror through
tools/convert_inception_weights.py, images of batch 2 at 32x32 resized to
299), the backend choice, and ``FIDEvaluationCallback`` end to end with a
stub trainer."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu.callbacks import evaluation as jax_eval  # noqa: E402
from igm_tpu.callbacks import fid as jax_fid  # noqa: E402
from igm_tpu.models.base import ValidationResult as JaxResult  # noqa: E402
from igm_tpu_torch.callbacks import evaluation as port_eval  # noqa: E402
from igm_tpu_torch.callbacks import fid as port_fid  # noqa: E402
from igm_tpu_torch.models.base import ValidationResult  # noqa: E402

torch.set_num_threads(1)

# float32 convolutions summed in another order; the features are means of
# positive activations, so 1e-4 of the largest holds over 94 layers
FEAT_RTOL = 1e-4


def close(got, want, rtol=FEAT_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_feature_stats_and_frechet_distance_match_igm_tpu():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(40, 16)).astype(np.float32)
    b = (rng.normal(size=(30, 16)) * 1.3 + 0.2).astype(np.float32)
    stats = []
    for mod in (port_fid, jax_fid):
        ra, rb = mod.FeatureStats(16), mod.FeatureStats(16)
        for chunk in np.array_split(a, 3):
            ra.update(chunk)
        rb.update(b)
        stats.append((ra.finalize(), rb.finalize()))
    (pa, pb), (ja, jb) = stats
    for got, want in zip((*pa, *pb), (*ja, *jb)):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    got = port_fid.frechet_distance(*pa, *pb)
    want = jax_fid.frechet_distance(*ja, *jb)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert abs(port_fid.frechet_distance(*pa, *pa)) < 1e-6


def load_flax_params(fe, params: dict) -> None:
    """igm_tpu's random net ({"Conv_i": {"kernel": HWIO, "bias"}}) into the
    port's."""
    fe.net.load_state_dict({
        **{f"{k}.weight": torch.from_numpy(np.ascontiguousarray(
            np.asarray(v["kernel"]).transpose(3, 2, 0, 1))) for k, v in params.items()},
        **{f"{k}.bias": torch.from_numpy(np.asarray(v["bias"])) for k, v in params.items()}},
        strict=True)


def _uint8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("shape", [(4, 28, 28, 1), (4, 32, 32, 3), (3, 64, 64, 3)],
                         ids=["28-gray", "32-rgb", "64-rgb"])
def test_random_conv_features_match_igm_tpu_on_its_weights(shape):
    """SAME padding with stride 2 on even and odd sizes (28 -> 14 -> 7 -> 4)."""
    jfe = jax_fid.RandomConvFeatures()
    pfe = port_fid.RandomConvFeatures(device="cpu")
    load_flax_params(pfe, jfe.params["params"])
    imgs = _uint8(shape, 1)
    close(pfe(imgs), jfe(imgs))


def test_random_conv_weights_are_the_ports_own_seeded_draw():
    a, b = (port_fid.RandomConvFeatures(device="cpu") for _ in range(2))
    for pa, pb in zip(a.net.parameters(), b.net.parameters()):
        assert torch.equal(pa, pb)
    imgs = _uint8((2, 32, 32, 3), 2)
    assert np.array_equal(a(imgs), b(imgs))
    w = a.net.Conv_1.weight
    assert abs(float(w.std()) * np.sqrt(64 * 9) - 1.0) < 0.1    # lecun_normal


@pytest.fixture(scope="module")
def inception_npz(tmp_path_factory):
    from tests._torch_fid_inception import randomized_mirror
    from tools.convert_inception_weights import convert
    net = randomized_mirror(seed=0)
    path = tmp_path_factory.mktemp("w") / "inception_fid.npz"
    np.savez(path, **convert({k: v.numpy() for k, v in net.state_dict().items()}))
    return net, str(path)


def test_inception_features_match_igm_tpu(inception_npz):
    """The same npz through both loaders; 32x32 uint8 images (RGB and
    grayscale) upsampled to 299 bilinearly, scaled to [-1, 1]."""
    mirror, path = inception_npz
    jfe, pfe = jax_fid.InceptionFeatures(path), port_fid.InceptionFeatures(path, "cpu")
    for shape in ((2, 32, 32, 3), (2, 32, 32, 1)):
        imgs = _uint8(shape, 3)
        got, want = pfe(imgs), jfe(imgs)
        assert got.shape == (2, 2048)
        close(got, want)
    x = np.random.default_rng(4).random((2, 299, 299, 3), np.float32) * 2 - 1
    with torch.no_grad():
        yardstick = mirror(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        close(pfe.net(torch.from_numpy(x)).numpy(), yardstick)


def test_inception_random_init_is_seeded():
    from igm_tpu_torch.networks.inception import InceptionV3
    a, b = InceptionV3(), InceptionV3()
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))


def test_backend_choice(inception_npz, monkeypatch):
    monkeypatch.setattr(port_fid, "_BACKEND_CACHE", {})
    monkeypatch.delenv("IGM_INCEPTION_WEIGHTS", raising=False)
    assert port_fid.get_feature_backend(device="cpu")[1:] == (512, "random_torch")
    assert port_fid.get_feature_backend("random", "cpu")[2] == "random_torch"
    monkeypatch.setenv("IGM_INCEPTION_WEIGHTS", str(Path(inception_npz[1]).parent / "none"))
    assert port_fid.get_feature_backend(device="cpu")[2] == "random_torch"      # absent: not read
    monkeypatch.setenv("IGM_INCEPTION_WEIGHTS", inception_npz[1])
    fe, dim, name = port_fid.get_feature_backend(device="cpu")
    assert (dim, name) == (2048, "inception") and isinstance(fe, port_fid.InceptionFeatures)
    with pytest.raises(ValueError):
        port_fid.get_feature_backend("other", "cpu")


def test_feature_backends_default_to_the_card(inception_npz, monkeypatch):
    """With no device named, the extractors resolve the card, as the models
    do: with no card they raise instead of running on the CPU."""
    monkeypatch.setattr(port_fid, "_BACKEND_CACHE", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (port_fid.RandomConvFeatures, port_fid.get_feature_backend,
                 lambda: port_fid.InceptionFeatures(inception_npz[1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


class _Trainer:
    def __init__(self):
        self.current_epoch = 0
        self.callback_metrics = {}
        self.logged = []

    def log(self, tag, value):
        self.callback_metrics[tag] = float(value)
        self.logged.append(tag)


class _Model:
    channels, input_normalize, device = 3, True, torch.device("cpu")


def test_to_uint8_truncates_as_igm_tpu():
    x = np.random.default_rng(6).uniform(-1.2, 1.2, (4, 8, 8, 3)).astype(np.float32)
    x[0, 0, 0] = [-1.0, 1.0, 0.99215686]
    want = jax_eval.FIDEvaluationCallback()._to_uint8(x, _Model())
    got = port_eval.to_uint8(x, True, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_fid_callback_end_to_end_matches_igm_tpu(monkeypatch):
    """The same validation images through both callbacks, the port's random
    backend holding igm_tpu's weights: the same distance under each one's
    tag (metrics/fid_random against the port's metrics/fid_random_torch)."""
    jfe = jax_fid.RandomConvFeatures()
    pfe = port_fid.RandomConvFeatures(device="cpu")
    load_flax_params(pfe, jfe.params["params"])
    monkeypatch.setattr(port_fid, "_BACKEND_CACHE", {("random_torch", "cpu"): (
        pfe, 512, "random_torch")})
    monkeypatch.setattr(jax_fid, "_BACKEND_CACHE", {"random": (jfe, 512, "random")})
    monkeypatch.delenv("IGM_INCEPTION_WEIGHTS", raising=False)
    rng = np.random.default_rng(7)
    batches = [(np.tanh(rng.normal(size=(6, 32, 32, 3))).astype(np.float32),
                np.tanh(rng.normal(size=(6, 32, 32, 3)) * 0.5 + 0.3).astype(np.float32))
               for _ in range(3)]
    values = {}
    for name, cb, result in (("port", port_eval.FIDEvaluationCallback(), ValidationResult),
                             ("jax", jax_eval.FIDEvaluationCallback(), JaxResult)):
        trainer = _Trainer()
        cb.on_validation_epoch_start(trainer, _Model())
        for i, (real, fake) in enumerate(batches):
            cb.on_validation_batch_end(trainer, _Model(),
                                       result(real_image=real, fake_image=fake), None, i)
        cb.on_validation_epoch_end(trainer, _Model())
        values[name] = trainer.callback_metrics
    assert list(values["port"]) == ["metrics/fid_random_torch"]
    assert list(values["jax"]) == ["metrics/fid_random"]
    # 18 samples of 512 features: rank-deficient covariances, whose sqrtm
    # amplifies the features' 1e-4 to about 1e-4 - 1e-3 of the distance
    np.testing.assert_allclose(values["port"]["metrics/fid_random_torch"],
                               values["jax"]["metrics/fid_random"], rtol=1e-3)
    trainer, model = _Trainer(), _Model()
    model.channels = 1                                  # RGB only
    cb = port_eval.FIDEvaluationCallback()
    cb.on_validation_epoch_start(trainer, model)
    cb.on_validation_epoch_end(trainer, model)
    assert trainer.callback_metrics == {}
