"""The port's scoring tools (igm_tpu_torch/tools/score_gallery.py,
score_conditional.py), GifCallback and symmetry_contra_loss against
igm_tpu's.

score_gallery runs over two synthetic families (a 28x28 family of two
grids, scored; a 32x32 one, skipped) with the classifier cache seeded by
igm_tpu's params (converted), and is held to igm_tpu's untile +
score_samples: coverage exactly, the rest within 1e-5; the runs directory
is only read.  score_conditional runs tiny ddpm/cond_mnist and
flow/cond_mnist models on the CPU: igm_tpu's JSON keys, labels and
guidance default; its scoring function is held to igm_tpu's formulas on
the same probabilities.
"""
import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from igm_tpu.callbacks.util import GifCallback as JaxGifCallback  # noqa: E402
from igm_tpu.config import compose as jax_compose  # noqa: E402
from igm_tpu.config import instantiate as jax_instantiate  # noqa: E402
from igm_tpu.utils import digit_score as jds  # noqa: E402
from igm_tpu.utils.losses import symmetry_contra_loss as jax_contra  # noqa: E402
from igm_tpu_torch.callbacks.util import GifCallback  # noqa: E402
from igm_tpu_torch.config import compose, instantiate  # noqa: E402
from igm_tpu_torch.tools import score_conditional, score_gallery  # noqa: E402
from igm_tpu_torch.utils import digit_score as tds  # noqa: E402
from igm_tpu_torch.utils.losses import symmetry_contra_loss  # noqa: E402
from tools import score_gallery as jax_gallery  # noqa: E402

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
CONFIGS = REPO / "configs"
COND = {"ddpm/cond_mnist": ["model.hidden_dim=8", "model.dim_mults=[1,2]",
                            "model.timesteps=4"],
        "flow/cond_mnist": ["model.hidden_dim=8", "model.dim_mults=[1,2]",
                            "model.sample_steps=2"]}


@pytest.fixture(scope="module")
def flax_params():
    """igm_tpu's classifier params at 28x28: its init, the head scaled x30
    so that many predictions are confident (coverage is not trivially 0)."""
    p = jds.DigitCNN().init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v * 30.0 if path[-2].key == "Dense_1" else v, p)


def _seed_cache(directory: Path, params, h: int = 28, w: int = 28) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    converted = tds.params_from_igm_tpu(jax.tree_util.tree_leaves(params))
    np.savez(tds.cache_path(directory, h, w), **{k: v.numpy() for k, v in converted.items()})


def _write_grid(path: Path, tiles: np.ndarray, nrow: int) -> None:
    from igm_tpu_torch.callbacks.visualization import make_grid, save_image_grid
    save_image_grid(make_grid(tiles, nrow=nrow, normalize=True, value_range=(-1, 1)), path)


def test_score_gallery_equals_igm_tpu_and_only_reads_the_runs(tmp_path, flax_params):
    runs = tmp_path / "runs"
    x, _ = jds._digits_at(28, 28)
    noise = np.random.default_rng(1).uniform(-1, 1, (16, 28, 28, 1)).astype(np.float32)
    (runs / "digits").mkdir(parents=True)
    _write_grid(runs / "digits" / "samples_epoch9.jpg", noise, 4)
    _write_grid(runs / "digits" / "samples_epoch19.jpg", x[1437:1477], 8)
    (runs / "cifar").mkdir()
    _write_grid(runs / "cifar" / "samples_epoch9.jpg",
                np.zeros((4, 32, 32, 3), np.float32), 2)
    (runs / "empty").mkdir()
    before = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in runs.rglob("*") if p.is_file()}
    _seed_cache(tmp_path / "cache", flax_params)
    table = score_gallery.main(["--runs-dir", str(runs), "--out-dir", str(tmp_path / "out"),
                                "--cache-dir", str(tmp_path / "cache"), "--device", "cpu"])
    assert set(table) == {"digits"}
    assert {p: (p.stat().st_mtime_ns, p.read_bytes())
            for p in runs.rglob("*") if p.is_file()} == before
    written = json.loads((tmp_path / "out" / "digits" / "digit_scores.json").read_text())
    assert written == table["digits"]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["digits"]
    assert written["grid"] == "samples_epoch9.jpg"        # sorted() puts epoch19 first
    assert set(written["grids"]) == {"samples_epoch19.jpg", "samples_epoch9.jpg"}
    for name, got in written["grids"].items():
        tiles = jax_gallery.untile(str(runs / "digits" / name), 28, 28)
        np.testing.assert_array_equal(score_gallery.untile(str(runs / "digits" / name), 28, 28),
                                      tiles)
        want = jds.score_samples(flax_params, tiles)
        assert got["n"] == want["n"] and got["coverage"] == want["coverage"], name
        for key in ("mean_confidence", "inception_score"):
            assert got[key] == pytest.approx(want[key], rel=RTOL, abs=ATOL), (name, key)
    assert written["grids"]["samples_epoch19.jpg"]["coverage"] > 0


def _igm_tpu_keys():
    """The keys of the JSON line tools/score_conditional.py prints."""
    tree = ast.parse((REPO / "tools" / "score_conditional.py").read_text())
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "scores")
    return [k.value for k in node.value.keys]


@pytest.mark.parametrize("experiment", sorted(COND))
def test_score_conditional_on_tiny_models(experiment, tmp_path, flax_params, monkeypatch):
    overrides = [f"experiment={experiment}", *COND[experiment]]
    cfg = compose(CONFIGS, [*overrides, "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    model.init_params(0)
    weights = tmp_path / "w.pt"
    torch.save(model.modules[model.weights_module].state_dict(), weights)
    _seed_cache(tmp_path / "cache", flax_params)
    seen = []
    draw = score_conditional.draw

    def recording(model, labels, guidance, generator):
        seen.append((labels.clone(), guidance))
        return draw(model, labels, guidance, generator)
    monkeypatch.setattr(score_conditional, "draw", recording)
    scores = score_conditional.main([*overrides, "--weights", str(weights), "--per-class", "2",
                                     "--cache-dir", str(tmp_path / "cache"),
                                     "--out", str(tmp_path / "s.json"), "--device", "cpu"])
    assert list(scores) == _igm_tpu_keys()
    assert json.loads((tmp_path / "s.json").read_text()) == json.loads(json.dumps(scores))
    jm = jax_instantiate(jax_compose(CONFIGS, [*overrides, "print_config=False"]).model,
                         datamodule=jax_compose(CONFIGS, overrides).datamodule)
    (labels, guidance), = seen
    assert guidance == scores["guidance"] == float(jm.hparams.guidance_scale)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jnp.repeat(jnp.arange(10), 2)))
    assert scores["experiment"] == experiment and scores["per_class_n"] == 2
    assert scores["step"] == 0 and 0.0 <= scores["conditional_accuracy"] <= 1.0
    assert sorted(scores["per_class_accuracy"]) == list(range(10))
    assert score_conditional.main([*overrides, "--weights", str(weights), "--per-class", "1",
                                   "--guidance", "1.5", "--cache-dir", str(tmp_path / "cache"),
                                   "--device", "cpu"])["guidance"] == 1.5


def test_conditional_scores_equal_igm_tpus_formulas():
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(10) * 0.3, size=60).astype(np.float32)
    y = np.repeat(np.arange(10), 6)
    n_cls = 10
    # tools/score_conditional.py:85-97
    pred = probs.argmax(-1)
    want = np.asarray(y)
    acc = float((pred == want).mean())
    per_class = {int(c): float((pred[want == c] == c).mean())
                 for c in range(n_cls)}
    got = score_conditional.conditional_scores(probs, y, n_cls)
    assert got == {"conditional_accuracy": acc, "per_class_accuracy": per_class,
                   "mean_confidence": float(probs.max(-1).mean())}
    assert 0.0 < acc < 1.0


def test_score_conditional_refuses_what_it_cannot_score(tmp_path):
    overrides = ["experiment=ddpm/mnist", "model.hidden_dim=8", "model.dim_mults=[1,2]",
                 "model.timesteps=4"]
    cfg = compose(CONFIGS, [*overrides, "print_config=False"])
    model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
    model.init_params(0)
    torch.save(model.modules["denoise"].state_dict(), tmp_path / "w.pt")
    with pytest.raises(SystemExit, match="DDPM is not class-conditional"):
        score_conditional.main([*overrides, "--weights", str(tmp_path / "w.pt"),
                                "--device", "cpu"])

    class NoSampler:
        pass
    with pytest.raises(SystemExit, match="NoSampler has no guidance-aware sampler"):
        score_conditional.draw(NoSampler(), torch.zeros(2, dtype=torch.long), 1.0, None)


def _gif_frames(path: Path):
    from PIL import Image, ImageSequence
    with Image.open(path) as im:
        return [(np.asarray(f.convert("RGB")), f.info.get("duration"))
                for f in ImageSequence.Iterator(im)]


def test_gif_callback_writes_igm_tpus_frames(tmp_path, monkeypatch):
    from PIL import Image
    names = ("10", "2", "0", "1")                # numeric order: 0, 1, 2, 10
    runs = {}
    for kind, cb in (("port", GifCallback(fps=5)), ("igm", JaxGifCallback(fps=5))):
        run = tmp_path / kind
        (run / "results").mkdir(parents=True)
        for name in names:
            Image.fromarray(np.full((12, 12, 3), 20 * int(name), np.uint8)).save(
                run / "results" / f"{name}.jpg")
        monkeypatch.chdir(run)
        cb.on_train_end(None, None)
        runs[kind] = _gif_frames(run / "video.gif")
    assert len(runs["port"]) == len(runs["igm"]) == 4
    for (a, da), (b, db) in zip(runs["port"], runs["igm"]):
        np.testing.assert_array_equal(a, b)
        assert da == db == 200
    assert [round(f.mean() / 20) for f, _ in runs["port"]] == [0, 1, 2, 10]
    for empty in ("none", "no_frames"):
        run = tmp_path / empty
        run.mkdir()
        if empty == "no_frames":
            (run / "results").mkdir()
        monkeypatch.chdir(run)
        GifCallback().on_train_end(None, None)
        assert not (run / "video.gif").exists()


def test_symmetry_contra_loss_matches_igm_tpu():
    rng = np.random.default_rng(0)
    f1, f2 = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    for temperature in (0.07, 0.5):
        want = float(jax_contra(jnp.asarray(f1), jnp.asarray(f2), temperature))
        got = float(symmetry_contra_loss(torch.from_numpy(f1), torch.from_numpy(f2),
                                         temperature))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
