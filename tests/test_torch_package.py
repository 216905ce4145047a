"""igm_tpu_torch stands alone: it imports nothing of JAX or igm_tpu, composes
the shared config tree into port objects, and refuses to fall back to the
CPU unasked."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from igm_tpu_torch import resolve_device  # noqa: E402
from igm_tpu_torch.config import resolve_target  # noqa: E402

torch.set_num_threads(1)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "igm_tpu", "sklearn")


def _port_files():
    return sorted((REPO / "igm_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_igm_tpu_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_compose_and_instantiate_without_jax_in_a_fresh_process():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        torch.set_num_threads(1)
        from igm_tpu_torch.config import compose, instantiate
        from igm_tpu_torch.models.ddpm import DDPM
        import igm_tpu_torch.train, igm_tpu_torch.core.trainer  # noqa: F401
        import igm_tpu_torch.tools.profile_training  # noqa: F401
        cfg = compose({str(REPO / "configs")!r}, ["experiment=ddpm/cifar10"])
        model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
        assert type(model) is DDPM, type(model)
        assert model.hparams.dim_mults == [1, 2, 4]
        assert model.hparams.hidden_dim == 64 and model.timesteps == 1000
        from igm_tpu_torch.models.latent_ddpm import LatentDDPM
        from igm_tpu_torch.models.vqvae import VQVAE
        from igm_tpu_torch.models.tar import TAR
        for exp, cls in (("vqvae/cifar10", VQVAE), ("latent_ddpm/cifar10", LatentDDPM),
                         ("tar/mnist", TAR), ("tar/mnist_cond", TAR)):
            cfg = compose({str(REPO / "configs")!r}, ["experiment=" + exp])
            model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
            assert type(model) is cls, type(model)
        from igm_tpu_torch.models.made import MADE
        from igm_tpu_torch.models.pixelcnn import PixelCNN
        from igm_tpu_torch.models.realnvp import RealNVP
        for exp, cls, extra in (("made/mnist", MADE, ["model.hidden_dim=8"]),
                                ("pixelcnn/mnist", PixelCNN, []),
                                ("pixelcnn/cifar10", PixelCNN, []),
                                ("realnvp/mnist", RealNVP, []),
                                ("realnvp/cifar10", RealNVP, [])):
            cfg = compose({str(REPO / "configs")!r}, ["experiment=" + exp, *extra])
            model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
            assert type(model) is cls, type(model)
            assert cfg.callbacks.sample._target_.endswith("SampleImagesCallback")
        assert model.hparams.hidden_dim == 128 and model.hparams.n_couplings == [3, 3, 3]
        from igm_tpu_torch.models.cvae import cVAE
        from igm_tpu_torch.models.factor_vae import FactorVAE
        from igm_tpu_torch.models.vae import VAE
        import igm_tpu_torch.callbacks.evaluation, igm_tpu_torch.callbacks.fid  # noqa: F401
        import igm_tpu_torch.callbacks.visualization  # noqa: F401
        import igm_tpu_torch.data.celeba, igm_tpu_torch.data.dsprite  # noqa: F401
        import igm_tpu_torch.data.packaged, igm_tpu_torch.networks.inception  # noqa: F401
        import igm_tpu_torch.networks.conv32, igm_tpu_torch.networks.conv64  # noqa: F401
        import igm_tpu_torch.utils.losses, igm_tpu_torch.utils.utils  # noqa: F401
        for exp, cls in (("vae/celeba", VAE), ("beta_vae/dsprites", VAE),
                         ("vae/mnist_mlp", VAE), ("cvae/mnist", cVAE),
                         ("factor_vae/dsprites", FactorVAE)):
            cfg = compose({str(REPO / "configs")!r}, ["experiment=" + exp])
            model = instantiate(cfg.model, datamodule=cfg.datamodule, device="cpu")
            assert type(model) is cls, type(model)
            dm = instantiate(cfg.datamodule)
            callbacks = [instantiate(c) for c in cfg.callbacks.values()]
        assert sum(p.numel() for p in model.modules.parameters()) > 0
        import igm_tpu_torch.sweep  # noqa: F401
        import igm_tpu_torch.tools.eval_fid, igm_tpu_torch.tools.export  # noqa: F401
        import igm_tpu_torch.tools.serve  # noqa: F401
        from igm_tpu_torch.core.logging import WandbLogger  # noqa: F401
        import igm_tpu_torch.utils.digit_score, igm_tpu_torch.data.native  # noqa: F401
        import igm_tpu_torch.tools.score_gallery  # noqa: F401
        import igm_tpu_torch.tools.score_conditional  # noqa: F401
        from igm_tpu_torch.callbacks.util import GifCallback  # noqa: F401
        from igm_tpu_torch.data.packaged import load_real_digits
        assert load_real_digits()[0].shape == (1797, 8, 8)
        from igm_tpu_torch.core.checkpoint import read_checkpoint  # noqa: F401
        import igm_tpu_torch.parallel, igm_tpu_torch.parallel.launch  # noqa: F401
        bad = [m for m in sys.modules
               if m.split(".")[0] in {FORBIDDEN!r} + ("sklearn", "matplotlib")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_targets_resolve_to_the_port():
    from igm_tpu_torch.data.mnist import MNISTDataModule
    from igm_tpu_torch.models.ddpm import DDPM
    from igm_tpu_torch.models.tar import TAR
    assert resolve_target("igm_tpu.models.ddpm.DDPM") is DDPM
    assert resolve_target("src.models.ddpm.DDPM") is DDPM
    assert resolve_target("igm_tpu.models.tar.TAR") is TAR
    assert resolve_target("igm_tpu.data.mnist.MNISTDataModule") is MNISTDataModule
    from igm_tpu_torch.models.consistency import ConsistencyModel
    from igm_tpu_torch.models.distill import ProgressiveDistillation
    from igm_tpu_torch.models.score_sde import ScoreSDE
    assert resolve_target("igm_tpu.models.score_sde.ScoreSDE") is ScoreSDE
    assert resolve_target("igm_tpu.models.consistency.ConsistencyModel") is ConsistencyModel
    assert resolve_target("igm_tpu.models.distill.ProgressiveDistillation") \
        is ProgressiveDistillation
    from igm_tpu_torch.models.made import MADE
    from igm_tpu_torch.models.pixelcnn import PixelCNN
    from igm_tpu_torch.models.realnvp import RealNVP
    assert resolve_target("igm_tpu.models.made.MADE") is MADE
    assert resolve_target("igm_tpu.models.pixelcnn.PixelCNN") is PixelCNN
    assert resolve_target("igm_tpu.models.realnvp.RealNVP") is RealNVP
    from igm_tpu_torch.callbacks.evaluation import FIDEvaluationCallback
    from igm_tpu_torch.callbacks.visualization import TraverseLatentCallback
    from igm_tpu_torch.data.celeba import CelebADataModule
    from igm_tpu_torch.data.dsprite import DataModule
    from igm_tpu_torch.models.cvae import cVAE
    from igm_tpu_torch.models.factor_vae import FactorVAE
    from igm_tpu_torch.models.vae import VAE
    from igm_tpu_torch.networks.conv64 import Encoder
    assert resolve_target("igm_tpu.models.vae.VAE") is VAE
    assert resolve_target("igm_tpu.models.cvae.cVAE") is cVAE
    assert resolve_target("igm_tpu.models.factor_vae.FactorVAE") is FactorVAE
    assert resolve_target("igm_tpu.networks.conv64.Encoder") is Encoder
    assert resolve_target("igm_tpu.data.celeba.CelebADataModule") is CelebADataModule
    assert resolve_target("igm_tpu.data.dsprite.DataModule") is DataModule
    assert resolve_target("igm_tpu.callbacks.evaluation.FIDEvaluationCallback") \
        is FIDEvaluationCallback
    assert resolve_target("igm_tpu.callbacks.visualization.TraverseLatentCallback") \
        is TraverseLatentCallback


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from igm_tpu_torch.models.consistency import ConsistencyModel
    from igm_tpu_torch.models.ddpm import DDPM
    from igm_tpu_torch.models.distill import ProgressiveDistillation
    from igm_tpu_torch.models.score_sde import ScoreSDE
    dm = {"width": 8, "height": 8, "channels": 3, "transforms": {}}
    for cls in (DDPM, ScoreSDE, ConsistencyModel, ProgressiveDistillation):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(datamodule=dm, hidden_dim=8, dim_mults=(1,), timesteps=4, student_steps=1)
    from igm_tpu_torch.models.made import MADE
    from igm_tpu_torch.models.pixelcnn import PixelCNN
    from igm_tpu_torch.models.realnvp import RealNVP
    for cls in (MADE, PixelCNN, RealNVP):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(datamodule=dm, hidden_dim=4)
    from igm_tpu_torch.models.cvae import cVAE
    from igm_tpu_torch.models.factor_vae import FactorVAE
    from igm_tpu_torch.models.vae import VAE
    mlp = {"_target_": "igm_tpu.networks.basic.MLPEncoder", "hidden_dims": [4]}
    dec = {"_target_": "igm_tpu.networks.basic.MLPDecoder", "hidden_dims": [4]}
    for cls, kw in ((VAE, {}), (cVAE, {"n_classes": 2}), (FactorVAE, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(datamodule=dm, encoder=mlp, decoder=dec, latent_dim=2, **kw)
    from igm_tpu_torch.cli import sample_main, train_main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_main(["experiment=ddpm/cifar10", "--n", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["experiment=ddpm/cifar10"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["-m", "experiment=vae/mnist_mlp", "model.lr=1e-3,5e-4"])
    from igm_tpu_torch.tools import eval_fid, export, score_conditional, score_gallery, serve
    for main, args in ((export.main, ["experiment=vae/mnist_mlp", "--n", "1"]),
                       (export.main, ["--run", "sampler.pt"]),
                       (serve.main, ["sampler.pt", "--bench", "1"]),
                       (eval_fid.main, ["experiment=vae/mnist_mlp", "--weights", "w.pt"]),
                       (score_gallery.main, []),
                       (score_conditional.main, ["experiment=ddpm/cond_mnist",
                                                 "--ckpt", "x.npz"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)
