"""The port's DiT (igm_tpu_torch/networks/dit.py) and its DDPM train step
against igm_tpu's, at a tiny size.

Both sides hold the same weights: igm_tpu's Flax init, perturbed (the
adaLN-Zero init makes the network output exactly 0, which would compare
nothing), converted through igm_tpu_torch.interop.  float32 throughout.
The train steps replay igm_tpu's key schedule as
tests/test_torch_train_step.py does and hold the loss, every gradient and
the parameters after one Adam step at that file's tolerances.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from igm_tpu.config import to_node  # noqa: E402
from igm_tpu.models.ddpm import DDPM as JaxDDPM  # noqa: E402
from igm_tpu.models.edm import EDM as JaxEDM  # noqa: E402
from igm_tpu.models.flow_matching import FlowMatching as JaxFlow  # noqa: E402
from igm_tpu.networks.dit import DiT as JaxDiT  # noqa: E402
from igm_tpu.ops import diffusion as jgd  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch, unstack_blocks  # noqa: E402
from igm_tpu_torch.models.ddpm import DDPM  # noqa: E402
from igm_tpu_torch.models.edm import EDM  # noqa: E402
from igm_tpu_torch.models.flow_matching import FlowMatching  # noqa: E402
from igm_tpu_torch.networks.dit import DiT  # noqa: E402
from igm_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from tests._torch_parity import LR, _flatten, _perturb, check_train_step, dm as _dm  # noqa: E402

torch.set_num_threads(1)

# float32: the same arithmetic summed in another order (a few ulps a layer)
ATOL = RTOL = 1e-5
SMALL = dict(dim=32, depth=2, heads=2, patch=2)


def _inputs(b, h, w, c, num_classes=0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    t = rng.uniform(0, 999, size=(b,)).astype(np.float32)
    y = rng.integers(0, num_classes + 1, size=(b,)).astype(np.int32) if num_classes else None
    return x, t, y


def _run_pair(jax_kw, torch_kw, shape=(3, 8, 8, 3), num_classes=0):
    """igm_tpu's DiT(**jax_kw) and the port's DiT(**torch_kw) on the same
    perturbed weights and inputs -> (want, got)."""
    c = shape[-1]
    jnet = JaxDiT(channels=c, num_classes=num_classes, **jax_kw)
    x, t, y = _inputs(*shape, num_classes)
    args = (jnp.asarray(x), jnp.asarray(t)) + ((jnp.asarray(y),) if num_classes else ())
    variables = jnet.init(jax.random.PRNGKey(0), *args)
    params = _perturb(variables["params"])
    if "moe" in variables:
        want, _ = jnet.apply({"params": params}, *args, mutable=["moe"])
    else:
        want = jnet.apply({"params": params}, *args)
    tnet = DiT(channels=c, num_classes=num_classes, **torch_kw).eval()
    tnet.load_state_dict(flax_to_torch(_flatten(params)), strict=True)
    targs = (torch.from_numpy(x), torch.from_numpy(t)) + (
        (torch.from_numpy(y),) if num_classes else ())
    with torch.no_grad():
        got = tnet(*targs)
    return np.asarray(want), got.numpy()


FORWARD_CASES = {
    "xla": (dict(attn="xla"), dict(attn="xla"), 0),
    "xla_conditional": (dict(attn="xla"), dict(attn="xla"), 3),
    "remat": (dict(attn="remat", remat=True), dict(attn="remat", remat=True), 0),
    "scan_weights": (dict(block_mode="scan"), dict(), 0),
    "moe_scatter": (dict(moe_experts=4, moe_every=2, moe_capacity=0.5,
                         moe_dispatch="scatter"),
                    dict(moe_experts=4, moe_every=2, moe_capacity=0.5,
                         moe_dispatch="scatter"), 0),
    "moe_einsum_conditional": (dict(moe_experts=4, moe_every=1, moe_capacity=0.75,
                                    moe_dispatch="einsum"),
                               dict(moe_experts=4, moe_every=1, moe_capacity=0.75,
                                    moe_dispatch="einsum"), 3),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_dit_forward_matches_igm_tpu(case):
    jax_kw, torch_kw, nc = FORWARD_CASES[case]
    want, got = _run_pair({**SMALL, **jax_kw}, {**SMALL, **torch_kw}, num_classes=nc)
    assert got.shape == want.shape == (3, 8, 8, 3)
    assert np.abs(want).max() > 0.05                 # not the vacuous init
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_dit_flash_matches_igm_tpu_xla():
    """The port's SDPA arm on the CPU against igm_tpu's xla arm (JAX's stock
    flash kernel runs on a TPU only), at 128 tokens (16x32 at patch 2)."""
    want, got = _run_pair({**SMALL, "attn": "xla"}, {**SMALL, "attn": "flash"},
                          shape=(2, 16, 32, 1))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_dit_zero_output_at_init():
    """adaLN-Zero: every modulation and the head kernel start at exact zeros,
    so the prediction is exactly 0, bit for bit."""
    net = DiT(channels=3, num_classes=2, **SMALL)
    gen = torch.Generator().manual_seed(0)
    for m in net.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    x, t, y = _inputs(2, 8, 8, 3, 2)
    out = net(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    assert out.dtype == torch.float32 and out.shape == (2, 8, 8, 3)
    assert torch.equal(out, torch.zeros_like(out))


def test_dit_flash_refuses_tokens_off_the_128_block():
    net = DiT(channels=1, attn="flash", **SMALL)
    with pytest.raises(ValueError, match="128"):
        net(torch.zeros(2, 8, 8, 1), torch.zeros(2))


def test_dit_refuses_parallel_meshes():
    """igm_tpu's errors for the pipeline and sequence meshes: a pipe_mesh
    without a 'stage' axis, both meshes at once, the MoE with the stacked
    layout, an sp_mesh without a 'model' axis (at the forward, where
    igm_tpu's apply raises it); the MoE DiT on a sequence mesh is slice
    7d's expert half; enable_sequence_parallel and enable_pipeline need
    network=dit."""
    cpu = torch.device("cpu")
    data = Mesh(1, 0, cpu)
    stage = Mesh(1, 0, cpu, axes=(("data", 1), ("stage", 2)), coords=(("data", 0), ("stage", 0)),
                 mode="pipeline")
    model = Mesh(1, 0, cpu, axes=(("data", 1), ("model", 2)), coords=(("data", 0), ("model", 0)))
    with pytest.raises(ValueError, match="pipe_mesh needs a 'stage' axis"):
        DiT(channels=3, block_mode="scan", pipe_mesh=data, **SMALL)
    with pytest.raises(ValueError, match="mutually exclusive"):
        DiT(channels=3, block_mode="scan", pipe_mesh=stage, sp_mesh=model, **SMALL)
    with pytest.raises(ValueError, match="unrolled block layout"):
        DiT(channels=3, block_mode="scan", moe_experts=2, **SMALL)
    with pytest.raises(NotImplementedError, match="slice 7d's expert half"):
        DiT(channels=3, sp_mesh=model, moe_experts=2, **SMALL)
    net = DiT(channels=3, sp_mesh=data, **SMALL)
    with pytest.raises(ValueError, match="sp_mesh needs a 'model' axis"):
        net(torch.zeros(2, 8, 8, 3), torch.zeros(2))
    m = DDPM({"width": 8, "height": 8, "channels": 3}, network="unet", hidden_dim=8,
             dim_mults=(1,), device="cpu")
    with pytest.raises(ValueError, match="needs network=dit"):
        m.enable_sequence_parallel(model)
    with pytest.raises(ValueError, match="needs network=dit"):
        m.enable_pipeline(stage, 2)


def test_dit_remat_equals_xla_exactly():
    """attn=remat and remat=True recompute the same arithmetic: the loss and
    every gradient equal the plain arm's bit for bit."""
    torch.manual_seed(0)
    x, t, _ = _inputs(2, 8, 8, 3)
    results = []
    for kw in (dict(attn="xla"), dict(attn="remat"), dict(attn="xla", remat=True)):
        net = DiT(channels=3, **SMALL, **kw)
        gen = torch.Generator().manual_seed(0)
        for m in net.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        loss = (net(torch.from_numpy(x), torch.from_numpy(t)) ** 2).sum()
        results.append((loss.detach(), torch.autograd.grad(loss, list(net.parameters()))))
    (l0, g0), *rest = results
    for loss, grads in rest:
        assert torch.equal(loss, l0)
        for a, b in zip(grads, g0):
            assert torch.equal(a, b)


def test_dit_init_statistics():
    """Flax's defaults at the full width: lecun_normal kernels (std
    1/sqrt(fan_in)), zero biases, zero modulations and head kernel, the
    class table N(0, 1/dim) with a null row, and the MoE quirk: Flax counts
    E into the fan-in of the stacked expert leaves (w_up std 1/sqrt(8*384)
    = 0.01804, w_dn 1/sqrt(8*1536) = 0.00902, the values igm_tpu draws)."""
    net = DiT(dim=384, depth=2, heads=6, patch=2, channels=3, num_classes=10,
              moe_experts=8, moe_every=2)
    gen = torch.Generator().manual_seed(0)
    for m in net.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    blk, moe = net.DiTBlock_0, net.DiTBlock_1.moe

    def close(t, want):
        # five standard errors of a sample std over t.numel() draws
        tol = 5.0 / np.sqrt(2 * t.numel())
        assert abs(t.std().item() / want - 1) < tol, (t.std().item(), want)

    close(blk.qkv.weight, 384 ** -0.5)
    close(blk.Dense_1.weight, 1536 ** -0.5)
    close(net.Dense_0.weight, 256 ** -0.5)
    close(moe.w_up, (8 * 384) ** -0.5)
    close(moe.w_dn, (8 * 1536) ** -0.5)
    close(moe.router.weight, 384 ** -0.5)
    close(net.class_emb.embedding, 384 ** -0.5)
    assert net.class_emb.embedding.shape == (11, 384)
    assert blk.qkv.weight.abs().max().item() <= 2 * 384 ** -0.5 / 0.87962566103423978
    for p in (blk.qkv.bias, moe.b_up, moe.b_dn, blk._Modulation_0.Dense_0.weight,
              blk._Modulation_0.Dense_0.bias, net._Modulation_0.Dense_0.weight,
              net.head.weight, net.head.bias):
        assert torch.equal(p, torch.zeros_like(p))


@pytest.mark.parametrize("moe,count", [(0, 21_831_564), (8, 54_927_756)])
def test_dit_full_width_parameter_count(moe, count):
    """The four DiT configs (384 wide, 8 deep, 6 heads, patch 2, 32x32x3):
    igm_tpu's Flax tree counts these."""
    net = DiT(dim=384, depth=8, heads=6, patch=2, channels=3, moe_experts=moe, moe_every=2)
    assert sum(p.numel() for p in net.parameters()) == count


# ------------------------------------------------------------ interop
TREES = {
    "ddpm_dit": (JaxDDPM, DDPM, dict(network="dit", hidden_dim=32, depth=2, heads=2)),
    "ddpm_dit_moe": (JaxDDPM, DDPM, dict(network="dit", hidden_dim=32, depth=4, heads=2,
                                         moe_experts=4, moe_every=2)),
    "ddpm_dit_scan": (JaxDDPM, DDPM, dict(network="dit", hidden_dim=32, depth=3, heads=2,
                                          block_mode="scan")),
    "edm_dit": (JaxEDM, EDM, dict(network="dit", hidden_dim=32, depth=2, heads=2,
                                  num_classes=3)),
    "flow_dit": (JaxFlow, FlowMatching, dict(network="dit", hidden_dim=32, depth=2,
                                             heads=2)),
    "edm_unet": (JaxEDM, EDM, dict(hidden_dim=8, dim_mults=(1, 2))),
    "flow_unet": (JaxFlow, FlowMatching, dict(hidden_dim=8, dim_mults=(1, 2),
                                              num_classes=3)),
}


@pytest.mark.parametrize("tree", list(TREES))
def test_interop_covers_every_leaf(tree):
    """Every leaf of igm_tpu's whole-model tree (a scan leaf: each of its
    per-block slices) maps onto exactly one state_dict key of the port's
    modules, with that key's shape, and no key is left over."""
    jcls, tcls, kw = TREES[tree]
    jm = jcls(datamodule=to_node(_dm()), compute_dtype="float32", **kw)
    jm.steps_per_epoch = 1
    shapes = jax.eval_shape(jm.init_state, jax.random.PRNGKey(0)).params
    flat = {k: np.zeros(v.shape, np.float32) for k, v in _flatten(shapes).items()}
    per_slice = unstack_blocks(flat)
    converted = flax_to_torch(flat)
    assert len(converted) == len(per_slice)          # no two leaves on one key
    tm = tcls(datamodule=_dm(), device="cpu", **kw)
    want = {k: tuple(v.shape) for k, v in tm.modules.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in converted.items()} == want
    tm.modules.load_state_dict(converted, strict=True)


# ------------------------------------------------------------ train step
DDPM_CASES = {
    "l1_eps": dict(),
    "v_min_snr": dict(parameterization="v", snr_gamma=5.0, loss_type="l2"),
    "moe_aux": dict(moe_experts=4, moe_every=2, moe_capacity=0.75, moe_aux_weight=0.5),
}
T_STEPS, BATCH = 20, 4


@pytest.mark.parametrize("case", list(DDPM_CASES))
def test_ddpm_dit_train_step_matches_igm_tpu(case):
    kw = dict(network="dit", hidden_dim=32, depth=2, heads=2, timesteps=T_STEPS, lr=LR,
              compute_dtype="float32", **DDPM_CASES[case])
    jm = JaxDDPM(datamodule=to_node(_dm()), **kw)
    jm.steps_per_epoch = 1
    state = jax.jit(jm.init_state)(jax.random.PRNGKey(0))
    params = _perturb(state.params["denoise"])
    state = state.replace(params={"denoise": params})
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (BATCH, 8, 8, 3), np.uint8)
    labels = np.zeros(BATCH, np.int32)
    keys = jax.random.split(state.rng, 3)[1:]
    t = jax.random.randint(keys[0], (BATCH,), 0, T_STEPS)
    noise = jax.random.normal(keys[1], imgs.shape)
    x0 = jm.preprocess(jnp.asarray(imgs))
    hp = jm.hparams

    def jax_loss(p):
        x_noisy = jgd.q_sample(jm.tables, x0, t, noise)
        target = (jgd.v_target(jm.tables, x0, t, noise)
                  if hp.parameterization == "v" else noise)
        w = jgd.loss_weight(jm.tables, t, x0.ndim, hp.parameterization,
                            float(hp.snr_gamma))
        pred, mut = jm.modules.apply("denoise", {"denoise": p}, state.mutables,
                                     x_noisy, t)
        err = target - pred
        loss = (w * (jnp.abs(err) if hp.loss_type == "l1" else err ** 2)).mean()
        if hp.moe_experts:
            auxes = [v for v in jax.tree_util.tree_leaves(mut["moe"]) if v.ndim == 0]
            loss = loss + float(hp.moe_aux_weight) * sum(auxes) / len(auxes)
        return loss

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    new_state, want_metrics = jax.jit(jm.train_step)(
        state, (jnp.asarray(imgs), jnp.asarray(labels)))
    if hp.moe_experts:
        assert set(want_metrics) == {"train_loss/loss", "train_loss/moe_aux",
                                     "moe/load_entropy", "moe/min_share"}

    tm = DDPM(datamodule=_dm(), device="cpu", **kw)
    tstate = tm.init_state(0)
    tt, tnoise = torch.from_numpy(np.array(t, np.int64)), torch.from_numpy(np.array(noise))
    batch = (torch.from_numpy(imgs), torch.from_numpy(labels))

    def torch_step():
        new, metrics = tm.train_step(tstate, batch, t=tt, noise=tnoise)
        assert new.step == 1 and set(metrics) == set(want_metrics)
        for key, value in want_metrics.items():
            np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-5,
                                       atol=1e-7, err_msg=key)
        return metrics

    check_train_step(tm, "denoise", params, want_loss, want_grads, new_state,
                     lambda: tm.loss(tm.preprocess(batch[0]), tt, tnoise), torch_step,
                     want_metrics=want_metrics)


def test_step_flop_counter_counts_bmm_with_out_dtype():
    """The trainer's FLOP count takes the bf16 attention's
    ``torch.bmm(..., out_dtype=float32)`` (torch's own bmm formula raises
    on it): 2 B M N K, as for a plain bmm.  Meta tensors: no kernel runs."""
    from igm_tpu_torch.core.trainer import step_flop_counter
    a = torch.empty(2, 4, 8, dtype=torch.bfloat16, device="meta")
    b = torch.empty(2, 8, 3, dtype=torch.bfloat16, device="meta")
    with step_flop_counter() as counter:
        torch.bmm(a, b, out_dtype=torch.float32)
        torch.bmm(a, b)
    assert counter.get_total_flops() == 2 * (2 * 2 * 4 * 3 * 8)
