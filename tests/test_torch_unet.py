"""The port's UNet (igm_tpu_torch.networks.unet) against igm_tpu's Flax Unet.

Flax params go through igm_tpu_torch.interop.flax_to_torch; the same numpy
inputs go through both forwards in float32 on the CPU (the port's kernels
take their plain versions there).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from igm_tpu.networks.base import ConvTranspose as FlaxConvTranspose  # noqa: E402
from igm_tpu.networks.unet import Unet as FlaxUnet  # noqa: E402
from igm_tpu_torch.interop import flax_key_to_torch, flax_to_torch  # noqa: E402
from igm_tpu_torch.networks.base import ConvTranspose  # noqa: E402
from igm_tpu_torch.networks.unet import Unet  # noqa: E402

torch.set_num_threads(1)

# float32 on both sides; convs and reductions sum in another order, but
# GroupNorm renormalises every block, so the gap stays at a few float32 ulps
# of the O(1) output (observed 2.3e-6)
ATOL, RTOL = 1e-5, 1e-5


def flatten(tree) -> dict:
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def perturbed(params, seed):
    """Every leaf moved off its init (GroupNorm/LayerNorm scales and biases
    too), so a leaf loaded into the wrong place shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.1 * rng.normal(size=p.shape).astype(np.float32), params)


@pytest.mark.parametrize("num_classes", [0, 3])
def test_unet_forward_matches_flax(num_classes):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    t = np.array([3.0, 17.0], np.float32)
    y = np.array([1, num_classes], np.int32)      # label, null token
    args = (x, t) + ((y,) if num_classes else ())
    flax_net = FlaxUnet(dim=16, dim_mults=(1, 2), channels=3,
                        num_classes=num_classes)
    params = flax_net.init(jax.random.PRNGKey(0),
                           *map(jnp.asarray, args))["params"]
    params = perturbed(params, 1)
    want = np.asarray(flax_net.apply({"params": params}, *map(jnp.asarray, args)))

    net = Unet(dim=16, dim_mults=(1, 2), channels=3, num_classes=num_classes)
    net.load_state_dict(flax_to_torch(flatten(params)), strict=True)
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (3, 1, 1), (3, 2, 0)])
def test_conv_transpose_matches_flax(k, s, p):
    """The kernel flip and in/out swap of interop, against lax.conv_transpose
    with (k-1-p) padding as igm_tpu's ConvTranspose runs it."""
    rng = np.random.default_rng(k * 10 + s)
    x = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    flax_mod = FlaxConvTranspose(4, k, s, p)
    params = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = perturbed(params, 2)
    want = np.asarray(flax_mod.apply({"params": params}, jnp.asarray(x)))

    holder = nn.Module()
    holder.ConvTranspose_0 = ConvTranspose(3, 4, k, s, p)
    flat = {f"ConvTranspose_0/{key}": v for key, v in flatten(params).items()}
    holder.load_state_dict(flax_to_torch(flat), strict=True)
    with torch.no_grad():
        got = holder.ConvTranspose_0(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, (5 - 1) * s - 2 * p + k,
                                       (6 - 1) * s - 2 * p + k, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_param_trees_match():
    """Every Flax leaf has exactly one torch key of the same size, and the
    torch tree has nothing more."""
    flax_net = FlaxUnet(dim=16, dim_mults=(1, 2, 4), channels=3, num_classes=2)
    params = flax_net.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                           jnp.zeros((1,)), jnp.zeros((1,), jnp.int32))["params"]
    flat = flatten(params)
    state = Unet(dim=16, dim_mults=(1, 2, 4), channels=3,
                 num_classes=2).state_dict()
    mapped = {flax_key_to_torch(k): v.size for k, v in flat.items()}
    assert mapped == {k: v.numel() for k, v in state.items()}
