"""The port's SwitchMoE (igm_tpu_torch/networks/moe.py) against igm_tpu's
(igm_tpu/networks/moe.py), at a capacity that drops tokens: the output,
the load-balance aux and the per-expert load, float32, on the same
(perturbed) weights and inputs; and the port's two dispatches against
each other."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from igm_tpu.networks.moe import SwitchMoE as JaxMoE  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from igm_tpu_torch.networks.moe import SwitchMoE  # noqa: E402

torch.set_num_threads(1)

# float32, the same arithmetic in another summation order
ATOL = RTOL = 1e-5
B, T, D, E = 2, 24, 16, 4


def _flatten(tree) -> dict:
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(cf: float, dispatch: str, seed: int = 0):
    x = np.random.default_rng(seed).normal(size=(B, T, D)).astype(np.float32)
    jm = JaxMoE(dim=D, hidden=2 * D, experts=E, capacity_factor=cf, dispatch=dispatch)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(   # the biases start at 0: move them
        lambda p: p + 0.05 * rng.normal(size=p.shape).astype(np.float32),
        variables["params"])
    tm = SwitchMoE(D, 2 * D, E, cf, dispatch=dispatch)
    tm.load_state_dict(flax_to_torch(_flatten(params)), strict=True)
    return jm, params, tm, x


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_switch_moe_matches_igm_tpu(cf, dispatch):
    jm, params, tm, x = _pair(cf, dispatch)
    (want, want_aux), mut = jm.apply({"params": params}, jnp.asarray(x), mutable=["moe"])
    out, aux, load = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=RTOL)
    # routed fractions: the same counts over n, divided once each
    np.testing.assert_allclose(load.numpy(), np.asarray(mut["moe"]["load"]), rtol=1e-6)
    n = B * T
    kept = sum(min(round(c), tm.capacity(n)) for c in load.numpy() * n)
    if cf < 1:
        assert kept < n                     # the capacity drops tokens here
        dropped = (np.abs(out.detach().numpy()).sum(-1) == 0).sum()
        assert dropped == n - kept


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_scatter_dispatch_equals_einsum(cf):
    """Slots are unique, so the two dispatches are one function: outputs and
    gradients equal (the einsum's one-hot products add exact zeros)."""
    _, params, sca, x = _pair(cf, "scatter")
    ein = SwitchMoE(D, 2 * D, E, cf, dispatch="einsum")
    ein.load_state_dict(sca.state_dict())
    results = []
    for mod in (sca, ein):
        xt = torch.from_numpy(x).requires_grad_(True)
        out, aux, _ = mod(xt)
        loss = (out ** 2).mean() + 0.01 * aux
        results.append((out.detach(), aux.detach(),
                        torch.autograd.grad(loss, [xt, *mod.parameters()])))
    (o_s, a_s, g_s), (o_e, a_e, g_e) = results
    torch.testing.assert_close(o_s, o_e, atol=1e-6, rtol=1e-6)
    assert torch.equal(a_s, a_e)
    for a, b in zip(g_s, g_e):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_auto_dispatch_rule():
    """auto takes scatter when the token count passes 4 d, as igm_tpu."""
    moe = SwitchMoE(D, 2 * D, E, dispatch="auto")
    gen = torch.Generator().manual_seed(0)
    moe.reset_parameters(gen)
    moe.router.reset_parameters(gen)
    x = torch.randn(1, 4 * D + 1, D, generator=gen)
    ref = SwitchMoE(D, 2 * D, E, dispatch="scatter")
    ref.load_state_dict(moe.state_dict())
    assert torch.equal(moe(x)[0], ref(x)[0])


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_token_counter_counts_routed_kept_and_slots(cf, dispatch):
    """The tracing registry's ``moe.tokens`` after one forward: routed = the
    tokens, kept + dropped = routed (dropped: the tokens past their
    expert's capacity, counted here from the router), slots = E x
    ``capacity()``."""
    from igm_tpu_torch.core import trace
    _, _, tm, x = _pair(cf, dispatch)
    before = trace.counters().get("moe.tokens", [0.0, 0.0, 0.0])
    xt = torch.from_numpy(x)
    tm(xt)
    routed, kept, slots = (a - b for a, b in zip(trace.counters()["moe.tokens"], before))
    n = B * T
    cap = tm.capacity(n)
    per_expert = np.bincount(tm.router(xt.reshape(n, D)).argmax(-1).numpy(), minlength=E)
    dropped = int(np.maximum(per_expert - cap, 0).sum())
    assert routed == n and slots == E * cap
    assert kept + dropped == routed
    if cf < 1:
        assert dropped > 0
