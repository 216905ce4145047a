"""What the adversarial zoo's parity tests share: tiny network configs, the
two models on the same Flax weights (perturbed) and moved BatchNorm
statistics, and one train step of the port held against igm_tpu's.

igm_tpu's gradients and its parameters before each update are read by a
probe ``optax`` transform chained ahead of each of its optimizers (nothing
in igm_tpu changes): it records the gradients and the parameters of the
first two updates of a step (AAE's ``g`` updates twice).  The port's
updates are observed by wrapping ``OptimizerSet._apply``: the gradients it
applies, the parameters it leaves.  After each of the port's updates its
parameters are set to igm_tpu's after the same update, so that a later
phase of the step (a later update, or a forward that reads the updated
parameters) starts where igm_tpu's did: Adam's first step moves a
parameter whose gradient is 0 up to rounding (a bias ahead of a
BatchNorm) by lr times a sign that rounding decides, and that would move
the later phases' statistics.  Compared: the metrics (NaN where igm_tpu
has NaN), the updates each optimizer made, every gradient of each update,
the parameters each update produced (where the gradient's sign is
certain; elsewhere within twice the step's bound), and every buffer after
the step.
"""
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from _torch_parity import (G_FLOOR, GRAD_ATOL_SCALE, GRAD_RTOL, LOSS_RTOL, PARAM_ATOL,
                           PARAM_RTOL, _flatten, _perturb)
from igm_tpu.config import to_node
from igm_tpu.core.optim import OptimizerSet
from igm_tpu_torch.interop import flax_mutables_to_torch, flax_to_torch

BATCH = 8
# float32 outputs through <= 8 layers on both sides: a few ulps of the largest
RTOL = 1e-5
# a metric that is the mean of logits of order 1 (pred_fake, real_logit) may
# cancel to a few hundredths: its terms agree to a few ulps of 1
METRIC_ATOL = 2e-6


def dm(size: int, channels: int, normalize: bool = True) -> dict:
    return {"width": size, "height": size, "channels": channels,
            "transforms": {"convert": True, "normalize": normalize}}


def mlp(size: int = 8, enc_norm: str = "batch") -> dict:
    """8x8 MLP networks, widths 12-16, batch-normed (the encoder's first
    layer layer-normed, as its config makes it; the rest ``enc_norm``)."""
    return {"encoder": {"_target_": "igm_tpu.networks.basic.MLPEncoder",
                        "hidden_dims": [16, 12], "width": size, "height": size,
                        "norm_type": enc_norm},
            "decoder": {"_target_": "igm_tpu.networks.basic.MLPDecoder",
                        "hidden_dims": [12, 16], "width": size, "height": size,
                        "norm_type": "batch"},
            "dm": dm(size, 1)}


def conv32(width: int = 4, norm: str = "batch") -> dict:
    return {"encoder": {"_target_": "igm_tpu.networks.conv32.Encoder", "ndf": width,
                        "norm_type": norm},
            "decoder": {"_target_": "igm_tpu.networks.conv32.Decoder", "ngf": width,
                        "norm_type": norm},
            "dm": dm(32, 3)}


def conv64(width: int = 4, norm: str = "batch") -> dict:
    return {"encoder": {"_target_": "igm_tpu.networks.conv64.Encoder", "ndf": width,
                        "norm_type": norm},
            "decoder": {"_target_": "igm_tpu.networks.conv64.Decoder", "ngf": width,
                        "norm_type": norm},
            "dm": dm(64, 3)}


def conv_mnist(width: int = 4) -> dict:
    return {"encoder": {"_target_": "igm_tpu.networks.basic.ConvEncoder", "ndf": width,
                        "norm_type": "batch"},
            "decoder": {"_target_": "igm_tpu.networks.basic.ConvDecoder", "ngf": width,
                        "norm_type": "batch"},
            "dm": dm(28, 1, normalize=False)}


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def moved_stats(mutables, seed):
    """BatchNorm statistics moved off their init (mean + 0.1 N(0, 1), var
    times U(0.5, 2))."""
    rng = np.random.default_rng(seed)

    def move(path, v):
        v = np.asarray(v)
        if path[-1].key == "var":
            return jnp.asarray(v * rng.uniform(0.5, 2.0, v.shape), jnp.float32)
        return jnp.asarray(v + 0.1 * rng.normal(size=v.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(move, mutables)


def weights(state) -> dict:
    return {**flax_to_torch(_flatten(state.params)),
            **flax_mutables_to_torch(_flatten(state.mutables))}


def _probe() -> optax.GradientTransformation:
    """Records the gradients and parameters of its first two calls."""
    def init(params):
        z = jax.tree_util.tree_map(jnp.zeros_like, params)
        return {"n": jnp.zeros((), jnp.int32), "g": (z, z), "p": (z, z)}

    def update(updates, state, params=None):
        n = state["n"]

        def keep(i, new, old):
            return jax.tree_util.tree_map(lambda a, b: jnp.where(n == i, a, b), new, old)

        return updates, {"n": n + 1,
                         "g": tuple(keep(i, updates, state["g"][i]) for i in range(2)),
                         "p": tuple(keep(i, params, state["p"][i]) for i in range(2))}

    return optax.GradientTransformation(init, update)


# igm_tpu's models by configuration, each with its compiled init and train
# step: a configuration's cases (its phases, its steps) share one
# compilation of each (an eager Flax init compiles each of its ~100
# operations on its own, 10-20 s)
_MODELS = {}


def jax_model(jax_cls, nets: dict, names=("netG", "netD"), steps_per_epoch: int = 5, **kw):
    """igm_tpu's model of this configuration, its jitted ``init_state``
    and its jitted ``train_step``."""
    key = repr((jax_cls, nets, names, steps_per_epoch, sorted(kw.items())))
    if key not in _MODELS:
        dec, enc = names
        jm = jax_cls(datamodule=to_node(nets["dm"]), **{dec: to_node(nets["decoder"]),
                                                         enc: to_node(nets["encoder"])}, **kw)
        jm.steps_per_epoch = steps_per_epoch
        init = jax.jit(jm.init_state)
        init(jax.random.PRNGKey(0))              # its tracing sets jm.optimizers
        plain = [(n, jm.optimizers.tx(n), jm.optimizers.modules_of(n))
                 for n in jm.optimizers.names()]
        _MODELS[key] = (jm, init, jax.jit(jm.train_step), plain)
    return _MODELS[key]


def setup(jax_cls, port_cls, nets: dict, names=("netG", "netD"), seed: int = 0,
          steps_per_epoch: int = 5, **kw):
    """igm_tpu's model and state (params perturbed, statistics moved, a
    probe ahead of each optimizer), the port's model on the same weights,
    and the port's state.  ``names``: the constructor's arguments for the
    decoder and encoder configs."""
    dec, enc = names
    jm, init, _, plain = jax_model(jax_cls, nets, names, steps_per_epoch, **kw)
    state = init(jax.random.PRNGKey(seed))
    state = state.replace(params=_perturb(state.params, seed + 1),
                          mutables=moved_stats(state.mutables, seed + 2))
    jm.optimizers = OptimizerSet()
    for name, tx, mods in plain:
        jm.optimizers.add(name, optax.chain(_probe(), tx), mods)
    state = state.replace(opt_states=jm.optimizers.init(state.params))
    tm = port_cls(datamodule=nets["dm"], **{dec: nets["decoder"], enc: nets["encoder"]},
                  device="cpu", **kw)
    tm.steps_per_epoch = steps_per_epoch
    tstate = tm.init_state(0)
    tm.modules.load_state_dict(weights(state), strict=True)
    return jm, state, tm, tstate


def batch(nets: dict, seed: int, n: int = BATCH):
    d = nets["dm"]
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, d["height"], d["width"], d["channels"]), np.uint8)
    return imgs, rng.integers(0, 10, n).astype(np.int32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


class Recorder:
    """Wraps the port's ``OptimizerSet._apply``: per optimizer, the
    gradients and resulting parameters of each update (by parameter name),
    and, after each update, the parameters set to ``targets[name][i]``."""

    def __init__(self, tm):
        self.tm = tm
        self.names = {id(p): k for k, p in tm.modules.named_parameters()}
        self.grads = defaultdict(list)
        self.after = defaultdict(list)
        self.order = []
        self.targets = {}
        inner = tm.optimizers._apply

        def apply(opt_name, opt, params, grads, count=None, sr_seeds=None):
            self.grads[opt_name].append({
                self.names[id(p)]: (torch.zeros_like(p) if g is None else g).detach().clone()
                for p, g in zip(params, grads)})
            inner(opt_name, opt, params, grads, count, sr_seeds)
            self.after[opt_name].append({self.names[id(p)]: p.detach().clone()
                                         for p in params})
            self.order.append(opt_name)
            i = len(self.after[opt_name]) - 1
            target = self.targets.get(opt_name, [])
            if i < len(target):
                with torch.no_grad():
                    for p in params:
                        p.copy_(target[i][self.names[id(p)]])

        tm.optimizers._apply = apply


def jax_updates(jm, new_state):
    """Per optimizer of igm_tpu's step: (gradients of each update, the
    parameters after each update), by port parameter name."""
    out = {}
    for name in jm.optimizers.names():
        probe = new_state.opt_states[name][0]
        n = int(probe["n"])
        tree = lambda x: flax_to_torch(_flatten(x))  # noqa: E731
        grads = [tree(probe["g"][i]) for i in range(n)]
        mods = jm.optimizers.modules_of(name)
        final = tree({m: new_state.params[m] for m in mods})
        after = [tree(probe["p"][i]) for i in range(1, n)] + [final]
        out[name] = (grads, after)
    return out


def check_step(jm, state, tm, tstate, imgs, labels, bounds: dict, draws=None, step=None):
    """One train step of each model on the same batch (the port with
    ``draws`` injected), held together as the module docstring says.
    ``bounds``: per optimizer, the largest move of a parameter by one
    update.  Returns (igm_tpu's new state, its metrics, the port's
    metrics, the recorder)."""
    if step is not None:
        state = state.replace(step=jnp.asarray(step, jnp.int32))
        tstate.step = step
    step_fn = next(fn for m, _, fn, _ in _MODELS.values() if m is jm)
    new_state, metrics = step_fn(state, (jnp.asarray(imgs), jnp.asarray(labels)))
    want = jax_updates(jm, new_state)
    rec = Recorder(tm)
    rec.targets = {name: after for name, (_, after) in want.items()}
    tstate, tmetrics = tm.train_step(tstate, (t(imgs), t(labels)), **(draws or {}))
    assert tstate.step == int(new_state.step)
    assert set(tmetrics) == set(metrics)
    for k, v in metrics.items():
        v, got = float(v), float(tmetrics[k])
        assert np.isnan(v) == np.isnan(got), k
        if not np.isnan(v):
            np.testing.assert_allclose(got, v, rtol=LOSS_RTOL, atol=METRIC_ATOL, err_msg=k)
    for name, (grads, after) in want.items():
        assert len(rec.grads[name]) == len(grads), (name, len(rec.grads[name]), len(grads))
        assert tstate.counts.get(name, 0) == len(grads), name
        sure = None
        for i, (want_g, want_p) in enumerate(zip(grads, after)):
            got_g, got_p = rec.grads[name][i], rec.after[name][i]
            assert set(got_g) == set(want_g)
            scale = max(float(np.abs(g.numpy()).max()) for g in want_g.values())
            floor = max(G_FLOOR, 2 * GRAD_ATOL_SCALE * scale)
            for k, g in want_g.items():
                np.testing.assert_allclose(got_g[k].numpy(), g.numpy(),
                                           atol=GRAD_ATOL_SCALE * scale, rtol=GRAD_RTOL,
                                           err_msg=f"{name} update {i}: {k}")
            sure = {k: (np.abs(g.numpy()) > floor) & (True if sure is None else sure[k])
                    for k, g in want_g.items()}
            for k, p in want_p.items():
                got, w, big = got_p[k].numpy(), p.numpy(), sure[k]
                np.testing.assert_allclose(got[big], w[big], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                           err_msg=f"{name} update {i}: {k}")
                assert np.all(np.abs(got - w) <= 2 * bounds[name] * (1 + 1e-3)), (name, i, k)
    want_b = flax_mutables_to_torch(_flatten(new_state.mutables))
    buffers = dict(tm.modules.named_buffers())
    assert set(buffers) == set(want_b)
    for k, v in want_b.items():
        close(buffers[k].numpy(), v.numpy())
    return new_state, metrics, tmetrics, rec
