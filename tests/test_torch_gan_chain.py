"""The zoo's alternating models over several steps on the CPU, against
igm_tpu's ``train_step`` chained as many times: GAN (G/D every other
step), WGAN (G every n_critic + 1 steps) and AGE (E every 1 + g_updates
steps, each optimizer's learning rate halving on its own update count).
Two periods of steps, igm_tpu's z injected (``latent_noise``), eagerly:
one ``train_step`` at a time, and ``train_step_n`` at K = 3, a K that is
not a multiple of the period, which must give the same state bit for bit.
Compared with igm_tpu's: which optimizer each step updated, each step's
metrics (NaN where igm_tpu's are) and each chunk's nan-mean, the update
counts, and the parameters and buffers at the end.  8x8 MLP networks,
layer-normed (``_torch_gan.mlp``): a BatchNorm's bias ahead of it gets a
gradient that is 0 up to rounding, whose Adam step's sign rounding decides
on either side."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from _torch_gan import BATCH, _MODELS, batch, mlp, setup, t, weights  # noqa: E402
from igm_tpu.core.optim import halving_lr as jax_halving_lr  # noqa: E402
from igm_tpu.models.age import AGE as JaxAGE  # noqa: E402
from igm_tpu.models.gan import GAN as JaxGAN  # noqa: E402
from igm_tpu.models.wgan import WGAN as JaxWGAN  # noqa: E402
from igm_tpu_torch.models.age import AGE  # noqa: E402
from igm_tpu_torch.models.base import merge_metrics  # noqa: E402
from igm_tpu_torch.models.gan import GAN  # noqa: E402
from igm_tpu_torch.models.wgan import WGAN  # noqa: E402

torch.set_num_threads(1)

LATENT, K = 4, 3
# after two periods of Adam or RMSprop steps: float32 differences of a few
# ulps in the gradients move a parameter by far less than one step
PARAM_ATOL = 2e-6
CASES = {
    "gan": (JaxGAN, GAN, ("netG", "netD"), dict(lrG=1e-3, lrD=2e-3), 1),
    "wgan": (JaxWGAN, WGAN, ("netG", "netD"), dict(n_critic=2, lrG=2e-4, lrD=2e-4), 1),
    # drop_lr_epoch = steps_per_epoch = 1: each update halves its optimizer's rate
    "age": (JaxAGE, AGE, ("decoder", "encoder"),
            dict(lrE=1e-3, lrG=2e-3, e_recon_x_weight=3.0, g_recon_x_weight=5.0,
                 drop_lr_epoch=1, g_updates=2), 1),
}


def _jax_chain(jm, state, steps, imgs, labels):
    """igm_tpu's chained steps: per step its z, metrics and updated
    optimizers; the final state."""
    step_fn = next(fn for m, _, fn, _ in _MODELS.values() if m is jm)
    zs, metrics, updated = [], [], []
    calls = {n: 0 for n in jm.optimizers.names()}
    for i in range(steps):
        _, rng = state.next_rng()
        zs.append(t(jax.random.normal(rng, (BATCH, LATENT))))
        state, m = step_fn(state, (jnp.asarray(imgs[i]), jnp.asarray(labels[i])))
        metrics.append({k: float(v) for k, v in m.items()})
        now = {n: int(state.opt_states[n][0]["n"]) for n in calls}
        updated.append(sorted(n for n in calls if now[n] > calls[n]))
        calls = now
    return state, zs, metrics, updated, calls


@pytest.mark.parametrize("name", sorted(CASES))
def test_eager_chain_matches_chained_igm_tpu(name):
    jax_cls, port_cls, names, kw, spe = CASES[name]
    nets = mlp(enc_norm="layer")
    for net in ("encoder", "decoder"):
        nets[net] = dict(nets[net], norm_type="layer")
    jm, state, tm, tstate = setup(jax_cls, port_cls, nets, names=names, latent_dim=LATENT,
                                  steps_per_epoch=spe, **kw)
    period = tm.phase_period
    steps = 2 * period
    data = [batch(nets, 50 + i) for i in range(steps)]
    imgs = np.stack([d[0] for d in data])
    labels = np.stack([d[1] for d in data])
    new_state, zs, jmetrics, updated, calls = _jax_chain(jm, state, steps, imgs, labels)

    # one step at a time: the branch sequence, each step's NaN pattern and values
    start = {k: v.clone() for k, v in tm.modules.state_dict().items()}
    lrs, order = {}, []
    inner = tm.optimizers._apply

    def apply(opt_name, opt, params, grads, count=None, sr_seeds=None):
        inner(opt_name, opt, params, grads, count, sr_seeds)
        order.append(opt_name)
        lrs.setdefault(opt_name, []).append(float(opt.param_groups[0]["lr"]))

    tm.optimizers._apply = apply
    per_step = []
    for i in range(steps):
        before = len(order)
        tstate, m = tm.train_step(tstate, (t(imgs[i]), t(labels[i])), z=zs[i])
        assert sorted(order[before:]) == updated[i], i
        per_step.append({k: float(v) for k, v in m.items()})
        for k, v in jmetrics[i].items():
            assert np.isnan(v) == np.isnan(per_step[i][k]), (i, k)
            if not np.isnan(v):
                np.testing.assert_allclose(per_step[i][k], v, rtol=1e-4, atol=1e-5,
                                           err_msg=f"step {i}: {k}")
    assert tstate.step == steps and tstate.counts == calls
    for opt_name, got in lrs.items():          # each rate follows its own count
        tx = tm.optimizers.tx(opt_name)
        assert got == [tx.lr_at(c) for c in range(len(got))], opt_name
    want_p = weights(new_state)
    for k, v in tm.modules.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_p[k].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    one_at_a_time = {k: v.clone() for k, v in tm.modules.state_dict().items()}

    # train_step_n at K = 3 from the same start: the same state bit for bit
    tm.optimizers._apply = inner
    tm2 = port_cls(datamodule=nets["dm"], **{names[0]: nets["decoder"],
                                              names[1]: nets["encoder"]},
                   latent_dim=LATENT, device="cpu", **kw)
    tm2.steps_per_epoch = spe
    tstate2 = tm2.init_state(0)
    tm2.modules.load_state_dict(start)
    queue = iter(zs)
    tm2.latent_noise = lambda n, generator: next(queue)
    chunks = []
    for s in range(0, steps, K):
        chunk = (t(imgs[s:s + K]), t(labels[s:s + K]))
        tstate2, m = tm2.train_step_n(tstate2, chunk)
        chunks.append({k: float(v) for k, v in m.items()})
        want = merge_metrics([{k: torch.tensor(v) for k, v in m.items()}
                              for m in per_step[s:s + K]])
        assert chunks[-1].keys() == want.keys()
        for k, v in want.items():
            v = float(v)
            assert v == chunks[-1][k] or (np.isnan(v) and np.isnan(chunks[-1][k])), k
            vals = [m[k] for m in jmetrics[s:s + K] if not np.isnan(m[k])]
            want_j = np.mean(vals) if vals else np.nan
            np.testing.assert_allclose(chunks[-1][k], want_j, rtol=1e-4, atol=1e-5, err_msg=k)
    assert tstate2.step == steps and tstate2.counts == tstate.counts
    for k, v in tm2.modules.state_dict().items():
        assert torch.equal(v, one_at_a_time[k]), k
    for opt_name in tstate.opt_states:
        a, b = tstate.opt_states[opt_name], tstate2.opt_states[opt_name]
        for p, q in zip(a.state.values(), b.state.values()):
            assert all(torch.equal(p[key], q[key]) for key in p), opt_name


def test_age_learning_rates_halve_on_their_own_counts():
    """AGE with drop_lr_epoch = steps_per_epoch = 1 and g_updates = 2: E
    updates at steps 0 and 3, G at 1, 2, 4 and 5; each rate halves at each
    of its own updates (igm_tpu's optax count), so at step 3 E's rate is
    halved once, not three times."""
    jax_cls, port_cls, names, kw, spe = CASES["age"]
    nets = mlp()
    tm = port_cls(datamodule=nets["dm"], encoder=nets["encoder"], decoder=nets["decoder"],
                  latent_dim=LATENT, device="cpu", **kw)
    tm.steps_per_epoch = spe
    tstate = tm.init_state(0)
    used = []
    inner = tm.optimizers._apply

    def apply(opt_name, opt, params, grads, count=None, sr_seeds=None):
        inner(opt_name, opt, params, grads, count, sr_seeds)
        used.append((tstate.step, opt_name, float(opt.param_groups[0]["lr"])))

    tm.optimizers._apply = apply
    imgs, labels = batch(nets, 60)
    for _ in range(6):
        tstate, _ = tm.train_step(tstate, (t(imgs), t(labels)))
    e, g = kw["lrE"], kw["lrG"]
    assert used == [(0, "e", e), (1, "g", g), (2, "g", g / 2), (3, "e", e / 2),
                    (4, "g", g / 4), (5, "g", g / 8)]
    schedule = jax_halving_lr(e, 1, 1)
    assert [float(schedule(c)) for c in (0, 1)] == [e, e / 2]
    assert tstate.counts == {"e": 2, "g": 4}
    # a resume reads the counts back from the optimizers' own step counts
    saved = tstate.snapshot()
    tstate.counts = {}
    tstate.load_state_dict(saved)
    assert tstate.counts == {"e": 2, "g": 4}


class _EmulatedGraph:
    """A CPU stand-in for ``core.graphs.StepGraph`` with a capture's
    semantics: the first call runs the callable (the warm-up, whose result
    is the call's); the capture then runs it again on the same state, noting
    the step each train step of the chunk saw (the host's decisions that a
    graph freezes), and the state is put back as it was, since a capture
    computes nothing; a replay runs the callable with each train step made
    to see the step noted at the capture, as a replay re-runs the captured
    branches whatever the host's step."""
    state = None
    model = None

    def __init__(self, fn, generators=(), capture_context=None):
        self.fn, self.capture_context, self.steps = fn, capture_context, None

    def _run(self, inputs, seen=None, forced=None):
        model, inner = self.model, type(self.model).train_step
        calls = iter(forced or ())

        def train_step(state, batch, **kw):
            if forced is not None:
                state.step = next(calls)
            else:
                seen.append(state.step)
            return inner(model, state, batch, **kw)

        model.train_step = train_step
        try:
            return self.fn(*inputs)
        finally:
            del model.train_step

    def __call__(self, *inputs):
        if self.steps is not None:
            return self._run(inputs, forced=self.steps)
        result = self._run(inputs, seen=[])
        saved, step, counts = self.state.snapshot(), self.state.step, dict(self.state.counts)
        self.steps = []
        with self.capture_context():
            self._run(inputs, seen=self.steps)
        self.state.load_state_dict(saved)
        self.state.step, self.state.counts = step, counts
        return result


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["gan", "wgan"])
def test_graphed_chunks_replay_the_branches_of_their_steps(name, k, monkeypatch):
    """train_step_n's graph bookkeeping with the emulated capture: a chunk's
    graph is kept by its first step's phase and captured from the steps the
    warm-up ran, so replays take igm_tpu's branch at every step.  From step
    1 (mid-period), two periods and more at K = 1 and at K = 4 (not a
    multiple of GAN's period 2 or WGAN's 3) equal the eager steps bit for
    bit, with one graph per starting phase that occurs."""
    from igm_tpu_torch.models import base
    jax_cls, port_cls, names, kw, spe = CASES[name]
    nets = mlp(enc_norm="layer")
    monkeypatch.setattr(base, "StepGraph", _EmulatedGraph)
    models = []
    for graphed in (False, True):
        tm = port_cls(datamodule=nets["dm"], netG=nets["decoder"], netD=nets["encoder"],
                      latent_dim=LATENT, device="cpu", **kw)
        tm._graphed = lambda graph: graph
        state = tm.init_state(0)
        _EmulatedGraph.state, _EmulatedGraph.model = state, tm
        imgs, labels = batch(nets, 70)
        state, _ = tm.train_step(state, (t(imgs), t(labels)))         # step 1: mid-period
        period = tm.phase_period
        stack = torch.from_numpy(np.stack([batch(nets, 71 + i)[0] for i in range(k)]))
        chunk = (stack, torch.zeros(k, BATCH, dtype=torch.int32))
        metrics = []
        for _ in range(-(-(2 * period + 1) // k)):
            state, m = tm.train_step_n(state, chunk, graph=graphed)
            metrics.append(m)
        models.append((tm, state, metrics))
    (eager, es, em), (graphed, gs, gm) = models
    assert gs.step == es.step and gs.counts == es.counts
    starts = {(1 + i * k) % graphed.phase_period for i in range(len(gm))}
    assert len(gs.graphs) == len(starts)
    for k_, v in eager.modules.state_dict().items():
        assert torch.equal(v, graphed.modules.state_dict()[k_]), k_
    for a, b in zip(em, gm):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[x], b[x]) or (a[x].isnan() and b[x].isnan()) for x in a)
    assert torch.equal(es.generator.get_state(), gs.generator.get_state())
