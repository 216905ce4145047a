"""Data parallelism on the CPU: two gloo ranks, spawned, held against one
process on the whole global batch, against igm_tpu's one-device step, and
through the training CLI.

One spawn of two ranks (``tests/_torch_dp.py``, which imports no JAX; each
rank reports that ``jax`` stayed out of ``sys.modules``) runs every case:

- (i) each experiment at a tiny width for two steps (one a branch where
  the step alternates): the port's one-process run on the same global
  batch, with the same draws from the same seed, is the reference;
- (ii) the flagship DDPM and the batch-normed MLP VAE from igm_tpu-layout
  weights drawn at random (the BatchNorm statistics off their init),
  with igm_tpu's own draws injected, against ``jax.jit(train_step)`` on
  the whole batch (JAX is imported only in this process);
- (iv) DDIM, and the autoregressive samplers (TAR, MADE, PixelCNN, whose
  Gumbel draws carry the batch on a later axis), over a global batch
  through ``sample_sharded``.

- (iii) the training CLI's rank entry with ``trainer.devices=2 --device
  cpu``: a fit that saves, then one that resumes, against the one-process
  fit of the same epochs, step by step in the losses rank 0 logged.
"""
import struct
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _torch_dp as dp  # noqa: E402
from _torch_parity import (G_FLOOR, GRAD_ATOL_SCALE, GRAD_RTOL, LOSS_RTOL,  # noqa: E402
                           PARAM_ATOL, PARAM_RTOL, _flatten, adam_grads)
from igm_tpu.config import compose as igm_compose  # noqa: E402
from igm_tpu.config.instantiate import instantiate as igm_instantiate  # noqa: E402
from igm_tpu_torch import cli  # noqa: E402
from igm_tpu_torch.interop import flax_mutables_to_torch, flax_to_torch  # noqa: E402
from igm_tpu_torch.parallel.launch import spawn  # noqa: E402

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
WORLD = 2
# a spawn of two ranks that does not end within this fails the test
SPAWN_TIMEOUT_S = 300
# two ranks reorder the sums of the batch (each rank's half, then the
# all-reduce) against one process: metrics a few ulps apart
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6
# FactorVAE's critic normalises 4 latents with the fast variance E[x^2] -
# E[x]^2, where mean^2 / var reaches 1.3e3: summing its statistics over the
# batch's two halves in one process, as two ranks do, moves the D update's
# gradients by 1.5e-4 of the largest (seen here), and its metrics with them
CRITIC_GRAD_SCALE, CRITIC_METRIC_RTOL = 2e-3, 2e-3
DDPM_IGM = ["experiment=ddpm/cifar10", "model.hidden_dim=8", "model.dim_mults=[1]",
            "model.timesteps=20", "model.lr=2e-4", "model.compute_dtype=float32",
            "datamodule.width=8", "datamodule.height=8"]
VAE_IGM = ["experiment=vae/mnist_mlp", "datamodule.width=8", "datamodule.height=8",
           "networks.encoder.hidden_dims=[16,12]", "networks.decoder.hidden_dims=[12,16]",
           "model.latent_dim=4", "model.lr=1e-3"]
SAMPLE_N, SAMPLE_STEPS = 8, 4
# DDIM's first step at T = 16 divides the UNet's eps by sqrt(alphas_cumprod
# [T-1]) = 3.1e-3: the CPU's convolutions at a batch of 4 and of 8 round a
# few ulps apart, 2.0e-4 apart after it (seen in one process alone)
SAMPLE_ATOL = 1e-3
# the autoregressive samplers at 6x6, tiny widths: (overrides, sampler)
AR_SAMPLES = {
    "tar": (dp.CASES["tar_dropout"][0], "sample"),
    "made": (["experiment=made/mnist", "datamodule.width=6", "datamodule.height=6",
              "model.hidden_dim=16", "model.n_layer=2"], "sample_images"),
    "pixelcnn": (["experiment=pixelcnn/mnist", "datamodule.width=6", "datamodule.height=6",
                  "model.hidden_dim=4"], "sample_images"),
}


def _igm_model(overrides):
    cfg = igm_compose(CONFIGS, [*overrides, "print_config=False"])
    model = igm_instantiate(cfg.model, datamodule=cfg.datamodule)
    model.steps_per_epoch = 100
    return model


def _igm_state(jm, seed: int):
    """igm_tpu's train state without compiling its init: the structure from
    ``jax.eval_shape(init_state)``, the parameters drawn here (0.1 N(0, 1),
    norm scales 1 + 0.05 N(0, 1)), BatchNorm statistics off their init
    (means 0.1 N(0, 1), variances U(0.5, 2)), fresh optimizer states."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init_state, jax.random.PRNGKey(0))

    def draw(path, s):
        name = path[-1].key
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, s.shape), jnp.float32)
        base = 1.0 if name == "scale" else 0.0
        return jnp.asarray(base + (0.05 if name == "scale" else 0.1)
                           * rng.normal(size=s.shape), jnp.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes.params)
    return shapes.replace(step=jnp.zeros((), jnp.int32), params=params,
                          mutables=jax.tree_util.tree_map_with_path(draw, shapes.mutables),
                          opt_states=jm.optimizers.init(params),
                          rng=jax.random.PRNGKey(seed))


def _igm_ddpm():
    """igm_tpu's DDPM step on 8 images: the port's job and what it must give."""
    jm = _igm_model(DDPM_IGM)
    state = _igm_state(jm, 1)
    batch = dp.make_batch(dp.build(DDPM_IGM), 8, 5)
    keys = jax.random.split(state.rng, 3)[1:]          # next_rng(2), then randint, normal
    draws = {"t": np.array(jax.random.randint(keys[0], (8,), 0, 20), np.int64),
             "noise": np.array(jax.random.normal(keys[1], batch[0].shape), np.float32)}
    new_state, metrics = jax.jit(jm.train_step)(state, tuple(map(jnp.asarray, batch)))
    weights = {f"denoise.{k}": v for k, v in flax_to_torch(
        _flatten(state.params["denoise"])).items()}
    want = {"loss": ("train_loss/loss", float(metrics["train_loss/loss"])),
            "grads": {"opt": {f"denoise.{k}": v.numpy() for k, v in flax_to_torch(_flatten(
                adam_grads(new_state, "opt", "denoise", float(jm.hparams.b1)))).items()}},
            "params": {f"denoise.{k}": v.numpy() for k, v in flax_to_torch(
                _flatten(new_state.params["denoise"])).items()},
            "buffers": {}}
    return ("ddpm_igm", DDPM_IGM, batch, 1, weights, draws), want


def _igm_vae():
    """igm_tpu's batch-normed MLP VAE step on 8 images (the statistics moved
    off their init): the port's job and what it must give."""
    jm = _igm_model(VAE_IGM)
    state = _igm_state(jm, 2)
    batch = dp.make_batch(dp.build(VAE_IGM), 8, 6)
    _, rng = state.next_rng()
    draws = {"eps": np.array(jax.random.normal(rng, (8, 4)), np.float32)}
    new_state, metrics = jax.jit(jm.train_step)(state, tuple(map(jnp.asarray, batch)))
    weights = {**flax_to_torch(_flatten(state.params)),
               **flax_mutables_to_torch(_flatten(state.mutables))}
    grads = {}
    for m in ("encoder", "decoder"):
        grads.update({f"{m}.{k}": v.numpy() for k, v in flax_to_torch(_flatten(
            adam_grads(new_state, "opt", m, float(jm.hparams.b1)))).items()})
    want = {"loss": ("train_log/elbo", float(metrics["train_log/elbo"])),
            "grads": {"opt": grads},
            "params": {k: v.numpy() for k, v in flax_to_torch(
                _flatten(new_state.params)).items()},
            "buffers": {k: v.numpy() for k, v in flax_mutables_to_torch(
                _flatten(new_state.mutables)).items()}}
    return ("vae_igm", VAE_IGM, batch, 1, weights, draws), want


FIT = ["experiment=ddpm/cifar10", "model.hidden_dim=8", "model.dim_mults=[1,2]",
       "model.timesteps=8", "datamodule.width=8", "datamodule.height=8",
       "datamodule.batch_size=8", "trainer.limit_train_batches=2", "trainer.limit_val_batches=0",
       "trainer.steps_per_execution=1", "trainer.log_every_n_steps=1", "model.lr=1e-4",
       "logger=tensorboard", "callbacks=null", "print_config=False"]
FIT_LR = 1e-4
FIT_LOSS = "train_loss/loss"
# the loss rank 0 logs at each step, the mean of the ranks' on the global
# batch, against one process's: the sums over the batch reordered, and
# from the second step on parameters that may differ by the 2 lr of a
# rounding-decided gradient sign where the gradient is near 0 (TensorBoard
# keeps float32)
FIT_LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case run once by two spawned gloo ranks, and the CLI fits on
    them: (records by case and rank, the jobs, igm_tpu's results, the
    fits' run directory).  igm_tpu's steps are compiled here
    while the ranks run the other cases; the ranks take their jobs from a
    file written after."""
    out = tmp_path_factory.mktemp("dp")
    jobs = {name: (name, overrides, dp.make_batch(dp.build(overrides), n, 3), steps, None, None)
            for name, (overrides, n, steps) in dp.CASES.items()}
    samples = [("sample", dp.CASES["ddpm"][0], SAMPLE_N, "ddim_sample",
                {"steps": SAMPLE_STEPS})]
    samples += [(f"sample_{name}", overrides, SAMPLE_N, sampler, {})
                for name, (overrides, sampler) in AR_SAMPLES.items()]
    run = out / "fit"
    fit = [*FIT, f"datamodule.data_dir={out / 'data'}", "trainer.devices=2"]
    fits = [[*fit, "trainer.max_epochs=1", f"hydra.run.dir={run}"],
            [*fit, "trainer.max_epochs=2", f"hydra.run.dir={out / 'fit_resumed'}",
             f"trainer.resume={run / 'checkpoints'}"]]
    later = out / "igm_jobs.pt"
    failed = []

    def ranks_():
        try:
            spawn(dp.rank_main, WORLD, torch.device("cpu"),
                  (list(jobs.values()), samples, fits, str(out), str(later)),
                  timeout=SPAWN_TIMEOUT_S)
        except BaseException as exc:     # raised in the test's thread below
            failed.append(exc)

    spawner = threading.Thread(target=ranks_)
    spawner.start()
    igm, igm_jobs = {}, []
    try:
        for make in (_igm_ddpm, _igm_vae):
            job, want = make()
            igm_jobs.append(job)
            igm[job[0]] = want
    finally:                  # the ranks wait for the file: written even on a failure
        torch.save(igm_jobs, out / "igm_jobs.tmp")
        (out / "igm_jobs.tmp").replace(later)
        spawner.join()
    if failed:
        raise failed[0]
    jobs.update((job[0], job) for job in igm_jobs)
    records = {name: [torch.load(out / f"{name}.rank{r}.pt") for r in range(WORLD)]
               for name in [*jobs, *(s[0] for s in samples)]}
    return records, jobs, igm, run


def _same_on_every_rank(recs):
    """The ranks end in the same state bit for bit and report the same
    (averaged) metrics; none imported JAX."""
    assert not any(r["jax"] for r in recs)
    first = recs[0]
    for r in recs[1:]:
        np.testing.assert_equal(r["metrics"], first["metrics"])
        for k, v in first["state"].items():
            assert torch.equal(r["state"][k], v), k


def _grad_scale(opt_name: str, critic: bool) -> float:
    """The gradients' tolerance, over their largest entry, of an update."""
    return CRITIC_GRAD_SCALE if critic and opt_name == "d" else GRAD_ATOL_SCALE


def _check_state(got: dict, want: dict, updates, steps: int, buffers_atol: float,
                 critic: bool = False):
    """Parameters where every update's gradient has a certain sign (|g|
    above G_FLOOR and twice the gradients' tolerance) to Adam's rounding;
    elsewhere within the 2 lr a step that a sign decided by rounding can
    move them; buffers (BatchNorm statistics, the EMA codebook) within
    ``buffers_atol``."""
    grads, lrs = {}, {}
    for opt_name, names, lr, gs in updates:
        scale = max(float(g.abs().max()) for g in gs)
        floor = max(G_FLOOR, 2 * _grad_scale(opt_name, critic) * scale)
        for k, g in zip(names, gs):
            certain = g.abs().numpy() > floor
            grads[k] = certain & grads.get(k, certain)
            lrs[k] = max(lr, lrs.get(k, 0.0))
    for k, w in want.items():
        g = got[k].float().numpy()
        w = np.asarray(w, np.float32)
        if k in grads:
            np.testing.assert_allclose(g[grads[k]], w[grads[k]], atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=k)
            assert np.all(np.abs(g - w) <= 2 * steps * lrs[k] * (1 + 1e-3) + PARAM_ATOL), k
        else:
            np.testing.assert_allclose(g, w, atol=buffers_atol, rtol=1e-4, err_msg=k)


def _check_updates(got, want, critic: bool = False):
    assert [(u[0], u[1]) for u in got] == [(u[0], u[1]) for u in want]
    for (name, names, _, gs), (_, _, _, ws) in zip(got, want):
        scale = max(float(w.abs().max()) for w in ws)
        atol = _grad_scale(name, critic) * scale
        for k, g, w in zip(names, gs, ws):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol, rtol=GRAD_RTOL,
                                       err_msg=f"{name}: {k}")


@pytest.mark.parametrize("case", list(dp.CASES))
def test_two_ranks_match_one_process(ranks, case):
    """Every step's metrics, every update's gradients after the all-reduce
    and the state after the steps, two ranks of 4 rows (FactorVAE: 2 of
    each half) against one process on 8, from the same seed: the draws
    are the same global draws, the batch statistics the global batch's."""
    records, jobs, _, _ = ranks
    recs = records[case]
    _same_on_every_rank(recs)
    name, overrides, batch, steps, _, _ = jobs[case]
    ref = dp.run(dp.build(overrides), batch, steps)
    got = recs[0]
    assert got["step"] == ref["step"] == steps
    critic = case == "factor_vae"
    for m, w in zip(got["metrics"], ref["metrics"]):
        assert set(m) == set(w)
        for k, v in w.items():
            rtol = CRITIC_METRIC_RTOL if critic else METRIC_RTOL
            np.testing.assert_allclose(m[k], v, rtol=rtol, atol=METRIC_ATOL, err_msg=k)
    _check_updates(got["updates"], ref["updates"], critic)
    lr = max(u[2] for u in ref["updates"])
    _check_state(got["state"], ref["state"], ref["updates"], steps,
                 buffers_atol=1e-5 + 2 * steps * lr, critic=critic)


@pytest.mark.parametrize("case", list(dp.CASES))
def test_collective_bytes_are_counted(ranks, case):
    """The tracing registry's ``mesh.collectives`` and
    ``mesh.collective_bytes`` over a rank's steps equal the collectives
    ``torch.distributed`` was called for and the bytes of the tensors they
    reduced (or gathered); the gradients' all-reduce is among them.  One
    process issues none."""
    records, jobs, _, _ = ranks
    _, overrides, batch, steps, _, _ = jobs[case]
    for rec in records[case]:
        c = rec["collectives"]
        assert c["counted"] == c["issued"] > 0
        assert c["counted_bytes"] == c["issued_bytes"]
        grads = sum(g.numel() * g.element_size() for u in rec["updates"] for g in u[3])
        assert c["counted_bytes"] >= grads > 0
    one = dp.run(dp.build(overrides), batch, 1)["collectives"]
    assert one == {"counted": 0, "counted_bytes": 0, "issued": 0, "issued_bytes": 0}


@pytest.mark.parametrize("case", ["ddpm_igm", "vae_igm"])
def test_two_ranks_match_igm_tpu(ranks, case):
    """The flagship DDPM and the batch-normed VAE: igm_tpu's one-device
    step on the global batch against the port's two ranks, from igm_tpu's
    weights and draws: the loss, the gradients, the parameters after Adam
    (tests/_torch_parity.py's tolerances) and the BatchNorm buffers."""
    records, jobs, igm, _ = ranks
    recs = records[case]
    _same_on_every_rank(recs)
    want = igm[case]
    got = recs[0]
    key, loss = want["loss"]
    np.testing.assert_allclose(got["metrics"][0][key], loss, rtol=LOSS_RTOL)
    (name, names, lr, gs), = got["updates"]
    wg = want["grads"][name]
    scale = max(np.abs(w).max() for w in wg.values())
    for k, g in zip(names, gs):
        np.testing.assert_allclose(g.numpy(), wg[k], atol=GRAD_ATOL_SCALE * scale,
                                   rtol=GRAD_RTOL, err_msg=k)
    floor = max(G_FLOOR, 2 * GRAD_ATOL_SCALE * scale)
    before = jobs[case][4]
    for k, w in want["params"].items():
        p = got["state"][k].numpy()
        big = np.abs(wg[k]) > floor
        np.testing.assert_allclose(p[big], w[big], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=k)
        assert np.all(np.abs(p - before[k].numpy()) <= lr * (1 + 1e-3)), k
    for k, w in want["buffers"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30), err_msg=k)


def test_sample_sharded_matches_one_process(ranks):
    """DDIM over 8 images from generator seed 0, two ranks of 4 through
    ``sample_sharded``, all-gathered: bit for bit the one-process sampler
    run on each half of the same global x_T (the draws and the gather are
    exact), and within SAMPLE_ATOL the one-process sampler on all 8."""
    records, _, _, _ = ranks
    recs = records["sample"]
    assert not any(r["jax"] for r in recs)
    assert torch.equal(recs[0]["imgs"], recs[1]["imgs"])
    model = dp.build(dp.CASES["ddpm"][0])
    x_t = torch.randn((SAMPLE_N, model.height, model.width, model.channels),
                      generator=torch.Generator().manual_seed(0))
    half = SAMPLE_N // WORLD
    halves = torch.cat([model.ddim_sample(half, steps=SAMPLE_STEPS,
                                          x_T=x_t[r * half:(r + 1) * half])
                        for r in range(WORLD)])
    assert torch.equal(recs[0]["imgs"], halves)
    whole = model.ddim_sample(SAMPLE_N, steps=SAMPLE_STEPS,
                              generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(recs[0]["imgs"].numpy(), whole.numpy(), atol=SAMPLE_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(AR_SAMPLES))
def test_sample_sharded_autoregressive_matches_one_process(ranks, name):
    """TAR, MADE and PixelCNN over 8 images from generator seed 0, two
    ranks of 4 through ``sample_sharded``: the images the one-process
    sampler draws on all 8, exactly (each rank draws the global batch's
    Gumbel noise, whose batch axis is not the first, and keeps its rows;
    the draws decide tokens by an argmax, not a sum)."""
    records, _, _, _ = ranks
    recs = records[f"sample_{name}"]
    assert not any(r["jax"] for r in recs)
    assert torch.equal(recs[0]["imgs"], recs[1]["imgs"])
    overrides, sampler = AR_SAMPLES[name]
    whole = getattr(dp.build(overrides), sampler)(SAMPLE_N,
                                                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(recs[0]["imgs"], whole)
    half = SAMPLE_N // WORLD
    assert not torch.equal(whole[:half], whole[half:])


def _logged(tag: str, *run_dirs: Path) -> dict:
    """The scalars ``tag`` logged to TensorBoard under ``run_dirs``, by
    step: each event file's records (length, its CRC, an ``Event``, its
    CRC) read in order."""
    from tensorboardX.proto.event_pb2 import Event
    values = {}
    for run_dir in run_dirs:
        for path in sorted(run_dir.rglob("events.out.tfevents.*")):
            data, pos = path.read_bytes(), 0
            while pos < len(data):
                (n,) = struct.unpack_from("<Q", data, pos)
                event = Event.FromString(data[pos + 12:pos + 12 + n])
                pos += 12 + n + 4
                values.update((event.step, v.simple_value)
                              for v in event.summary.value if v.tag == tag)
    return values


def test_cli_two_ranks_save_resume_match_one_process(ranks, tmp_path, monkeypatch):
    """``trainer.devices=2 --device cpu``: the two ranks ran the training
    CLI's rank entry (what ``python -m igm_tpu_torch.train`` spawns) for
    an epoch of 2 steps on 8-image global batches, which saved, then
    again resuming from it for a second epoch (in a run directory of its
    own, so that its TensorBoard files stand beside the first's).  The last checkpoint holds
    what one process training both epochs holds: the step and the Adam
    counts exactly, the parameters within the 2 lr a step that a gradient
    sign decided by rounding moves.  The loss rank 0 logged at each of the
    4 steps is one process's on the same global batch, within
    FIT_LOSS_RTOL: ranks that trained on other rows than their own (the
    same rows twice, say) log another loss."""
    *_, run = ranks
    monkeypatch.chdir(tmp_path)
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step_2.pt",
                                                                      "step_4.pt"]
    one = tmp_path / "one"
    cli.train_main([*FIT, f"datamodule.data_dir={run.parent / 'data'}", "trainer.max_epochs=2",
                    f"hydra.run.dir={one}", "--device", "cpu"])
    got = torch.load(run / "checkpoints" / "step_4.pt", weights_only=False)
    want = torch.load(one / "checkpoints" / "step_4.pt", weights_only=False)
    assert got["step"] == want["step"] == 4
    assert int(got["opt_states"]["opt"]["state"][0]["step"]) == 4
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(), rtol=0,
                                   atol=2 * 4 * FIT_LR * (1 + 1e-3) + PARAM_ATOL, err_msg=k)
    losses = _logged(FIT_LOSS, run, run.parent / "fit_resumed")
    want_losses = _logged(FIT_LOSS, one)
    assert sorted(losses) == sorted(want_losses) == [0, 1, 2, 3]
    for step, w in want_losses.items():
        np.testing.assert_allclose(losses[step], w, rtol=FIT_LOSS_RTOL, err_msg=str(step))
