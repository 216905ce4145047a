"""Pipeline parallelism of the DiT (``igm_tpu_torch/parallel/pipeline.py``)
against the sequential stack and against igm_tpu, and the collectives of
sequence parallelism: the counterpart of ``tests/test_pipeline.py``.

One spawn of four gloo ranks (``tests/_torch_pp.py``, which imports no
JAX; each rank reports that ``jax`` stayed out of ``sys.modules``) runs:

- the pipelined DiT on the ``(data 1, stage 4)`` and ``(2, 2)`` meshes at
  1, 2 and 4 microbatches (and 3, which do not divide a rank's 4 rows: the
  sequential stack), once with ``remat``: the output and the gradients of
  mean(out ** 2), summed over ``stage`` and averaged over ``data``;
- two DDPM train steps of the pipelined DiT on (1, 4) and (2, 2) from
  perturbed weights (``_torch_mp.run``: metrics, reduced gradients whole,
  the whole state after, each rank's state bytes), once with ``remat``;
- the tiny DiT's step on the (2, 2) tensor mesh with and without the
  sequence split, counting the model group's collectives;
- a one-process checkpoint restored on the (1, 4) pipeline mesh, and
  DDIM through ``sample_sharded`` on the (2, 2) one;
- the training CLI with ``+trainer.mesh.mode=pipeline
  +trainer.mesh.stage=4 +trainer.mesh.microbatches=2``, which validates
  and saves;
- then, from igm_tpu-layout weights with igm_tpu's draws, the pipelined
  DDPM step on (2, 2) against ``jax.jit(train_step)`` of igm_tpu's
  sequential scan, compiled here meanwhile.
"""
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _torch_dp as dp  # noqa: E402
import _torch_mp as mp  # noqa: E402
import _torch_pp as pp  # noqa: E402
from _torch_parity import G_FLOOR, GRAD_ATOL_SCALE, PARAM_ATOL, _flatten  # noqa: E402
from igm_tpu.networks.dit import DiT as JaxDiT  # noqa: E402
from igm_tpu_torch import cli  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from igm_tpu_torch.networks.dit import DiT  # noqa: E402
from igm_tpu_torch.parallel.launch import spawn  # noqa: E402
from igm_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from igm_tpu_torch.parallel.pipeline import (STAGE_AXIS, gpipe_apply,  # noqa: E402
                                             pipeline_state_sharding)
from test_torch_parallel_dp import _check_state, _check_updates  # noqa: E402
from test_torch_parallel_model import (METRIC_ATOL, METRIC_RTOL, SAMPLE_ATOL,  # noqa: E402
                                       _flat_opt, _igm_job, _replicas_agree)

torch.set_num_threads(1)

WORLD = 4
SPAWN_TIMEOUT_S = 300
CPU = torch.device("cpu")
# igm_tpu's own tolerances (tests/test_pipeline.py)
SCAN_TOL = 1e-6
FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
STEP_LOSS_RTOL = 1e-5
STEP_PARAM_RTOL, STEP_PARAM_ATOL = 1e-4, 1e-6
FIT_LR = 1e-4
FIT = [*pp.PIPE_DIT_EMA, "datamodule.batch_size=8", "trainer.limit_train_batches=2",
       "trainer.steps_per_execution=1", f"model.lr={FIT_LR}", "logger=null",
       "print_config=False"]
PIPE_FIT = ["trainer.devices=4", "+trainer.mesh.mode=pipeline", "+trainer.mesh.stage=4",
            "+trainer.mesh.microbatches=2", "trainer.limit_val_batches=1",
            "+model.sample_batch=4", "trainer.max_epochs=1"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case run once by four spawned gloo ranks, and the CLI fit:
    (records by case and rank, the jobs, igm_tpu's result, the fit's run
    directory)."""
    out = tmp_path_factory.mktemp("pp")
    jobs = {name: (name, overrides, dp.make_batch(dp.build(overrides), n, 3), steps, kw,
                   mp.perturbed(dp.build(overrides)), None)
            for name, (overrides, n, steps, kw) in pp.STEP_CASES.items()}
    run = out / "fit"
    fits = [[*FIT, *PIPE_FIT, f"datamodule.data_dir={out / 'data'}", f"hydra.run.dir={run}"]]
    later = out / "igm_jobs.pt"
    failed = []

    def ranks_():
        try:
            spawn(pp.rank_main, WORLD, CPU, (list(jobs.values()), fits, str(out), str(later)),
                  timeout=SPAWN_TIMEOUT_S)
        except BaseException as exc:     # raised in the test's thread below
            failed.append(exc)

    spawner = threading.Thread(target=ranks_)
    spawner.start()
    igm_jobs, igm = [], None
    try:
        job, igm = _igm_job("pipe_igm", pp.PIPE_DIT, dict(data=2, stage=2, microbatches=2), 1)
        igm_jobs.append(job)
    finally:                  # the ranks wait for the file: written even on a failure
        torch.save(igm_jobs, out / "igm_jobs.tmp")
        (out / "igm_jobs.tmp").replace(later)
        spawner.join()
    if failed:
        raise failed[0]
    jobs.update((job[0], job) for job in igm_jobs)
    names = [*jobs, *(c[0] for c in pp.DIT_CASES), "signature", "resume_on_pipeline",
             "sample_pipeline"]
    records = {name: [torch.load(out / f"{name}.rank{r}.pt", weights_only=False)
                      for r in range(WORLD)] for name in names}
    return records, jobs, igm, run


def test_scan_matches_unroll_and_igm_tpu():
    """The scan layout is the unrolled one's computation (the same modules,
    bit for bit), and the port's scan DiT equals igm_tpu's scan ``apply``
    on its stacked weights (perturbed off adaLN-Zero)."""
    x, t = pp.dit_inputs(8)
    jnet = JaxDiT(dim=pp.DIM, depth=pp.DEPTH, heads=pp.HEADS, patch=pp.PATCH, channels=3,
                  block_mode="scan")
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.normal(size=p.shape).astype(np.float32),
        jnet.init(jax.random.PRNGKey(0), jnp.asarray(x.numpy()),
                  jnp.asarray(t.numpy()))["params"])
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x.numpy()),
                                 jnp.asarray(t.numpy())))
    weights = flax_to_torch(_flatten(params))
    outs = []
    for mode in ("scan", "unroll"):
        net = DiT(dim=pp.DIM, depth=pp.DEPTH, heads=pp.HEADS, patch=pp.PATCH, channels=3,
                  block_mode=mode)
        net.load_state_dict(weights, strict=True)
        with torch.no_grad():
            outs.append(net(x, t))
    assert torch.equal(outs[0], outs[1])
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(outs[0].numpy(), want, rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("case", [c[0] for c in pp.DIT_CASES])
def test_pipeline_matches_scan(ranks, case):
    """The pipelined DiT on four ranks against the sequential scan in one
    process on the whole batch (tests/test_pipeline.py's tolerances): the
    output, and the gradients summed over the stages (each rank's own
    blocks; the replicated leaves' parts) and averaged over ``data``.
    Every rank holds the same output and gradients."""
    records, *_ = ranks
    recs = records[case]
    assert not any(r["jax"] for r in recs)
    for r in recs[1:]:
        assert torch.equal(r["out"], recs[0]["out"]) and torch.equal(r["grads"], recs[0]["grads"])
    _, _, _, _, batch = next(c for c in pp.DIT_CASES if c[0] == case)
    x, t = pp.dit_inputs(batch)
    out, grads = pp.dit_loss_grads(pp.seeded_dit(remat="remat" in case), x, t)
    np.testing.assert_allclose(recs[0]["out"].numpy(), out.numpy(), rtol=FWD_TOL, atol=FWD_TOL)
    flat = torch.cat([g.reshape(-1) for g in grads])
    assert float(flat.abs().max()) > 1e-3
    np.testing.assert_allclose(recs[0]["grads"].numpy(), flat.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("case", list(pp.STEP_CASES))
def test_pipelined_ddpm_steps_match_one_process(ranks, case):
    """Two DDPM steps of the pipelined DiT against the port's one process
    on the whole global batch from the same perturbed weights: every
    metric, every update's reduced gradients (a stage's blocks broadcast
    from it) and the parameters after (tests/test_torch_parallel_model.py's
    tolerances); every rank ends in the same whole state."""
    records, jobs, _, _ = ranks
    recs = records[case]
    _, overrides, batch, steps, kw, weights, _ = jobs[case]
    _replicas_agree(recs, {})
    one = mp.run(dp.build(overrides), batch, steps, weights=weights)
    ref = dp.run(dp.build(overrides), batch, steps, weights=weights)
    got = recs[0]
    assert got["step"] == one["step"] == steps
    assert got["sharded"] and all("DiTBlock" in k for k in got["sharded"])
    for m, w in zip(got["metrics"], one["metrics"]):
        assert set(m) == set(w)
        for k, v in w.items():
            np.testing.assert_allclose(m[k], v, rtol=METRIC_RTOL, atol=METRIC_ATOL, err_msg=k)
    _check_updates(got["updates"], ref["updates"])
    lr = max(u[2] for u in ref["updates"])
    _check_state(got["params"], ref["state"], ref["updates"], steps, buffers_atol=1e-5 + 2 * lr)
    want_opt, got_opt = _flat_opt(one["opt_states"]), _flat_opt(got["opt_states"])
    assert set(want_opt) == set(got_opt)


def test_pipelined_step_matches_igm_tpu(ranks):
    """The pipelined DDPM step on (2, 2) at 2 microbatches from igm_tpu's
    stacked weights and draws against igm_tpu's sequential scan
    ``train_step`` (tests/test_pipeline.py's check): the loss at rtol
    1e-5, the parameters after Adam where the gradient's sign is certain,
    every parameter within the lr of its start."""
    records, jobs, want, _ = ranks
    recs = records["pipe_igm"]
    _replicas_agree(recs, {})
    got = recs[0]
    np.testing.assert_allclose(got["metrics"][0]["train_loss/loss"], want["loss"],
                               rtol=STEP_LOSS_RTOL)
    scale = max(np.abs(w).max() for w in want["grads"].values())
    floor = max(G_FLOOR, 2 * GRAD_ATOL_SCALE * scale)
    before = jobs["pipe_igm"][5]
    lr = float(dp.build(pp.PIPE_DIT).hparams.lr)
    assert {k for k in want["params"] if "DiTBlock_3" in k}       # the stacked blocks, split
    for k, w in want["params"].items():
        p = got["params"][k].numpy()
        big = np.abs(want["grads"][k]) > floor
        np.testing.assert_allclose(p[big], w[big], atol=STEP_PARAM_ATOL, rtol=STEP_PARAM_RTOL,
                                   err_msg=k)
        assert np.all(np.abs(p - before[k].numpy()) <= lr * (1 + 1e-3) + STEP_PARAM_ATOL), k


def _stage_of(key: str, per: int):
    """The stage that holds ``key`` (None: replicated)."""
    for part in key.split("."):
        if part.startswith("DiTBlock_"):
            return int(part.split("_")[1]) // per
    return None


@pytest.mark.parametrize("case", ["ddpm_1x4_m2", "ddpm_2x2_m4"])
def test_stage_state_bytes_are_its_blocks(ranks, case):
    """Each rank keeps, of the train state (parameters, Adam's moments, the
    EMA shadow), its stage's blocks and the replicated leaves, by exact
    count, the step counters beside; a stage of (1, 4) under a third of one
    process's."""
    records, jobs, _, _ = ranks
    kw = jobs[case][4]
    stages = kw["stage"]
    model = dp.build(jobs[case][1])
    state = model.init_state(0)
    per_stage = pp.DEPTH // stages
    names = {id(p): k for k, p in model.modules.named_parameters()}
    nbytes = lambda t: t.numel() * t.element_size()        # noqa: E731
    for r, rec in enumerate(records[case]):
        s = r % stages

        def kept(key):
            return _stage_of(key, per_stage) in (None, s)
        want = sum(nbytes(t) for k, t in model.modules.state_dict().items() if kept(k))
        opt = state.opt_states["opt"]
        for p in opt.param_groups[0]["params"]:
            want += sum(nbytes(t) for t in opt.state[p].values()
                        if t.ndim == 0 or kept(names[id(p)]))
        want += sum(nbytes(t) for k, t in state.opt_states["ema"].items()
                    if kept(f"denoise.{k}"))
        assert rec["bytes"] == want, (r, rec["bytes"], want)
    if stages == 4:
        assert max(r["bytes"] for r in records[case]) < mp.state_bytes(state) / 3


def test_pipeline_state_sharding_splits_the_blocks():
    """``pipeline_state_sharding``: every leaf of a pipelined block (and so
    its moments and EMA shadow) over ``stage`` on its block's stage, every
    other replicated; a state dict's whole tensors slice to a stage's."""
    mesh = Mesh(1, 0, CPU, axes=(("data", 1), ("stage", 4)),
                coords=(("data", 0), ("stage", 2)), mode="pipeline")
    model = dp.build(pp.PIPE_DIT)
    model.enable_pipeline(mesh, 2)
    specs = pipeline_state_sharding(model, mesh)
    staged = [k for k, s in specs.items() if s == (STAGE_AXIS,)]
    assert staged and all("DiTBlock" in k for k in staged)
    assert all(s == () for k, s in specs.items() if "DiTBlock" not in k)
    assert len(staged) == sum(1 for k in specs if "DiTBlock" in k)
    blocks = model.modules["denoise"].blocks
    assert [b.pipe_stage for b in blocks] == [0, 1, 2, 3]


def test_gpipe_raises_on_bad_shapes():
    """igm_tpu's errors: a depth the stages do not divide, a batch that
    ``data x microbatches`` does not divide."""
    mesh = Mesh(1, 0, CPU, axes=(("data", 1), ("stage", 4)),
                coords=(("data", 0), ("stage", 0)), mode="pipeline")
    with pytest.raises(ValueError, match="divisible"):
        gpipe_apply(lambda b, x, c: x, [nn.Identity()] * 3, torch.zeros(4, 2, 2),
                    torch.zeros(4, 2), mesh, 1)
    with pytest.raises(ValueError, match="batch"):
        gpipe_apply(lambda b, x, c: x, [nn.Identity()] * 4, torch.zeros(3, 2, 2),
                    torch.zeros(3, 2), mesh, 2)


def test_one_process_checkpoint_resumes_on_the_pipeline_mesh(ranks):
    """A one-process checkpoint restored on the (1, 4) pipeline mesh: the
    whole state every rank gathers back (each block's leaves broadcast from
    its stage) is the checkpoint's, bit for bit, while each rank keeps
    less than a third of it."""
    from igm_tpu_torch.core.checkpoint import CheckpointManager
    records, _, _, run = ranks
    saved = CheckpointManager(str(run.parent / "one_process_ckpt")).restore_raw()
    recs = records["resume_on_pipeline"]
    whole = sum(t.numel() * t.element_size() for t in saved["params"].values())
    for rec in recs:
        assert rec["step"] == saved["step"] == 1
        for k, v in saved["params"].items():
            assert torch.equal(rec["params"][k], v), k
        want, got = _flat_opt(saved["opt_states"]), _flat_opt(rec["opt_states"])
        assert set(want) == set(got)
        for k, v in want.items():
            assert torch.equal(got[k].cpu(), v), k
        assert rec["bytes"] < 3 * whole          # parameters, two moments, the EMA: < 4x


def test_sample_sharded_on_the_pipeline_mesh(ranks):
    """DDIM over 8 images from generator seed 0 on the (2, 2) pipeline
    mesh's split state, through sample_sharded (the stages' blocks gathered
    on every rank, each data rank sampling its rows): one process's images
    from the same init, within tests/test_torch_parallel_model.py's
    SAMPLE_ATOL; every rank holds the same images."""
    records, *_ = ranks
    recs = records["sample_pipeline"]
    assert not any(r["jax"] for r in recs)
    assert all(torch.equal(r["imgs"], recs[0]["imgs"]) for r in recs)
    model = dp.build(pp.PIPE_DIT)
    model.init_state(0)
    whole = model.ddim_sample(pp.SAMPLE_N, generator=torch.Generator().manual_seed(0))
    assert max(r["bytes"] for r in recs) < mp.state_bytes(model.state)
    np.testing.assert_allclose(recs[0]["imgs"].numpy(), whole.numpy(), atol=SAMPLE_ATOL,
                               rtol=0)


def test_cli_pipeline_fit_resumes_in_one_process(ranks, tmp_path, monkeypatch):
    """``trainer.devices=4 +trainer.mesh.mode=pipeline +trainer.mesh.stage=4
    +trainer.mesh.microbatches=2``: the four ranks' CLI fit (an epoch of 2
    steps, validation with its sample grid) saved the whole state in the
    one-process format; one process resumes it for a second epoch and holds
    what one process training both epochs holds: the step and the Adam
    counts exactly, the parameters within the 2 lr a step that a gradient
    sign decided by rounding moves."""
    *_, run = ranks
    monkeypatch.chdir(tmp_path)
    data = f"datamodule.data_dir={run.parent / 'data'}"
    ckpt = run / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_2.pt"]
    assert list((run / "results").glob("*.jpg"))           # rank 0's validation grid
    resumed, one = tmp_path / "resumed", tmp_path / "one"
    more = ["trainer.max_epochs=2", "trainer.limit_val_batches=0", "callbacks=null"]
    cli.train_main([*FIT, data, *more, f"hydra.run.dir={resumed}", f"trainer.resume={ckpt}",
                    "--device", "cpu"])
    cli.train_main([*FIT, data, *more, f"hydra.run.dir={one}", "--device", "cpu"])
    first = torch.load(ckpt / "step_2.pt", weights_only=False)
    got = torch.load(ckpt / "step_4.pt", weights_only=False)
    want = torch.load(one / "checkpoints" / "step_4.pt", weights_only=False)
    assert {k: v.shape for k, v in first["params"].items()} == \
        {k: v.shape for k, v in want["params"].items()}
    assert got["step"] == want["step"] == 4
    assert int(got["opt_states"]["opt"]["state"][0]["step"]) == 4
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(), rtol=0,
                                   atol=2 * 4 * FIT_LR * (1 + 1e-3) + PARAM_ATOL, err_msg=k)


def test_sequence_parallel_replaces_all_reduces(ranks):
    """The counterpart of tests/test_parallel.py's
    test_sequence_parallel_matches_and_scatters: one step of the tiny DiT
    on the (2, 2) tensor mesh, the model group's collectives.  Tensor
    parallelism alone all-reduces the rank's (B, N, d) activations (after
    proj and Dense_1; their gradients before qkv and Dense_0); with the
    sequence split none of that size is all-reduced: reduce-scatters and
    all-gathers (four a block each way) take their place."""
    records, *_ = ranks
    rec = records["signature"][0]
    tokens = rec["tokens"]
    count = {name: {kind: sum(1 for k, _ in rec[name] if k == kind)
                    for kind in ("all_reduce", "all_gather", "reduce_scatter")}
             for name in ("tensor", "sequence")}
    big = {name: sum(1 for k, n in rec[name] if k == "all_reduce" and n == tokens)
           for name in ("tensor", "sequence")}
    depth = 2
    assert big["tensor"] >= 4 * depth and big["sequence"] == 0, (big, count)
    assert count["tensor"]["reduce_scatter"] == 0
    assert count["sequence"]["reduce_scatter"] >= 4 * depth
    assert count["sequence"]["all_gather"] >= count["tensor"]["all_gather"] + 4 * depth
    assert count["sequence"]["all_reduce"] < count["tensor"]["all_reduce"], count


@pytest.mark.slow
def test_eight_ranks_pipeline_matches_one_process(tmp_path):
    """tests/test_pipeline.py's (data 2, stage 4) mesh: eight ranks, two
    pipelined DDPM steps at 2 microbatches against one process on the
    global batch."""
    overrides = pp.PIPE_DIT
    batch = dp.make_batch(dp.build(overrides), 8, 3)
    weights = mp.perturbed(dp.build(overrides))
    spawn(pp.eight_rank_main, 8, CPU, (str(tmp_path), batch, weights), timeout=SPAWN_TIMEOUT_S)
    recs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(8)]
    _replicas_agree(recs, {})
    ref = dp.run(dp.build(overrides), batch, 2, weights=weights)
    one = mp.run(dp.build(overrides), batch, 2, weights=weights)
    for m, w in zip(recs[0]["metrics"], one["metrics"]):
        for k, v in w.items():
            np.testing.assert_allclose(m[k], v, rtol=METRIC_RTOL, atol=METRIC_ATOL, err_msg=k)
    _check_updates(recs[0]["updates"], ref["updates"])
    _check_state(recs[0]["params"], ref["state"], ref["updates"], 2, buffers_atol=1e-5)
