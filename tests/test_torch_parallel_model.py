"""The model axis and the Switch-MoE's global routing on the CPU: four
gloo ranks, spawned once, held against the port's one process on the
whole global batch, against igm_tpu's one-device step, and through the
training CLI.

The spawn (``tests/_torch_mp.py``, which imports no JAX; each rank reports
that ``jax`` stayed out of ``sys.modules``) runs every case of
``_torch_mp.CASES`` for two steps from perturbed weights (adaLN-Zero's
zero gates would hide the DiT's blocks and the MoE's routing), recording
every update's reduced gradients whole, two-rank meshes two at once
(``_torch_mp.mesh_of``):

- FSDP (1, 2) on the flagship UNet (also with ``model.remat``: each block
  recomputed in the backward pass gathers its leaves again), on MADE in bfloat16 (``CastAdam``
  with stochastic rounding) and on RealNVP (``clip_by_global_norm``, so
  small that it decides every update); FSDP
  (2, 2) on the MLP VAE (BatchNorm over the batch group, its 2048-wide
  statistics sharded);
- tensor parallelism (2, 2) on the tiny DiT (also with ``model.remat``),
  and (1, 4) on it, where a
  shard holds half a head; the composed (1, 2, 2) mesh;
- sequence parallelism (Megatron-SP) with tensor parallelism at (1, 4)
  (a head split too) and at (2, 2) on 9 tokens, which the model axis does
  not divide; with FSDP at (2, 2) on 9 tokens;
- the Switch-MoE DiT on 2 and on 4 data ranks, dropping tokens, and its
  ``sample_sharded``;
- expert parallelism (tensor mode on the MoE DiT): (2, 2) with 2 of the 4
  experts a rank, (1, 4) with one a rank (scatter dispatch), the composed
  (1, 2, 2) mesh, 2 experts replicated on a model axis of 4, and the MoE
  DiT under sequence parallelism on 9 tokens, in tensor and fsdp mode;
- a one-process checkpoint restored on the (2, 2) tensor mesh;
- the training CLI on 4 ranks, ``+trainer.mesh.model=2
  +trainer.mesh.mode=tensor``, which saves;
- then, from igm_tpu-layout weights with igm_tpu's draws, the (2, 2)
  tensor DiT, the MoE DiT on 2 data ranks, the three sequence-parallel
  meshes and the expert-parallel (2, 2) MoE DiT, also under sequence
  parallelism on 9 tokens, against ``jax.jit(train_step)`` compiled here
  meanwhile.
"""
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
import _torch_mp as mp  # noqa: E402
from _torch_parity import (G_FLOOR, GRAD_ATOL_SCALE, LOSS_RTOL, PARAM_ATOL,  # noqa: E402
                           PARAM_RTOL, _flatten, adam_grads)
from igm_tpu_torch import cli  # noqa: E402
from igm_tpu_torch.interop import flax_to_torch  # noqa: E402
from igm_tpu_torch.parallel.launch import spawn  # noqa: E402
from igm_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from igm_tpu_torch.parallel.sharding import module_leaves  # noqa: E402
from test_torch_parallel_dp import (_check_state, _check_updates, _igm_model,  # noqa: E402
                                    _igm_state)

torch.set_num_threads(1)

WORLD = 4
SPAWN_TIMEOUT_S = 300
CPU = torch.device("cpu")
# the metrics of a mesh that sums over several ranks or GEMMs of other
# sizes than one process's: a few float32 ulps apart
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6
# bit for bit: FSDP on one data rank reorders no sum (the model group's
# ranks compute the same rows; the shards' Adam is elementwise; the
# stochastic rounding hashes the whole tensor's indices)
EXACT = ("fsdp_flagship", "fsdp_flagship_remat", "fsdp_made")
# RealNVP's clip takes the global norm as the sum over the model group of
# each shard's squares, not over the whole tensor: its state is held as
# the others' (tests/test_torch_parallel_dp.py's _check_state)
# a seeded input's smallest top-1 router-logit margin: above it, another
# GEMM blocking (2n rows or n) cannot flip a token's expert
MARGIN_FLOOR = 1e-4
SAMPLE_N, SAMPLE_ATOL = 8, 1e-3
FIT = [*mp.DIT, "datamodule.batch_size=8", "trainer.limit_train_batches=2",
       "trainer.limit_val_batches=0", "trainer.steps_per_execution=1", "model.lr=1e-4",
       "logger=null", "callbacks=null", "print_config=False"]
FIT_LR = 1e-4
SEQUENCE = [case for case in mp.CASES if case.startswith("sequence_")]
# expert parallelism held against igm_tpu's step: the (2, 2) MoE DiT on
# moe_igm's weights, draws and igm_tpu result, and under sequence
# parallelism on 9 tokens
EXPERT_IGM = {"moe_tensor_igm": ("moe_igm", mp.CASES["moe_tensor"][3]),
              "moe_sequence_tensor_9_igm": (None, mp.CASES["moe_sequence_tensor_9"][3])}


def _igm_job(name: str, overrides, mesh_kw, seed: int):
    """igm_tpu's DDPM step on 8 images from its own weights and draws: the
    port's job on ``mesh_kw`` and what it must give."""
    jm = _igm_model(overrides)
    state = _igm_state(jm, seed)
    batch = dp.make_batch(dp.build(overrides), 8, seed + 4)
    keys = jax.random.split(state.rng, 3)[1:]
    timesteps = dp.build(overrides).timesteps
    draws = {"t": np.array(jax.random.randint(keys[0], (8,), 0, timesteps), np.int64),
             "noise": np.array(jax.random.normal(keys[1], batch[0].shape), np.float32)}
    new_state, metrics = jax.jit(jm.train_step)(state, tuple(map(jnp.asarray, batch)))
    weights = {f"denoise.{k}": v for k, v in flax_to_torch(
        _flatten(state.params["denoise"])).items()}
    want = {"loss": float(metrics["train_loss/loss"]),
            "grads": {f"denoise.{k}": v.numpy() for k, v in flax_to_torch(_flatten(
                adam_grads(new_state, "opt", "denoise", float(jm.hparams.b1)))).items()},
            "params": {f"denoise.{k}": v.numpy() for k, v in flax_to_torch(
                _flatten(new_state.params["denoise"])).items()}}
    return (name, overrides, batch, 1, mesh_kw, weights, draws), want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case run once by four spawned gloo ranks, and the CLI fit:
    (records by case and rank, the jobs, igm_tpu's results, the fit's run
    directory)."""
    out = tmp_path_factory.mktemp("mp")
    jobs = {name: (name, overrides, dp.make_batch(dp.build(overrides), n, 3), steps, kw,
                   mp.perturbed(dp.build(overrides)), None)
            for name, (overrides, n, steps, kw) in mp.CASES.items()}
    samples = [("sample_moe", mp.MOE_DIT, SAMPLE_N, "ddim_sample", dict(data=2, pairs=True)),
               ("sample_moe_tensor", mp.MOE_DIT, SAMPLE_N, "ddim_sample",
                dict(data=2, model=2, mode="tensor"))]
    run = out / "fit"
    fits = [[*FIT, f"datamodule.data_dir={out / 'data'}", "trainer.devices=4",
             "+trainer.mesh.model=2", "+trainer.mesh.mode=tensor", "trainer.max_epochs=1",
             f"hydra.run.dir={run}"]]
    later = out / "igm_jobs.pt"
    failed = []

    def ranks_():
        try:
            spawn(mp.rank_main, WORLD, CPU, (list(jobs.values()), samples, fits, str(out),
                                             str(later)), timeout=SPAWN_TIMEOUT_S)
        except BaseException as exc:     # raised in the test's thread below
            failed.append(exc)

    spawner = threading.Thread(target=ranks_)
    spawner.start()
    igm, igm_jobs = {}, []
    try:
        for name, overrides, kw, seed in (
                ("tensor_dit_igm", mp.DIT, dict(data=2, model=2, mode="tensor"), 1),
                ("moe_igm", mp.MOE_DIT, dict(data=2, pairs=True), 2),
                *((f"{case}_igm", mp.CASES[case][0], mp.CASES[case][3], 3)
                  for case in SEQUENCE + ["moe_sequence_tensor_9"])):
            job, want = _igm_job(name, overrides, kw, seed)
            igm_jobs.append(job)
            igm[name] = want
        for name, (like, kw) in EXPERT_IGM.items():
            if like is not None:     # another mesh on the same igm_tpu step
                job = next(j for j in igm_jobs if j[0] == like)
                igm_jobs.append((name, *job[1:4], kw, *job[5:]))
                igm[name] = igm[like]
    finally:                  # the ranks wait for the file: written even on a failure
        torch.save(igm_jobs, out / "igm_jobs.tmp")
        (out / "igm_jobs.tmp").replace(later)
        spawner.join()
    if failed:
        raise failed[0]
    jobs.update((job[0], job) for job in igm_jobs)
    records = {name: [torch.load(out / f"{name}.rank{r}.pt", weights_only=False)
                      for r in range(WORLD)]
               for name in [*jobs, *(s[0] for s in samples), "resume_on_mesh",
                            "shard_state", "resume_on_mesh_moe", "shard_state_moe"]}
    return records, jobs, igm, run


def _replicas_agree(recs, kw):
    """The ranks of a mesh (each replica's) end in the same whole state
    bit for bit and report the same metrics; none imported JAX."""
    assert not any(r.get("jax") for r in recs)
    size = len(recs) // (2 if kw.get("pairs") else 1)
    for first in range(0, len(recs), size):
        for r in recs[first + 1:first + size]:
            np.testing.assert_equal(r["metrics"], recs[first]["metrics"])
            for k, v in recs[first]["params"].items():
                assert torch.equal(r["params"][k], v), k


def _flat_opt(opt_states) -> dict:
    out = {}
    for name, value in opt_states.items():
        if isinstance(value, dict) and "state" in value:
            for i, st in value["state"].items():
                out.update({f"{name}.{i}.{k}": t for k, t in st.items()})
        else:
            out.update({f"{name}.{k}": t for k, t in value.items()})
    return out


@pytest.mark.parametrize("case", list(mp.CASES))
def test_mesh_matches_one_process(ranks, case):
    """Two steps on the mesh against the port's one process on the whole
    global batch from the same perturbed weights: every metric, every
    update's reduced gradients and the parameters and buffers after,
    gathered whole (tests/test_torch_parallel_dp.py's tolerances); bit for
    bit, optimizer moments and EMA shadow too, where nothing is summed in
    another order (EXACT)."""
    records, jobs, _, _ = ranks
    recs = records[case]
    _, overrides, batch, steps, kw, weights, _ = jobs[case]
    _replicas_agree(recs, kw)
    one = mp.run(dp.build(overrides), batch, steps, weights=weights)
    ref = dp.run(dp.build(overrides), batch, steps, weights=weights)
    got = recs[0]
    assert got["step"] == one["step"] == steps
    if kw.get("model", 1) > 1:
        assert got["sharded"], case
    if case in EXACT:
        assert got["metrics"] == one["metrics"]
        for (_, names, _, gs), (_, _, _, ws) in zip(got["updates"], one["updates"]):
            assert all(torch.equal(g, w) for g, w in zip(gs, ws)), names
        for k, v in one["params"].items():
            assert torch.equal(got["params"][k], v), k
        want_opt, got_opt = _flat_opt(one["opt_states"]), _flat_opt(got["opt_states"])
        assert set(want_opt) == set(got_opt)
        for k, v in want_opt.items():
            assert torch.equal(got_opt[k].cpu(), v.cpu()), k
        return
    for m, w in zip(got["metrics"], one["metrics"]):
        assert set(m) == set(w)
        for k, v in w.items():
            np.testing.assert_allclose(m[k], v, rtol=METRIC_RTOL, atol=METRIC_ATOL, err_msg=k)
    _check_updates(got["updates"], ref["updates"])
    lr = max(u[2] for u in ref["updates"])
    _check_state(got["params"], ref["state"], ref["updates"], steps,
                 buffers_atol=1e-5 + 2 * steps * lr)


def test_fsdp_state_bytes_are_the_shards(ranks):
    """FSDP (1, 2) on the flagship: each rank keeps, of every leaf of the
    train state (parameters, Adam's moments, the EMA shadow), half of a
    sharded one and the whole of a replicated one, by exact count, the
    step counters beside."""
    records, jobs, _, _ = ranks
    overrides = jobs["fsdp_flagship"][1]
    model = dp.build(overrides)
    state = model.init_state(0)
    mesh = Mesh(1, 0, CPU, axes=(("data", 1), ("model", 2)))
    half = {leaf.key: leaf.sharded for leaf in module_leaves(model.modules, mesh)}
    per = lambda t: t.numel() * t.element_size()        # noqa: E731
    names = {id(p): k for k, p in model.modules.named_parameters()}
    want = sum(per(t) // (2 if half[k] else 1) for k, t in model.modules.state_dict().items())
    opt = state.opt_states["opt"]
    for p in opt.param_groups[0]["params"]:
        for key, t in opt.state[p].items():
            want += per(t) // (2 if half[names[id(p)]] and t.ndim else 1)
    want += sum(per(t) // (2 if half[f"denoise.{k}"] else 1)
                for k, t in state.opt_states["ema"].items())
    one = mp.state_bytes(state)
    replicated = sum(per(t) for k, t in model.modules.state_dict().items() if not half[k])
    assert all(r["bytes"] == want for r in records["fsdp_flagship"])
    assert want <= one / 2 + 4 * replicated and sum(half.values()) >= 10


@pytest.mark.parametrize("case", [c for c in mp.CASES if c.startswith("moe_")
                                  and mp.CASES[c][3].get("mode") == "tensor"])
def test_expert_parallel_shards_the_experts(ranks, case):
    """tests/test_moe.py's test_expert_parallel_sharding_and_equality: in
    tensor mode the stacked expert leaves' expert axis is over ``model``
    (the router whole); each rank holds E/m experts (all E where ``model``
    does not divide them), and keeps fewer state bytes than one process;
    the model group's ranks hold different experts."""
    records, jobs, _, _ = ranks
    recs = records[case]
    _, overrides, _, _, kw, _, _ = jobs[case]
    model = dp.build(overrides)
    whole = {k: tuple(p.shape) for k, p in model.modules.named_parameters()}
    axes = [("data", kw.get("data", 1))] + ([("fsdp", kw["fsdp"])] if "fsdp" in kw else [])
    mesh = Mesh(1, 0, CPU, axes=(*axes, ("model", kw["model"])), mode="tensor")
    specs = {leaf.key: leaf.spec for leaf in module_leaves(model.modules, mesh)}
    e, m = model.hparams.moe_experts, kw["model"]
    experts = [k for k in whole if k.split(".")[-1] in ("w_up", "w_dn", "b_up", "b_dn")]
    routers = [k for k in whole if k.endswith("moe.router.weight")]
    assert experts and routers
    for k in routers:
        assert specs[k] == () and all(r["shapes"][k] == whole[k] for r in recs), k
    held = e // m if e % m == 0 else e
    for k in experts:
        assert specs[k] == (("model",) + (None,) * (len(whole[k]) - 1) if e % m == 0 else ())
        for rank, r in enumerate(recs):        # model is the innermost axis
            assert r["shapes"][k] == (held, *whole[k][1:]), (k, r["shapes"][k])
            first = (rank % m) * held if e % m == 0 else 0
            assert torch.equal(r["experts"][k], r["params"][k][first:first + held]), k
    assert all(r["bytes"] < mp.state_bytes(dp.build(overrides).init_state(0)) for r in recs)


def _routing(x: torch.Tensor, weight: torch.Tensor, cap: int, world: int):
    """The one-process Switch routing of ``x``'s tokens: (expert, position
    among the tokens routed to it, top-1 logit margin) per token, and each
    token's position counting its own rank's tokens alone."""
    logits = x.float().reshape(-1, x.shape[-1]) @ weight.float().t()
    top2 = logits.topk(2, dim=-1).values
    idx = logits.argmax(dim=-1)
    onehot = torch.nn.functional.one_hot(idx, weight.shape[0]).float()
    pos = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    per = len(idx) // world
    local = torch.cat([((torch.cumsum(onehot[r * per:(r + 1) * per], 0) - 1)
                        * onehot[r * per:(r + 1) * per]).sum(-1) for r in range(world)])
    return idx, pos, local, (top2[:, 0] - top2[:, 1])


@pytest.mark.parametrize("case,world", [("moe_data2", 2), ("moe_data4", 4)])
def test_moe_global_routing_drops_across_ranks(ranks, case, world):
    """The MoE DiT's first forward: the seeded tokens' top-1 margins are
    clear of a near-tie; tokens past the global capacity are dropped; and
    at least one token that its own rank's count alone would keep is
    dropped because lower ranks filled its expert.  The ranks' router
    inputs together are one process's."""
    records, jobs, _, _ = ranks
    _, overrides, batch, steps, _, weights, _ = jobs[case]
    model = dp.build(overrides)
    one = mp.run(model, batch, steps, weights=weights)
    key, x = one["moe_inputs"][0]
    n = x.shape[0] * x.shape[1]
    cap = model.modules.get_submodule(key).capacity(n)
    idx, pos, local, margin = _routing(x, weights[f"{key}.router.weight"], cap, world)
    assert float(margin.min()) > MARGIN_FLOOR
    dropped = pos >= cap
    assert dropped.any() and not dropped.all()
    assert ((local < cap) & dropped).any()
    parts = [records[case][r]["moe_inputs"][0][1] for r in range(world)]
    np.testing.assert_allclose(torch.cat(parts).numpy(), x.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["sample_moe", "sample_moe_tensor"])
def test_moe_sample_sharded_matches_one_process(ranks, name):
    """DDIM over 8 images from generator seed 0 on the MoE DiT, two data
    ranks through sample_sharded (routing over both ranks' tokens; on the
    (2, 2) tensor mesh each rank gathers the whole experts first): one
    process's images on all 8, within SAMPLE_ATOL."""
    records, _, _, _ = ranks
    recs = records[name]
    assert not any(r["jax"] for r in recs)
    assert all(torch.equal(r["imgs"], recs[0]["imgs"]) for r in recs)
    whole = dp.build(mp.MOE_DIT).ddim_sample(SAMPLE_N,
                                             generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(recs[0]["imgs"].numpy(), whole.numpy(), atol=SAMPLE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("how", ["resume_on_mesh", "shard_state", "resume_on_mesh_moe",
                                 "shard_state_moe"])
def test_one_process_checkpoint_resumes_on_a_mesh(ranks, how):
    """A one-process checkpoint restored on the (2, 2) tensor mesh, and a
    one-process state placed there by ``shard_state``, of the DiT and of
    the MoE DiT (each rank then holds 2 of the 4 experts a block): the
    whole state every rank gathers back is the checkpoint's, bit for bit."""
    from igm_tpu_torch.core.checkpoint import CheckpointManager
    records, _, _, run = ranks
    moe = how.endswith("_moe")
    saved = CheckpointManager(str(run.parent / ("one_process_moe_ckpt" if moe
                                                else "one_process_ckpt"))).restore_raw()
    if moe:
        for rec in records[how]:
            assert [s for k, s in rec["shapes"].items() if k.endswith("moe.w_up")] == \
                [(2, 32, 128)]
    for rec in records[how]:
        assert rec["step"] == saved["step"] == 1
        for k, v in saved["params"].items():
            assert torch.equal(rec["params"][k], v), k
        want, got = _flat_opt(saved["opt_states"]), _flat_opt(rec["opt_states"])
        for k, v in want.items():
            assert torch.equal(got[k].cpu(), v), k


def test_cli_tensor_fit_resumes_in_one_process(ranks, tmp_path, monkeypatch):
    """``trainer.devices=4 +trainer.mesh.model=2 +trainer.mesh.mode=tensor``:
    the four ranks' CLI fit (an epoch of 2 steps) saved the whole state in
    the one-process format; one process resumes it for a second epoch and
    holds what one process training both epochs holds: the step and the
    Adam counts exactly, the parameters within the 2 lr a step that a
    gradient sign decided by rounding moves."""
    *_, run = ranks
    monkeypatch.chdir(tmp_path)
    data = f"datamodule.data_dir={run.parent / 'data'}"
    ckpt = run / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_2.pt"]
    resumed, one = tmp_path / "resumed", tmp_path / "one"
    cli.train_main([*FIT, data, "trainer.max_epochs=2", f"hydra.run.dir={resumed}",
                    f"trainer.resume={ckpt}", "--device", "cpu"])
    cli.train_main([*FIT, data, "trainer.max_epochs=2", f"hydra.run.dir={one}",
                    "--device", "cpu"])
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


@pytest.mark.parametrize("case", ["tensor_dit_igm", "moe_igm",
                                  *(f"{case}_igm" for case in SEQUENCE), *EXPERT_IGM])
def test_mesh_matches_igm_tpu(ranks, case):
    """The (2, 2) tensor DiT, the MoE DiT on two data ranks, the
    sequence-parallel meshes (tests/test_parallel.py's
    test_sequence_parallel_matches_and_scatters holds igm_tpu's own) and
    expert parallelism (tests/test_moe.py's
    test_expert_parallel_sharding_and_equality), from
    igm_tpu's weights and draws: igm_tpu's one-device step on the global
    batch, the loss and the parameters after Adam where the gradient's
    sign is certain (tests/_torch_parity.py's tolerances), every
    parameter within the lr of its start."""
    records, jobs, igm, _ = ranks
    recs = records[case]
    _replicas_agree(recs, jobs[case][4])
    want = igm[case]
    got = recs[0]
    for key, x in (got["moe_inputs"] + recs[1]["moe_inputs"])[:2]:    # the ranks' first forward
        weight = jobs[case][5][f"{key}.router.weight"]
        top2 = (x.reshape(-1, x.shape[-1]).float() @ weight.t()).topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN_FLOOR
    np.testing.assert_allclose(got["metrics"][0]["train_loss/loss"], want["loss"],
                               rtol=LOSS_RTOL)
    scale = max(np.abs(w).max() for w in want["grads"].values())
    floor = max(G_FLOOR, 2 * GRAD_ATOL_SCALE * scale)
    before = jobs[case][5]
    lr = 1e-4
    for k, w in want["params"].items():
        p = got["params"][k].numpy()
        big = np.abs(want["grads"][k]) > floor
        np.testing.assert_allclose(p[big], w[big], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=k)
        assert np.all(np.abs(p - before[k].numpy()) <= lr * (1 + 1e-3) + PARAM_ATOL), k


@pytest.mark.slow
def test_composed_mesh_of_eight_ranks_matches_one_process(tmp_path):
    """test_parallel.py's composed (2, 2, 2) mesh: eight ranks, two steps
    of the tiny DiT against one process on the global batch."""
    batch = dp.make_batch(dp.build(mp.DIT), 8, 3)
    weights = mp.perturbed(dp.build(mp.DIT))
    spawn(mp.composed_rank, 8, CPU, (str(tmp_path), batch, weights), timeout=SPAWN_TIMEOUT_S)
    recs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(8)]
    _replicas_agree(recs, {})
    ref = dp.run(dp.build(mp.DIT), batch, 2, weights=weights)
    one = mp.run(dp.build(mp.DIT), batch, 2, weights=weights)
    for m, w in zip(recs[0]["metrics"], one["metrics"]):
        for k, v in w.items():
            np.testing.assert_allclose(m[k], v, rtol=METRIC_RTOL, atol=METRIC_ATOL, err_msg=k)
    _check_updates(recs[0]["updates"], ref["updates"])
    _check_state(recs[0]["params"], ref["state"], ref["updates"], 2, buffers_atol=1e-5)
