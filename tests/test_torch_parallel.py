"""The data axis in one process: the mesh API (``make_mesh`` without a
group and with a world-1 gloo group, ``Mesh.local_rows``, ``shard_batch``,
``batch_draw``, ``pad_to_multiple``, ``replicate``), ``epoch_batches``'s
``divisor`` rounding against igm_tpu's, the world-1 group's train step
against the ungrouped one bit for bit, the launch decisions of the
training CLI (N ranks spawned, ``IGM_MULTIHOST=1`` joining torchrun's
group, a multirun refused), the model axes' configuration (a model or
fsdp axis builds, or raises igm_tpu's ValueError where the ranks do not
make it), the pipeline and sequence keys (slice 7c: igm_tpu's errors
where one process cannot make the mesh, or the model has no hook), and
the Switch-MoE's binding: global routing on the data axis, its model
group in tensor mode (expert parallelism), a step of several row blocks
refused.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _torch_dp as dp  # noqa: E402
from igm_tpu.data.loader import epoch_batches as jax_epoch_batches  # noqa: E402
from igm_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple  # noqa: E402
from igm_tpu_torch import cli  # noqa: E402
from igm_tpu_torch.core.trainer import Trainer  # noqa: E402
from igm_tpu_torch.data.loader import epoch_batches, global_batch  # noqa: E402
from igm_tpu_torch.networks.moe import SwitchMoE  # noqa: E402
from igm_tpu_torch.parallel import launch  # noqa: E402
from igm_tpu_torch.parallel.mesh import (Mesh, batch_draw, make_mesh, pad_to_multiple,  # noqa: E402
                                         replicate, sample_sharded, shard_batch)

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def group():
    """A gloo process group of one rank (this process), destroyed after."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{launch.free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_without_a_group_is_one_process():
    mesh = make_mesh(devices="cpu")
    assert (mesh.world, mesh.rank, mesh.grouped, mesh.shape) == (1, 0, False, {"data": 1})
    assert make_mesh(data=1, devices=[CPU]).world == 1
    with pytest.raises(ValueError, match="trainer.devices=2"):
        make_mesh(data=2, devices="cpu")
    with pytest.raises(ValueError, match="one device"):
        make_mesh(devices=["cpu", "cpu"])
    for kw, match in ((dict(model=2), "model axis 2 does not divide 1 devices"),
                      (dict(fsdp=2), "fsdp axis requires a model axis")):
        with pytest.raises(ValueError, match=match):
            make_mesh(devices="cpu", **kw)


def test_make_mesh_takes_the_group(group):
    mesh = make_mesh(devices="cpu")
    assert (mesh.world, mesh.rank, mesh.backend, mesh.grouped) == (1, 0, "gloo", True)
    assert not mesh.capturable                  # gloo: the steps run eagerly
    with pytest.raises(ValueError, match="1 rank"):
        make_mesh(data=2, devices="cpu")
    model = torch.nn.Linear(3, 2)
    want = [p.detach().clone() for p in model.parameters()]
    assert replicate(mesh, model) is model      # one rank: its own tensors
    assert all(torch.equal(p, w) for p, w in zip(model.parameters(), want))


@pytest.mark.parametrize("world,blocks", [(2, 1), (4, 1), (2, 2), (3, 2)])
def test_local_rows_split_every_block_over_the_ranks(world, blocks):
    n = 12 * world * blocks // np.gcd(12, world * blocks)
    rows = [Mesh(world, r, CPU).local_rows(n, blocks) for r in range(world)]
    assert sorted(np.concatenate(rows).tolist()) == list(range(n))
    size = n // blocks
    for r, mine in enumerate(rows):          # rank r: the r-th slice of each block
        per = size // world
        assert mine.tolist() == [b * size + r * per + i for b in range(blocks)
                                 for i in range(per)]
    with pytest.raises(ValueError, match="does not split"):
        Mesh(world, 0, CPU).local_rows(n + 1, blocks)


def test_shard_batch_gives_each_rank_its_rows():
    imgs = np.arange(8 * 2, dtype=np.uint8).reshape(8, 2)
    labels = np.arange(8, dtype=np.int32)
    for r in range(2):
        got = shard_batch(Mesh(2, r, CPU), (imgs, torch.from_numpy(labels)), blocks=2)
        assert got[1].tolist() == [2 * r, 2 * r + 1, 4 + 2 * r, 5 + 2 * r]
        assert torch.equal(got[0], torch.from_numpy(imgs[got[1].numpy()]))


@pytest.mark.parametrize("n,batch,divisor", [(100, 32, 1), (100, 32, 3), (100, 30, 8),
                                              (10, 32, 4), (7, 4, 8), (5, 8, 8)])
def test_divisor_rounding_matches_igm_tpu(n, batch, divisor):
    arrays = (np.arange(n, dtype=np.int64),)
    try:
        want = [b[0].tolist() for b in jax_epoch_batches(arrays, batch, divisor=divisor)]
    except ValueError as err:
        assert "divisible by the" in str(err)
        with pytest.raises(ValueError, match="divisible by the"):
            global_batch(n, batch, divisor)
        return
    assert [b[0].tolist() for b in epoch_batches(arrays, batch, divisor=divisor)] == want
    assert global_batch(n, batch, divisor) == len(want[0])


def test_epoch_batches_rows_are_the_ranks_parts_of_one_order():
    arrays = (np.arange(64, dtype=np.int64), np.arange(64, dtype=np.int32) * 3)
    whole = list(epoch_batches(arrays, 16, np.random.default_rng(2), shuffle=True,
                               divisor=4))
    for r in range(4):
        rows = Mesh(4, r, CPU).local_rows(16)
        part = list(epoch_batches(arrays, 16, np.random.default_rng(2), shuffle=True,
                                  divisor=4, rows=rows))
        assert len(part) == len(whole)
        for p, w in zip(part, whole):
            assert p[0].tolist() == w[0][rows].tolist() and p[1].tolist() == w[1][rows].tolist()


def test_batch_draw_is_the_global_draws_rows():
    shape = (3, 5)
    one = torch.Generator().manual_seed(4)
    want = torch.randn((6, 5), generator=one)
    for r in range(2):
        gen = torch.Generator().manual_seed(4)
        got = batch_draw(Mesh(2, r, CPU), torch.randn, shape, gen, CPU)
        assert torch.equal(got, want[3 * r:3 * r + 3])
        assert torch.equal(gen.get_state(), one.get_state())   # the generators stay in step
    gen = torch.Generator().manual_seed(4)
    assert torch.equal(batch_draw(None, torch.randn, (6, 5), gen, CPU), want)


def test_pad_to_multiple_matches_igm_tpu():
    for n, k in ((0, 4), (1, 4), (8, 4), (9, 4), (13, 1)):
        assert pad_to_multiple(n, k) == jax_pad_to_multiple(n, k)


def test_sample_sharded_refuses_a_batch_the_ranks_do_not_divide():
    with pytest.raises(ValueError, match="not divisible by data axes 2"):
        sample_sharded(None, Mesh(2, 0, CPU), None, None, 5)


def test_world_one_group_step_equals_the_ungrouped_step(group):
    """One rank with a group runs every collective (each a copy): two DDPM
    steps equal the ungrouped steps bit for bit (the card's NCCL rank
    checks the same inside the step's CUDA graph)."""
    overrides, n, steps = dp.CASES["ddpm"]
    batch = dp.make_batch(dp.build(overrides), n, 3)
    ungrouped = dp.run(dp.build(overrides), batch, steps)
    grouped = dp.run(dp.build(overrides), batch, steps, make_mesh(devices="cpu"))
    assert grouped["metrics"] == ungrouped["metrics"]
    for (_, names, _, got), (_, _, _, want) in zip(grouped["updates"], ungrouped["updates"]):
        assert all(torch.equal(g, w) for g, w in zip(got, want)), names
    for k, v in ungrouped["state"].items():
        assert torch.equal(grouped["state"][k], v), k


def test_moe_refuses_more_than_one_rank():
    """The Switch-MoE routes over a many-rank data axis (global routing,
    tests/test_torch_parallel_model.py) and, in mesh.mode=tensor on an MoE
    DiT, records its model group, over which its experts are sharded
    (expert parallelism); what it refuses is a step that hands its rows
    out in several blocks."""
    moe = SwitchMoE(8, 16, 2)
    moe.bind_mesh(None)
    assert moe.mesh is None
    for mesh in (Mesh(1, 0, CPU, "nccl", object()), Mesh(2, 0, CPU, "gloo", object())):
        moe.bind_mesh(mesh)
        assert moe.mesh is mesh
    with pytest.raises(ValueError, match="2 blocks"):
        moe.bind_mesh(Mesh(2, 0, CPU, "gloo", object()), blocks=2)
    model = dp.build(["experiment=ddpm/cifar10_dit", "model.hidden_dim=32", "model.depth=2",
                      "model.heads=2", "model.patch=4", "datamodule.width=8",
                      "datamodule.height=8", "model.moe_experts=2"])
    tensor = Mesh(1, 0, CPU, "gloo", object(), axes=(("data", 1), ("model", 2)),
                  coords=(("data", 0), ("model", 0)), mode="tensor")
    model.set_mesh(tensor)
    block = model.modules["denoise"].DiTBlock_1
    assert block.tp.size == 2 and block.moe.tp.size == 2 and block.moe.tp.rank == 0
    assert block.moe.mesh is tensor
    model.set_mesh(None)
    assert block.tp is None and block.moe.tp is None and block.moe.mesh is None


@pytest.mark.parametrize("mesh,slice_", [({"model": 2}, "7b"), ({"fsdp": 2}, "7b"),
                                         ({"mode": "tensor"}, "7b"), ({"stage": 2}, "7c"),
                                         ({"mode": "pipeline"}, "7c"),
                                         ({"sequence": True}, "7c")])
def test_trainer_refuses_what_the_port_has_not_reached(mesh, slice_):
    """The mesh keys of slices 7b and 7c build what igm_tpu's trainer
    builds, and raise its ValueError where one process cannot make the mesh
    asked for: a model or fsdp axis of 2 ("does not divide", "requires a
    model axis"), a stage axis of 2 ("needs 2 devices"), mode=pipeline
    without a stage ("needs mesh.stage > 1", at construction, as there).
    mesh.sequence builds the data mesh, on which the DiT's step raises
    igm_tpu's "sp_mesh needs a 'model' axis"; a model without the hook
    raises "needs a model with enable_..."."""
    if mesh.get("mode") == "pipeline":
        with pytest.raises(ValueError, match=r"needs mesh.stage > 1"):
            Trainer(mesh={"data": -1, **mesh})
        return
    trainer = Trainer(mesh={"data": -1, **mesh})
    if mesh.get("model", 1) > 1 or mesh.get("fsdp", 1) > 1:
        with pytest.raises(ValueError, match="does not divide|requires a model axis"):
            make_mesh(trainer.mesh_data, devices="cpu", **trainer.mesh_axes)
    elif mesh.get("stage", 1) > 1:
        assert trainer.mesh_axes["mode"] == "pipeline"
        with pytest.raises(ValueError, match=r"mesh \(1,2\) needs 2 devices, have 1"):
            make_mesh(trainer.mesh_data, devices="cpu", **trainer.mesh_axes)
    elif mesh.get("sequence"):
        built = make_mesh(trainer.mesh_data, devices="cpu", **trainer.mesh_axes)
        vae = dp.build(["experiment=vae/mnist_mlp", "networks.encoder.hidden_dims=[8]",
                        "networks.decoder.hidden_dims=[8]"])
        with pytest.raises(ValueError, match="needs a model with enable_sequence_parallel"):
            trainer.prepare_model(vae, built)
        model = dp.build(["experiment=ddpm/cifar10_dit", "model.hidden_dim=32",
                          "model.depth=1", "model.heads=2", "model.patch=4",
                          "datamodule.width=8", "datamodule.height=8"])
        trainer.prepare_model(model, built)
        model.set_mesh(built)
        state = model.init_state(0)
        batch = tuple(torch.from_numpy(a)[None] for a in dp.make_batch(model, 2, 0))
        with pytest.raises(ValueError, match="sp_mesh needs a 'model' axis"):
            model.train_step_n(state, batch)
    else:
        built = make_mesh(trainer.mesh_data, devices="cpu", **trainer.mesh_axes)
        assert (built.mode, built.world) == ("tensor", 1)


def test_trainer_devices_needs_its_ranks():
    Trainer(devices=1)
    Trainer(devices=-1)
    with pytest.raises(ValueError, match="launch them"):
        Trainer(devices=2)


def test_train_main_spawns_the_ranks(monkeypatch):
    """``trainer.devices=N`` spawns N ranks running the CLI's rank entry;
    1 (the default) and -1 on the CPU run one process; a multirun may not
    ask for more than one device."""
    spawned, single = [], []
    monkeypatch.setattr(launch, "spawn", lambda fn, world, device, args: spawned.append(
        (fn, world, device, args)))
    monkeypatch.setattr(cli, "_single_run", lambda overrides, device: single.append(overrides))
    monkeypatch.delenv("IGM_MULTIHOST", raising=False)
    cli.train_main(["experiment=ddpm/cifar10", "trainer.devices=3", "--device", "cpu"])
    assert spawned == [(cli._rank_run, 3, CPU, (["experiment=ddpm/cifar10",
                                                 "trainer.devices=3"],))]
    for devices in ("1", "-1"):
        cli.train_main(["experiment=ddpm/cifar10", f"trainer.devices={devices}",
                        "--device", "cpu"])
    assert len(spawned) == 1 and len(single) == 2
    for sweep in (["trainer.devices=2"], ["trainer.devices=1,2"]):
        with pytest.raises(SystemExit, match="multirun job trains on one device"):
            cli.train_main(["-m", "experiment=vae/mnist_mlp", "model.lr=1e-3,5e-4", *sweep,
                            "--device", "cpu"])


def test_multihost_joins_torchruns_group(tmp_path, monkeypatch):
    """``IGM_MULTIHOST=1``: the rank joins the group torchrun describes in
    its environment (here one rank) and trains on it, then leaves it."""
    monkeypatch.chdir(tmp_path)
    for key, value in (("IGM_MULTIHOST", "1"), ("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(launch.free_port()))):
        monkeypatch.setenv(key, value)
    run = tmp_path / "run"
    cli.train_main([*dp.CASES["ddpm"][0], "datamodule.batch_size=4", "trainer.max_epochs=1",
                    "trainer.limit_train_batches=1", "trainer.limit_val_batches=0",
                    "trainer.steps_per_execution=1", "trainer.devices=-1", "logger=null",
                    "callbacks=null", "print_config=False", f"hydra.run.dir={run}",
                    f"datamodule.data_dir={tmp_path / 'data'}", "--device", "cpu"])
    assert not dist.is_initialized()
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step_1.pt"]
