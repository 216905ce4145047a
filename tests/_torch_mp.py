"""The port's train steps on a mesh with a model axis (FSDP, tensor
parallelism, the composed mesh, sequence parallelism with either) and the
Switch-MoE's global routing and expert parallelism, in spawned ranks, recording what the
model-axis parity tests compare: each step's metrics, the whole state
after the steps (gathered from the shards: parameters, buffers, optimizer
moments, the EMA shadow), each rank's persistent state bytes, and the
routing the MoE blocks made.

Spawned ranks import this module: it imports no JAX and nothing of
``igm_tpu`` (each rank reports whether ``jax`` got into ``sys.modules``).
"""
import functools
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import _torch_dp as dp  # noqa: E402
from igm_tpu_torch.networks.moe import SwitchMoE  # noqa: E402
from igm_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch  # noqa: E402

FLAGSHIP = ["experiment=ddpm/cifar10", "model.hidden_dim=16", "model.dim_mults=[1,2]",
            "model.timesteps=16", "datamodule.width=8", "datamodule.height=8",
            "model.ema_decay=0.9"]
MADE_BF16 = ["experiment=made/mnist", "datamodule.width=6", "datamodule.height=6",
             "model.hidden_dim=64", "model.n_layer=2", "model.compute_dtype=bfloat16",
             "model.weight_dtype=bfloat16"]
# a clip so small that the global norm decides every update (the gradients
# end below Adam's eps): a shard's squares missing from the norm shows
REALNVP = ["experiment=realnvp/mnist", "datamodule.width=8", "datamodule.height=8",
           "model.hidden_dim=32", "model.grad_clip=1e-7"]
# the decoder's last hidden layer is 2048 wide: its BatchNorm's scale,
# bias, mean and var are FSDP leaves (FSDP_MIN_SIZE), gathered and put back
VAE_MLP = ["experiment=vae/mnist_mlp", "datamodule.width=8", "datamodule.height=8",
           "networks.encoder.hidden_dims=[64,16]", "networks.decoder.hidden_dims=[16,2048]",
           "model.latent_dim=4", "model.lr=1e-3"]
# tests/test_parallel.py's _tiny_dit_ddpm
DIT = ["experiment=ddpm/cifar10_dit", "model.hidden_dim=32", "model.depth=2", "model.heads=2",
       "model.patch=4", "model.timesteps=8", "model.loss_type=l2",
       "model.compute_dtype=float32", "datamodule.width=16", "datamodule.height=16",
       "datamodule.channels=1", "model.ema_decay=0"]
# every 2nd block a Switch-MoE of 4 experts whose capacity (cf 0.5) drops tokens
MOE_DIT = [*DIT, "model.moe_experts=4", "model.moe_every=2", "model.moe_capacity=0.5"]
# 12x12 images of 4x4 patches: 9 tokens, which a model axis of 2 does not divide
DIT_9 = [*DIT, "datamodule.width=12", "datamodule.height=12"]
MOE_DIT_9 = [*MOE_DIT, "datamodule.width=12", "datamodule.height=12"]

# name: (overrides, global batch, steps, mesh keywords: make_mesh's over
# the four ranks, or with pairs=True two-rank meshes (mesh_of))
CASES = {
    "fsdp_flagship": (FLAGSHIP, 8, 2, dict(model=2, pairs=True)),
    "fsdp_flagship_remat": ([*FLAGSHIP, "model.remat=true"], 8, 2, dict(model=2, pairs=True)),
    "fsdp_made": (MADE_BF16, 8, 2, dict(model=2, pairs=True)),
    "fsdp_realnvp": (REALNVP, 8, 2, dict(model=2, pairs=True)),
    "fsdp_vae": (VAE_MLP, 8, 2, dict(data=2, model=2)),
    "tensor_dit": (DIT, 8, 2, dict(data=2, model=2, mode="tensor")),
    "tensor_dit_remat": ([*DIT, "model.remat=true"], 8, 2,
                         dict(data=2, model=2, mode="tensor")),
    "tensor_dit_split_heads": (DIT, 8, 2, dict(data=1, model=4, mode="tensor")),
    "composed_dit": (DIT, 8, 2, dict(data=1, fsdp=2, model=2, mode="tensor")),
    "moe_data2": (MOE_DIT, 8, 2, dict(data=2, pairs=True)),
    "moe_data4": (MOE_DIT, 8, 2, dict(data=4)),
    # Megatron-SP: (1, 4) splits a head and 16 tokens 4 ways, (2, 2) 9 tokens
    # 2 ways (one rank's part padded); fsdp + sequence gathers at each block
    "sequence_tensor_dit": (DIT, 8, 2, dict(data=1, model=4, mode="tensor", sequence=True)),
    "sequence_tensor_dit_9": (DIT_9, 8, 2, dict(data=2, model=2, mode="tensor",
                                                 sequence=True)),
    "sequence_fsdp_dit": (DIT_9, 8, 2, dict(data=2, model=2, sequence=True)),
    # expert parallelism: (2, 2) 2 of the 4 experts a rank (einsum dispatch),
    # (1, 4) one a rank (scatter), the composed (1, 2, 2) mesh; 2 experts on
    # a model axis of 4 stay replicated; the MoE DiT under Megatron-SP on 9
    # tokens (tensor: the MoE gathers them; fsdp: the block does)
    "moe_tensor": (MOE_DIT, 8, 2, dict(data=2, model=2, mode="tensor")),
    "moe_tensor_1x4": ([*MOE_DIT, "model.moe_dispatch=scatter"], 8, 2,
                       dict(data=1, model=4, mode="tensor")),
    "moe_composed": (MOE_DIT, 8, 2, dict(data=1, fsdp=2, model=2, mode="tensor")),
    "moe_tensor_replicated": ([*MOE_DIT, "model.moe_experts=2"], 8, 2,
                              dict(data=1, model=4, mode="tensor")),
    "moe_sequence_tensor_9": (MOE_DIT_9, 8, 2, dict(data=2, model=2, mode="tensor",
                                                    sequence=True)),
    "moe_sequence_fsdp_9": (MOE_DIT_9, 8, 2, dict(data=2, model=2, sequence=True)),
}


def mesh_of(device, data: int = -1, model: int = 1, mode: str = "fsdp",
            pairs: bool = False, **kw):
    """The mesh of a case's keywords.  ``pairs``: ranks 0-1 and 2-3 each
    make a two-rank mesh of their own, ``(data 2)`` or ``(data 1, model
    2)``, two meshes at once; every rank creates every pair's groups, in
    the same order.  Else ``make_mesh`` over the four ranks."""
    kw = {k: v for k, v in kw.items() if k not in ("sequence", "microbatches")}
    if not pairs:
        return make_mesh(data, devices=device, model=model, mode=mode, **kw)
    rank = dist.get_rank()
    pair = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
    if model == 1:
        return Mesh(2, rank % 2, torch.device(device), "gloo", pair, mode=mode)
    alone = [dist.new_group([r]) for r in range(dist.get_world_size())][rank]
    groups = {("data",): alone, ("model",): pair, ("data", "model"): pair}
    return Mesh(1, 0, torch.device(device), "gloo", alone, (("data", 1), ("model", model)),
                (("data", 0), ("model", rank % 2)), groups, mode)


def build_on(overrides, device, mesh, mesh_kw):
    """The model of ``overrides`` made ready for ``mesh``: rebuilt for the
    pipeline (``enable_pipeline`` with ``microbatches``) or for sequence
    parallelism (``sequence``), as the trainer does."""
    model = dp.build(overrides, device)
    if mesh.mode == "pipeline":
        model.enable_pipeline(mesh, mesh_kw.get("microbatches", 1))
    if mesh_kw.get("sequence"):
        model.enable_sequence_parallel(mesh)
    return model


def state_bytes(state) -> int:
    """The bytes of every tensor a train state keeps from one step to the
    next: parameters, buffers, optimizer state, the EMA shadow."""
    def walk(obj):
        if isinstance(obj, torch.Tensor):
            return obj.numel() * obj.element_size()
        if isinstance(obj, dict):
            return sum(walk(v) for v in obj.values())
        if isinstance(obj, (list, tuple)):
            return sum(walk(v) for v in obj)
        return 0
    saved = state.state_dict()
    return walk(saved["params"]) + walk(saved["opt_states"])


def _routing(model):
    """Forward hooks that record each Switch-MoE block's router input, as
    the rank saw it: (block key, input rows) per forward."""
    seen = []
    for key, module in model.modules.named_modules():
        if isinstance(module, SwitchMoE):
            module.register_forward_hook(
                lambda mod, args, out, key=key: seen.append((key, args[0].detach().clone())))
    return seen


def perturbed(model, seed: int = 1) -> dict:
    """The modules' state after ``init_state(0)``, every parameter moved by
    0.05 N(0, 1): adaLN-Zero's zero gates would hide the DiT's blocks (and
    the MoE's routing) from a step's loss."""
    model.init_state(0)
    gen = torch.Generator().manual_seed(seed)
    names = {k for k, _ in model.modules.named_parameters()}
    return {k: (v + 0.05 * torch.randn(v.shape, generator=gen).to(v.dtype) if k in names
                else v).detach().clone()
            for k, v in model.modules.state_dict().items()}


def _recorded_updates(model, mesh) -> list:
    """Each update's gradients after the reduction over the ranks, whole
    (a shard's gathered from every rank's), as ``_torch_dp.run`` records
    one process's: (optimizer, parameter names, lr, gradients)."""
    from igm_tpu_torch.parallel.sharding import gather_whole
    names = {id(p): k for k, p in model.modules.named_parameters()}
    opts = model.optimizers
    updates, reduced = [], []
    reduce, apply = opts.reduce_grads, opts._apply

    def recorded_reduce(gs, params=()):
        out = reduce(gs, params)
        reduced.append([(g if getattr(p, "_igm_leaf", None) is None
                         else gather_whole(mesh, p._igm_leaf, g)).detach().clone().cpu()
                        for g, p in zip(out, params)])
        return out

    def recorded_apply(opt_name, opt, params, grads, *args, **kwargs):
        apply(opt_name, opt, params, grads, *args, **kwargs)
        lr = max(float(g["lr"]) for g in opt.param_groups)
        updates.append((opt_name, [names[id(p)] for p in params], lr, reduced.pop()))

    opts.reduce_grads, opts._apply = recorded_reduce, recorded_apply
    return updates


def run(model, batch, steps: int, mesh=None, weights=None, draws=None) -> dict:
    """``steps`` train steps from ``init_state(0)`` (then ``weights``, a
    whole state_dict of the modules, loaded) on ``batch`` (this rank's rows
    of it on a mesh): each step's metrics and updates (the reduced
    gradients, whole), the whole state after (``full_state_dict``), this
    rank's state bytes, parameter shapes and Switch-MoE parameters (a
    shard's), the MoE inputs."""
    model.set_mesh(mesh)
    state = model.init_state(0)
    if weights is not None:
        state.load_state_dict({**state.full_state_dict(), "params": weights})
    bytes_ = state_bytes(state)
    seen = _routing(model)
    updates = _recorded_updates(model, mesh)
    blocks = model.batch_blocks
    if mesh is None:
        local = tuple(torch.from_numpy(a).to(model.device) for a in batch)
    else:
        local = shard_batch(mesh, batch, blocks)
    if draws:
        kw = {k: (torch.from_numpy(v) if mesh is None
                  else shard_batch(mesh, [v], blocks)[0]).to(model.device)
              for k, v in draws.items()}
        model.train_step = functools.partial(type(model).train_step, model, **kw)
    metrics = []
    for _ in range(steps):
        state, m = model.train_step_n(state, tuple(b[None] for b in local), graph=False)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = state.full_state_dict()
    shapes = {k: tuple(p.shape) for k, p in model.modules.named_parameters()}
    experts = {k: p.detach().cpu().clone() for k, p in model.modules.named_parameters()
               if ".moe." in k}
    return {"metrics": metrics, "updates": updates, "step": state.step, "bytes": bytes_,
            "shapes": shapes, "experts": experts,
            "params": {k: v.detach().cpu().clone() for k, v in whole["params"].items()},
            "opt_states": {k: v for k, v in whole["opt_states"].items()},
            "sharded": sorted(leaf.key for leaf in (model.sharding.leaves
                                                     if model.sharding else [])
                              if leaf.sharded),
            "moe_inputs": [(k, x.cpu()) for k, x in seen],
            "jax": "jax" in sys.modules}


def _resume_on_mesh(device, mesh, out: Path, ckpt: Path, case: str = "tensor_dit",
                    suffix: str = "") -> None:
    """A one-process checkpoint of ``case``'s model (rank 0 writes it)
    restored on ``mesh``, and a one-process state restored from it placed
    there by ``shard_state``: the whole states gathered back, saved (their
    names ending in ``suffix``)."""
    from igm_tpu_torch.core.checkpoint import CheckpointManager
    from igm_tpu_torch.parallel import shard_state
    from igm_tpu_torch.parallel.mesh import barrier
    overrides, n, _, _ = CASES[case]
    batch = dp.make_batch(dp.build(overrides), n, 7)
    manager = CheckpointManager(str(ckpt))
    if torch.distributed.get_rank() == 0:
        one = dp.build(overrides, device)
        state = one.init_state(0)
        state, _ = one.train_step_n(state, tuple(torch.from_numpy(a)[None] for a in batch),
                                    graph=False)
        manager.save(state.step, state)
        manager.wait()
    barrier(mesh)
    model = dp.build(overrides, device)
    model.set_mesh(mesh)
    restored = manager.restore(model.init_state(0))
    one = dp.build(overrides, device)
    placed = shard_state(one, mesh, manager.restore(one.init_state(0)))
    for name, state in (("resume_on_mesh", restored), ("shard_state", placed)):
        whole = state.full_state_dict()
        torch.save({"params": {k: v.cpu() for k, v in whole["params"].items()},
                    "opt_states": whole["opt_states"], "step": state.step,
                    "shapes": {k: tuple(p.shape) for k, p in model.modules.named_parameters()}},
                   out / f"{name}{suffix}.rank{torch.distributed.get_rank()}.pt")


def rank_main(device, jobs, samples, fits, out_dir: str, later: str) -> None:
    """One spawned rank: each job ``(name, overrides, batch, steps, mesh
    keywords, weights, draws)`` run on its mesh, the record saved as
    ``<out_dir>/<name>.rank<r>.pt``; each sample job ``(name, overrides, n,
    sampler, mesh keywords)`` through ``sample_sharded`` from generator
    seed 0 (on a model axis from the state ``init_state(0)`` shards); a
    one-process checkpoint restored on the (2, 2) tensor mesh, of the DiT
    and of the MoE DiT (its experts sharded);
    each of ``fits`` (CLI overrides) through the training CLI's rank entry;
    then the jobs the parent writes to the file ``later`` meanwhile."""
    from igm_tpu_torch import cli
    from igm_tpu_torch.parallel.launch import TIMEOUT_S
    from igm_tpu_torch.parallel.mesh import sample_sharded
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    out = Path(out_dir)

    def run_jobs(jobs):
        for name, overrides, batch, steps, mesh_kw, weights, draws in jobs:
            mesh = mesh_of(device, **mesh_kw)
            record = run(build_on(overrides, device, mesh, mesh_kw), batch, steps, mesh,
                         weights, draws)
            torch.save(record, out / f"{name}.rank{rank}.pt")

    run_jobs(jobs)
    for name, overrides, n, sampler, mesh_kw in samples:
        mesh = mesh_of(device, **mesh_kw)
        model = dp.build(overrides, device)
        if mesh.sharded:      # the state born sharded (the same seed-0 draw)
            model.set_mesh(mesh)
            model.init_state(0)
        gen = torch.Generator(device=device).manual_seed(0)
        imgs = sample_sharded(model, mesh, None, gen, n, sampler=sampler)
        torch.save({"imgs": imgs.cpu(), "jax": "jax" in sys.modules},
                   out / f"{name}.rank{rank}.pt")
    tensor = make_mesh(devices=device, data=2, model=2, mode="tensor")
    _resume_on_mesh(device, tensor, out, out / "one_process_ckpt")
    _resume_on_mesh(device, tensor, out, out / "one_process_moe_ckpt", "moe_tensor", "_moe")
    for overrides in fits:
        cli._rank_run(device, overrides)
    deadline = time.monotonic() + TIMEOUT_S
    while not Path(later).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{later} never came")
        time.sleep(0.05)
    run_jobs(torch.load(later, weights_only=False))


def composed_rank(device, out_dir: str, batch, weights) -> None:
    """One of eight ranks of the composed (2, 2, 2) tensor mesh: two steps
    of the tiny DiT from ``weights``, the record saved as
    ``<out_dir>/rank<r>.pt``."""
    torch.set_num_threads(1)
    mesh = make_mesh(devices=device, data=2, fsdp=2, model=2, mode="tensor")
    record = run(dp.build(DIT, device), batch, 2, mesh, weights)
    torch.save(record, Path(out_dir) / f"rank{torch.distributed.get_rank()}.pt")
