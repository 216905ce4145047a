"""The model axis's sharding specs in one process, against igm_tpu's.

For each tree (vae/mnist_mlp, the flagship UNet at a tiny width,
tests/test_parallel.py's _tiny_dit_ddpm, and that DiT with a Switch-MoE
every 2nd block), under ``mode=fsdp`` and ``mode=tensor`` on the (data 4,
model 2) mesh and on the composed (2, 2, 2) mesh: the port's spec of every
parameter and buffer, stated on its Flax leaf (``interop.flax_layout``),
is igm_tpu's ``state_shardings`` spec of that leaf, of its Adam moments
and of its EMA shadow (``jax.eval_shape`` of the same model: nothing is
compiled); and the shards of a leaf over the mesh hold each element once,
the elements igm_tpu's shard on that device holds (found through
``interop.flax_to_torch``, which converts a Flax tree without the layout
map).  Then test_parallel.py's three spec tests, mirrored.
"""
import itertools
import sys
from pathlib import Path

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _torch_dp as dp  # noqa: E402
import _torch_mp as mp  # noqa: E402
from igm_tpu.config import compose as igm_compose  # noqa: E402
from igm_tpu.config.instantiate import instantiate as igm_instantiate  # noqa: E402
from igm_tpu.parallel import mesh as igm_mesh  # noqa: E402
from igm_tpu_torch.interop import flax_key_to_torch, flax_to_torch  # noqa: E402
from igm_tpu_torch.parallel.mesh import (FSDP_MIN_SIZE, Mesh, _fsdp_spec,  # noqa: E402
                                         make_mesh)
from igm_tpu_torch.parallel.sharding import module_leaves, state_shardings  # noqa: E402

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
CPU = torch.device("cpu")
TREES = {
    "vae_mnist_mlp": ["experiment=vae/mnist_mlp"],
    "flagship": mp.FLAGSHIP,
    "dit": [*mp.DIT, "model.ema_decay=0.999"],
    "moe_dit": mp.MOE_DIT,
}
# (mode, igm_tpu make_mesh keywords)
MESHES = {"fsdp": ("fsdp", dict(model=2)), "tensor": ("tensor", dict(model=2)),
          "composed": ("tensor", dict(data=2, fsdp=2, model=2)),
          "composed_fsdp": ("fsdp", dict(data=2, fsdp=2, model=2))}


def _port_mesh(igm, mode: str, coords=None) -> Mesh:
    """The port's mesh of igm_tpu's shape, no process group (specs only)."""
    axes = tuple((name, int(size)) for name, size in igm.shape.items())
    coords = coords or {name: 0 for name, _ in axes}
    world = igm.shape["data"] * igm.shape.get("fsdp", 1)
    return Mesh(world, 0, CPU, axes=axes, coords=tuple(coords.items()), mode=mode)


def _names(path) -> list:
    return [str(getattr(k, "key", getattr(k, "name", k))) for k in path
            if not isinstance(k, jtu.SequenceKey)]


def _torch_key(names, modules) -> tuple:
    """(what, torch state_dict key) of an igm_tpu state leaf: a parameter,
    a BatchNorm statistic, an Adam moment or the EMA shadow."""
    if names[0] == "params":
        return "param", flax_key_to_torch("/".join(names[1:]))
    if names[0] == "mutables" and names[2] == "moe":
        return "sown", None            # the MoE's aux and load: the port returns them
    if names[0] == "mutables":
        return "buffer", ".".join(n for n in names[1:] if n != "batch_stats")
    if names[0] == "opt_states" and names[1] == "ema":
        rest = names[2:] if names[2] in modules else ["denoise", *names[2:]]
        return "ema", flax_key_to_torch("/".join(rest))
    for moment in ("mu", "nu"):
        if moment in names:
            return moment, flax_key_to_torch("/".join(names[names.index(moment) + 1:]))
    return "scalar", None


@pytest.fixture(scope="module")
def trees():
    """Per tree: the port's model (CPU) and igm_tpu's state shapes."""
    out = {}
    for name, overrides in TREES.items():
        cfg = igm_compose(CONFIGS, [*overrides, "print_config=False"])
        jm = igm_instantiate(cfg.model, datamodule=cfg.datamodule)
        jm.steps_per_epoch = 10
        shapes = jax.eval_shape(jm.init_state, jax.random.PRNGKey(0))
        out[name] = (dp.build(overrides), shapes)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("tree", list(TREES))
def test_specs_match_igm_tpu(trees, tree, mesh_name):
    model, shapes = trees[tree]
    mode, kw = MESHES[mesh_name]
    igm = igm_mesh.make_mesh(**kw)
    want = igm_mesh.state_shardings(igm, shapes, mode=mode)
    port = state_shardings(model.modules, _port_mesh(igm, mode))
    seen = set()
    sharded = 0
    for path, sharding in jtu.tree_leaves_with_path(want):
        what, key = _torch_key(_names(path), model.modules)
        spec = tuple(sharding.spec)
        if key is None:                 # step, rng, Adam's count, the MoE's sown stats
            assert spec == (), (path, spec)
            continue
        assert key in port, (tree, what, key)
        assert port[key] == spec, (tree, mesh_name, what, key, port[key], spec)
        seen.add(key)
        sharded += bool(spec)
    assert seen == set(port), sorted(set(port) - seen)
    assert sharded


@pytest.mark.parametrize("mesh_name", ["fsdp", "tensor", "composed"])
@pytest.mark.parametrize("tree", list(TREES))
def test_shards_hold_igm_tpus_elements_once(trees, tree, mesh_name):
    """Every sharded parameter, in igm_tpu's Flax layout with each element
    its own index, converted by interop.flax_to_torch: the shards over
    every device of the mesh hold each index once, and the shard of each
    device the indices igm_tpu's shard there holds."""
    model, _ = trees[tree]
    mode, kw = MESHES[mesh_name]
    igm = igm_mesh.make_mesh(**kw)
    axes = list(igm.shape.items())
    leaves = [leaf for leaf in module_leaves(model.modules, _port_mesh(igm, mode))
              if leaf.sharded and not leaf.buffer]
    assert leaves
    for leaf in leaves:
        flax_shape = leaf.layout.flax_shape(leaf.shape)
        index = np.arange(int(np.prod(flax_shape)), dtype=np.float32).reshape(flax_shape)
        path = _flax_path(leaf.key, model)
        converted = flax_to_torch({path: index})[leaf.key]
        assert tuple(converted.shape) == tuple(leaf.shape), leaf.key
        held = []
        for coords in itertools.product(*[range(s) for _, s in axes]):
            coords = dict(zip([a for a, _ in axes], coords))
            mine = leaf.shard_of(converted, _port_mesh(igm, mode, coords))
            want = index[tuple(slice(coords[a] * (d // igm.shape[a]),
                                     (coords[a] + 1) * (d // igm.shape[a]))
                               if a is not None else slice(None)
                               for a, d in zip(leaf.spec, flax_shape))]
            assert np.array_equal(np.sort(mine.numpy().reshape(-1)),
                                  np.sort(want.reshape(-1))), (leaf.key, coords)
            held.append(mine.reshape(-1))
        replicas = int(np.prod([s for a, s in axes if a not in leaf.spec]))
        counts = np.bincount(torch.cat(held).long().numpy(), minlength=index.size)
        assert np.all(counts == replicas), leaf.key


def _flax_path(key: str, model) -> str:
    """The igm_tpu path of a torch key (the wrapper level of a wrapped
    Conv/Dense/ConvTranspose put back)."""
    from igm_tpu_torch.interop import _WRAPPED, _kind
    parts = key.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    owner = model.modules.get_submodule(".".join(key.split(".")[:-1]))
    if (len(parts) >= 2 and _kind(parts[-2]) in _WRAPPED
            and type(owner).__name__ in ("Conv", "Dense", "ConvTranspose")):
        parts.insert(-1, f"{_kind(parts[-2])}_0")
    return "/".join(parts)


def test_fsdp_spec_shards_largest_divisible_axis():
    """test_parallel.py's, on the port's mesh."""
    mesh = _port_mesh(igm_mesh.make_mesh(model=2), "fsdp")
    assert mesh.shape == {"data": 4, "model": 2}
    assert _fsdp_spec(mesh, (3, 3, 64, 128)) == (None, None, None, "model")
    assert _fsdp_spec(mesh, (64,)) == ()
    assert _fsdp_spec(mesh, (7, 11) * 4) == ()
    assert _fsdp_spec(mesh, (64, 32)) == ("model", None) and 64 * 32 >= FSDP_MIN_SIZE


def test_tp_specs_on_dit_tree(trees):
    """test_parallel.py's: Megatron specs on the DiT block matrices, row
    biases replicated, non-block leaves never a Megatron spec."""
    model, _ = trees["dit"]
    specs = state_shardings(model.modules, _port_mesh(igm_mesh.make_mesh(model=2), "tensor"))
    assert specs["denoise.DiTBlock_0.qkv.weight"] == (None, "model")
    assert specs["denoise.DiTBlock_0.qkv.bias"] == ("model",)
    assert specs["denoise.DiTBlock_0.proj.weight"] == ("model", None)
    assert specs["denoise.DiTBlock_0.proj.bias"] == ()
    assert specs["denoise.DiTBlock_0.Dense_0.weight"] == (None, "model")
    assert specs["denoise.DiTBlock_1.Dense_1.weight"] == ("model", None)
    assert specs["denoise.DiTBlock_0._Modulation_0.Dense_0.weight"] == (None, "model")
    assert "model" not in specs["denoise.patch_embed.bias"]


def test_composed_mesh_specs(trees):
    """test_parallel.py's: on (2, 2, 2) the TP dims keep ``model``, the
    other kernel dim shards over ``fsdp``, and the batch axes are data x
    fsdp."""
    model, _ = trees["dit"]
    igm = igm_mesh.make_mesh(data=2, model=2, fsdp=2)
    mesh = _port_mesh(igm, "tensor")
    assert mesh.axis_names == tuple(igm.axis_names) == ("data", "fsdp", "model")
    assert mesh.world == 4                     # the batch shards over data x fsdp
    specs = state_shardings(model.modules, mesh)
    assert specs["denoise.DiTBlock_0.qkv.weight"] == ("fsdp", "model")
    assert specs["denoise.DiTBlock_0.Dense_0.weight"] == ("fsdp", "model")
    assert specs["denoise.DiTBlock_0.Dense_1.weight"] == ("model", "fsdp")
    assert specs["denoise.DiTBlock_0.proj.weight"] == ("model", None)


@pytest.mark.parametrize("kw,match", [(dict(model=2), "model axis 2 does not divide 1"),
                                      (dict(fsdp=2), "fsdp axis requires a model axis"),
                                      (dict(model=2, fsdp=2), "fsdp\\*model 2\\*2 does not"),
                                      (dict(model=3, data=1), "model axis 3 does not divide")])
def test_make_mesh_raises_igm_tpus_errors(kw, match):
    """Without a process group (one rank) a model axis does not divide the
    ranks: igm_tpu's ValueError, as make_mesh raises it on one device."""
    with pytest.raises(ValueError, match=match):
        igm_mesh.make_mesh(devices=jax.devices()[:1], **kw)
    with pytest.raises(ValueError, match=match):
        make_mesh(devices="cpu", **kw)


def test_count_params_counts_a_shards_whole_parameter():
    """The training CLI's ``trained params`` on a model axis: each rank's
    shard counts its whole parameter, as one process counts it."""
    from igm_tpu_torch.parallel.sharding import shard_modules
    from igm_tpu_torch.utils.utils import count_params
    model = dp.build(mp.FLAGSHIP)
    want = count_params(model.modules)
    mesh = Mesh(1, 0, CPU, axes=(("data", 1), ("model", 2)), coords=(("data", 0), ("model", 1)))
    sharding = shard_modules(model, mesh)
    assert sum(p.numel() for p in model.modules.parameters()) < want
    assert count_params(model.modules) == want
    sharding.remove()
