"""Parallelism: counterpart of ``igm_tpu/parallel``.

The mesh (``mesh.py``): one process per card over ``torch.distributed``,
laid out as ``igm_tpu``'s ``(data)``, ``(data, model)`` or ``(data, fsdp,
model)`` mesh, each rank training on its rows of the global batch, with
train steps that equal the one-process step on the whole batch.  The
model axis shards the train state (``sharding.py``: FSDP, ZeRO-3) and, in
``tensor`` mode, the DiT blocks' layers (``tensor.py``: Megatron); the
Switch-MoE routes over the global batch.  ``launch.py`` starts the ranks
(``trainer.devices=N``, or ``torchrun`` with ``IGM_MULTIHOST=1``).
Sequence and pipeline parallelism (slice 7c) and expert parallelism
(slice 7d's expert half) are not ported: asking for them raises
``NotImplementedError`` naming the ROADMAP slice that will bring them.
"""
from .mesh import (DATA_AXIS, FSDP_AXIS, FSDP_MIN_SIZE, MODEL_AXIS, Mesh, make_mesh,
                   pad_to_multiple, replicate, sample_sharded, shard_batch)
from .sharding import init_state_sharded, shard_state, state_shardings

__all__ = ["DATA_AXIS", "FSDP_AXIS", "FSDP_MIN_SIZE", "MODEL_AXIS", "Mesh", "make_mesh",
           "pad_to_multiple", "replicate", "sample_sharded", "shard_batch",
           "init_state_sharded", "shard_state", "state_shardings"]
