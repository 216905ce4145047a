"""Parallelism: counterpart of ``igm_tpu/parallel``.

The mesh (``mesh.py``): one process per card over ``torch.distributed``,
laid out as ``igm_tpu``'s ``(data)``, ``(data, model)`` or ``(data, fsdp,
model)`` mesh, each rank training on its rows of the global batch, with
train steps that equal the one-process step on the whole batch.  The
model axis shards the train state (``sharding.py``: FSDP, ZeRO-3) and, in
``tensor`` mode, the DiT blocks' layers (``tensor.py``: Megatron); the
Switch-MoE routes over the global batch.  ``tensor.py`` also splits the
DiT's tokens over the model group between its GEMMs (Megatron-SP,
``mesh.sequence``).  ``pipeline.py`` lays the DiT's blocks out over the
``stage`` axis of a ``(data, stage)`` mesh and runs them GPipe's way
(``mesh.mode=pipeline``).  ``launch.py`` starts the ranks
(``trainer.devices=N``, or ``torchrun`` with ``IGM_MULTIHOST=1``).
Expert parallelism (slice 7d's expert half) is not ported: asking for it
raises ``NotImplementedError`` naming the ROADMAP slice that will bring
it.
"""
from .mesh import (DATA_AXIS, FSDP_AXIS, FSDP_MIN_SIZE, MODEL_AXIS, STAGE_AXIS, Mesh,
                   make_mesh, pad_to_multiple, replicate, sample_sharded, shard_batch)
from .pipeline import make_pipeline_mesh
from .sharding import init_state_sharded, shard_state, state_shardings

__all__ = ["DATA_AXIS", "FSDP_AXIS", "FSDP_MIN_SIZE", "MODEL_AXIS", "STAGE_AXIS", "Mesh",
           "make_mesh", "make_pipeline_mesh",
           "pad_to_multiple", "replicate", "sample_sharded", "shard_batch",
           "init_state_sharded", "shard_state", "state_shardings"]
