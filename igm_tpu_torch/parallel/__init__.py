"""Parallelism: counterpart of ``igm_tpu/parallel``.

The data axis (``mesh.py``): one process per card over
``torch.distributed``, each rank training on its rows of the global batch,
with train steps that equal the one-process step on the whole batch.
``launch.py`` starts the ranks (``trainer.devices=N``, or ``torchrun`` with
``IGM_MULTIHOST=1``).  The model axes (FSDP, tensor, sequence and pipeline
parallelism, expert parallelism) are not ported: asking for them raises
``NotImplementedError`` naming the ROADMAP slice that will bring them.
"""
from .mesh import (DATA_AXIS, FSDP_AXIS, MODEL_AXIS, Mesh, make_mesh, pad_to_multiple,
                   replicate, sample_sharded, shard_batch)

__all__ = ["DATA_AXIS", "FSDP_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "pad_to_multiple",
           "replicate", "sample_sharded", "shard_batch"]
