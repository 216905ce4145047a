"""Hyperparameter sweeps: the port's own copy of ``igm_tpu/sweep``
(numpy only): ``space`` (the override grammar), ``tpe`` (the TPE study),
``launcher`` (inline and worker-process jobs).  Wired into
``python -m igm_tpu_torch.train -m``.
"""
from .launcher import Job, JobResult, launch, read_result, write_result  # noqa: F401
from .space import Dist, dist_from_config, format_value, parse_override  # noqa: F401
from .tpe import Study, Trial  # noqa: F401
