"""Checkpoints of the whole TrainState, with ``torch.save``.

Counterpart of ``igm_tpu/core/checkpoint.py``.  A checkpoint holds {step,
params, opt_states (the EMA shadow included), generator state}, so a resumed
run continues the step counter and the random stream exactly.  Files are
``<directory>/step_<step>.pt``; the newest ``max_to_keep`` are kept.

``save`` copies the state to host memory before it returns, then writes the
file in a background thread (as orbax writes asynchronously); ``wait``
joins that thread and raises what it raised.  A file is written under a
temporary name and renamed, so a cut run leaves no half-written checkpoint.

``restore_raw`` reads a checkpoint without a state to load it into, as
``igm_tpu``'s does: LatentDDPM splices a VQ-VAE's first stage from it.

An orbax checkpoint of ``igm_tpu`` needs JAX to read: the converter
``tools/igm_tpu_ckpt_to_npz.py`` (run beside ``igm_tpu``) writes one
``.npz`` of its params, mutable collections, EMA shadow and step, keyed by
``/``-joined paths under a format tag.  :func:`read_checkpoint` reads that
file with numpy alone (through ``interop``) wherever the port reads a
checkpoint directory: the CLIs' ``--ckpt``, ``model.first_stage_ckpt`` and
``model.teacher_ckpt``.  A converted file carries no optimizer state or
generator: it serves sampling and splicing, not resuming a run.
"""
from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

from .state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")
# the format tag tools/igm_tpu_ckpt_to_npz.py writes
CONVERTED_FORMAT = "igm_tpu-checkpoint-npz/1"
NOT_RESUMABLE = ("{path} is a converted igm_tpu checkpoint: it carries no optimizer "
                 "state, so it serves sampling and splicing (--ckpt, "
                 "model.first_stage_ckpt, model.teacher_ckpt), not resuming a run")


def _to_host(obj: Any) -> Any:
    """A copy of obj with every tensor copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = Path(directory).resolve()
        self.max_to_keep = int(max_to_keep)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{int(step)}.pt"

    def steps(self) -> List[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """``state``: a TrainState, or a ``state_dict`` of one (the whole
        state a sharded run gathered)."""
        self.wait()
        snapshot = _to_host(state.state_dict() if isinstance(state, TrainState) else state)
        self._thread = threading.Thread(target=self._write, args=(int(step), snapshot),
                                        daemon=True)
        self._thread.start()

    def _write(self, step: int, snapshot: dict) -> None:
        try:
            self.directory.mkdir(parents=True, exist_ok=True)
            path = self._path(step)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save(snapshot, tmp)
            os.replace(tmp, path)
            for old in self.steps()[:-self.max_to_keep]:
                self._path(old).unlink(missing_ok=True)
        except BaseException as exc:  # re-raised by wait()
            self._error = exc

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write to {self.directory} failed") from err

    def restore_raw(self, step: Optional[int] = None) -> dict:
        """Checkpoint ``step`` (default: the newest) as it was saved, on
        the CPU: {step, params (the modules' parameters and buffers by
        state_dict key), opt_states, generator}."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            hint = ""
            if self.directory.is_dir() and any(p.name.isdigit()
                                               for p in self.directory.iterdir()):
                hint = (" (step_<N>.pt); this looks like an orbax checkpoint directory "
                        "of igm_tpu: convert it first with python "
                        f"tools/igm_tpu_ckpt_to_npz.py {self.directory} <out>.npz")
            raise FileNotFoundError(f"no checkpoint of the port in {self.directory}{hint}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load checkpoint ``step`` (default: the newest) into ``state``."""
        state.load_state_dict(self.restore_raw(step))
        return state


def is_converted(path: str | os.PathLike) -> bool:
    """Whether ``path`` names a converted ``igm_tpu`` checkpoint (an .npz)."""
    return str(path).endswith(".npz")


def read_converted(path: str | os.PathLike) -> dict:
    """A converted ``igm_tpu`` checkpoint as :meth:`CheckpointManager.restore_raw`
    gives the port's: {step, params (the modules' parameters and buffers by
    state_dict key), opt_states ({"ema": shadow} where it has one, else
    {})}, plus ``converted: True``; no optimizer state, no generator."""
    from ..interop import flax_mutables_to_torch, flax_to_torch

    with np.load(path) as npz:
        tag = str(npz["format"]) if "format" in npz.files else None
        if tag != CONVERTED_FORMAT:
            raise ValueError(f"{path}: not a converted igm_tpu checkpoint (format "
                             f"{tag!r}, expected {CONVERTED_FORMAT!r}); write one with "
                             "tools/igm_tpu_ckpt_to_npz.py")
        groups: dict[str, dict[str, np.ndarray]] = {"params": {}, "mutables": {}, "ema": {}}
        for key in npz.files:
            head, _, rest = key.partition("/")
            if head in groups:
                groups[head][rest] = npz[key]
        step = int(npz["step"])
    params = {**flax_to_torch(groups["params"]), **flax_mutables_to_torch(groups["mutables"])}
    ema = flax_to_torch(groups["ema"]) if groups["ema"] else None
    return {"step": step, "params": params,
            "opt_states": {"ema": ema} if ema is not None else {}, "converted": True}


def read_checkpoint(path: str | os.PathLike) -> dict:
    """The newest of the port's checkpoints in directory ``path``, or the
    converted ``igm_tpu`` checkpoint ``path`` names (:func:`read_converted`),
    on the CPU."""
    if is_converted(path):
        return read_converted(path)
    return CheckpointManager(str(path)).restore_raw()


def load_converted(state: TrainState, saved: dict) -> None:
    """Load a converted checkpoint into ``state``: every module, the EMA
    shadow where both have one, and the step; the optimizers keep their
    fresh state."""
    state.modules.load_state_dict(saved["params"], strict=True)
    ema, have = saved["opt_states"].get("ema"), state.opt_states.get("ema")
    if (ema is None) != (have is None):
        raise ValueError(f"the checkpoint {'has' if ema is not None else 'has no'} EMA "
                         f"shadow, the model {'keeps' if have is not None else 'keeps no'} "
                         "one (model.ema_decay)")
    if ema is not None:
        if set(ema) != set(have):
            raise ValueError("the checkpoint's EMA shadow does not match the model's "
                             "parameters")
        with torch.no_grad():
            for key, tensor in ema.items():
                have[key].copy_(tensor)
    state.step = int(saved["step"])
