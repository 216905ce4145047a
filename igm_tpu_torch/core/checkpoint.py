"""Checkpoints of the whole TrainState, with ``torch.save``.

Counterpart of ``igm_tpu/core/checkpoint.py``.  A checkpoint holds {step,
params, opt_states (the EMA shadow included), generator state}, so a resumed
run continues the step counter and the random stream exactly.  Files are
``<directory>/step_<step>.pt``; the newest ``max_to_keep`` are kept.

``save`` copies the state to host memory before it returns, then writes the
file in a background thread (as orbax writes asynchronously); ``wait``
joins that thread and raises what it raised.  A file is written under a
temporary name and renamed, so a cut run leaves no half-written checkpoint.

This reads only the port's own files: orbax checkpoints of ``igm_tpu``
need JAX to read.
"""
from __future__ import annotations

import os
import re
import threading
from pathlib import Path
from typing import Any, List, Optional

import torch

from .state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


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
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{int(step)}.pt"

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        self.wait()
        snapshot = _to_host(state.state_dict())
        self._thread = threading.Thread(target=self._write, args=(int(step), snapshot),
                                        daemon=True)
        self._thread.start()

    def _write(self, step: int, snapshot: dict) -> None:
        try:
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

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load checkpoint ``step`` (default: the newest) into ``state``."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        saved = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.load_state_dict(saved)
        return state
