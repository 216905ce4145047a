"""TrainState: what a training run carries from one step to the next.

Counterpart of ``igm_tpu/core/state.py``.  JAX threads one immutable pytree
through a jitted step; here the parameters stay in the model's modules and
are updated in place, and the state holds the rest:

- ``step``: the global step counter;
- ``opt_states``: per optimizer name, the ``torch.optim`` optimizer over
  that optimizer's modules; under ``"ema"`` (models with an EMA shadow) a
  dict of the shadow's tensors by parameter name, as ``igm_tpu`` carries
  the shadow in ``opt_states`` so that checkpoints include it;
- ``generator``: one ``torch.Generator`` on the model's device, from which
  every training draw is made (the counterpart of the threaded PRNG key).

``state_dict``/``load_state_dict`` give and take all of it, the modules'
parameters included; loading writes into the existing tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    modules: nn.ModuleDict
    opt_states: Dict[str, Any]
    generator: torch.Generator
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        """Live references, not copies: a checkpoint copies what it keeps."""
        return {
            "step": self.step,
            "params": self.modules.state_dict(),
            "opt_states": {name: (opt.state_dict() if hasattr(opt, "state_dict")
                                  else dict(opt))
                           for name, opt in self.opt_states.items()},
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, saved: Dict[str, Any]) -> None:
        if set(saved["opt_states"]) != set(self.opt_states):
            raise ValueError(f"checkpoint holds optimizers {sorted(saved['opt_states'])}, "
                             f"the state {sorted(self.opt_states)}")
        self.modules.load_state_dict(saved["params"], strict=True)
        for name, value in saved["opt_states"].items():
            current = self.opt_states[name]
            if hasattr(current, "load_state_dict"):
                current.load_state_dict(value)
            else:
                if set(value) != set(current):
                    raise ValueError(f"checkpoint's {name!r} tensors do not match the state's")
                with torch.no_grad():
                    for key, tensor in value.items():
                        current[key].copy_(tensor)
        self.generator.set_state(saved["generator"])
        self.step = int(saved["step"])
