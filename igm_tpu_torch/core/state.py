"""TrainState: what a training run carries from one step to the next.

Counterpart of ``igm_tpu/core/state.py``.  JAX threads one immutable pytree
through a jitted step; here the parameters stay in the model's modules and
are updated in place, and the state holds the rest:

- ``step``: the global step counter (on the host);
- ``counts``: per optimizer name, the updates it has applied (on the
  host), the count its learning-rate schedule follows, as optax counts in
  each optimizer's own state: a model may update an optimizer on some
  steps only (the GANs' alternating phases) or twice a step (AAE);
- ``opt_states``: per optimizer name, the ``torch.optim`` optimizer over
  that optimizer's modules; under ``"ema"`` (models with an EMA shadow) a
  dict of the shadow's tensors by parameter name, as ``igm_tpu`` carries
  the shadow in ``opt_states`` so that checkpoints include it;
- ``generator``: one ``torch.Generator`` on the model's device, from which
  every training draw is made (the counterpart of the threaded PRNG key);
- ``graphs``: the captured train steps (``core.graphs.StepGraph``) by
  signature, valid while the tensors they were captured on are.  Not saved.

``state_dict``/``load_state_dict`` give and take all but the graphs, the
modules' parameters included.  Loading writes into the existing tensors
where it can (parameters, buffers, the EMA shadow, optimizer state of the
same layout), so captured graphs stay valid; where an optimizer's state is
built anew (a fresh state, or another layout) the graphs are dropped, to be
captured again on the new tensors.  ``counts`` is not saved: loading reads
it back from each optimizer's own step count.  ``snapshot`` is a copy of
``state_dict`` that a later ``load_state_dict`` returns to.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import nn


def _params(opt: torch.optim.Optimizer):
    return [p for group in opt.param_groups for p in group["params"]]


def load_optimizer_state(opt: torch.optim.Optimizer, saved: Dict[str, Any]) -> bool:
    """Load ``saved`` (an ``opt.state_dict()``, from this device or another,
    capturable or not, e.g. a checkpoint with a CPU step count) into
    ``opt``, keeping ``opt``'s own learning-rate object and ``capturable``
    setting.  Where ``opt`` already holds state of the same layout for every
    parameter, the values are copied into its tensors in place, so a graph
    captured on them stays valid, and this returns True; otherwise
    ``Optimizer.load_state_dict`` builds new tensors (copies of ``saved``'s)
    and this returns False."""
    params = _params(opt)
    ids = [i for group in saved["param_groups"] for i in group["params"]]
    if len(ids) != len(params):
        raise ValueError(f"optimizer state for {len(ids)} parameters, the optimizer "
                         f"has {len(params)}")
    have = [opt.state.get(p, {}) for p in params]
    want = [saved["state"].get(i, {}) for i in ids]
    in_place = all(h and set(h) == set(w) and all(h[key].shape == w[key].shape
                                                  for key in h)
                   for h, w in zip(have, want))
    kept = [(group["lr"], group.get("capturable", False)) for group in opt.param_groups]
    if in_place:
        with torch.no_grad():
            for h, w in zip(have, want):
                for key, tensor in h.items():
                    tensor.copy_(w[key])
        for group, new in zip(opt.param_groups, saved["param_groups"]):
            group.update({k: v for k, v in new.items() if k != "params"})
    else:
        saved = {"state": {i: {key: t.clone() for key, t in st.items()}
                           for i, st in saved["state"].items()},
                 "param_groups": saved["param_groups"]}
        opt.load_state_dict(saved)
    for group, (lr, capturable) in zip(opt.param_groups, kept):
        value = group["lr"]
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(value))
            group["lr"] = lr
        else:
            group["lr"] = float(value)
        group["capturable"] = capturable
        if capturable:
            for p in group["params"]:
                st = opt.state.get(p)
                if st and "step" in st and st["step"].device != p.device:
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
    return in_place


def update_count(opt: torch.optim.Optimizer) -> int:
    """The updates ``opt`` has applied: its state's ``step`` (every
    parameter has the same), 0 before the first."""
    for p in _params(opt):
        st = opt.state.get(p)
        if st and "step" in st:
            return int(st["step"])
    return 0


def _clone(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


@dataclasses.dataclass
class TrainState:
    modules: nn.ModuleDict
    opt_states: Dict[str, Any]
    generator: torch.Generator
    step: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    graphs: Dict[Any, Any] = dataclasses.field(default_factory=dict, repr=False,
                                               compare=False)

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

    def snapshot(self) -> Dict[str, Any]:
        """A copy of :meth:`state_dict` on the same devices."""
        return _clone(self.state_dict())

    def load_state_dict(self, saved: Dict[str, Any]) -> None:
        if set(saved["opt_states"]) != set(self.opt_states):
            raise ValueError(f"checkpoint holds optimizers {sorted(saved['opt_states'])}, "
                             f"the state {sorted(self.opt_states)}")
        self.modules.load_state_dict(saved["params"], strict=True)
        for name, value in saved["opt_states"].items():
            current = self.opt_states[name]
            if hasattr(current, "load_state_dict"):
                if not load_optimizer_state(current, value):
                    self.graphs.clear()
            else:
                if set(value) != set(current):
                    raise ValueError(f"checkpoint's {name!r} tensors do not match the state's")
                with torch.no_grad():
                    for key, tensor in value.items():
                        current[key].copy_(tensor)
        self.generator.set_state(saved["generator"])
        self.step = int(saved["step"])
        self.counts = {name: update_count(opt) for name, opt in self.opt_states.items()
                       if isinstance(opt, torch.optim.Optimizer)}
