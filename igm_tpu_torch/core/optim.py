"""Optimizers, learning-rate schedules and named partial updates.

Counterpart of ``igm_tpu/core/optim.py``'s ``adam``, ``step_lr``,
``halving_lr`` and ``OptimizerSet``.  An optimizer is described by a small
spec (:class:`Adam`) that creates a ``torch.optim`` optimizer over a set of
parameters; :class:`OptimizerSet` names specs over module-name subsets, as
the JAX package's optax transforms are named, and takes one gradient step
on a subset at a time.

On a CUDA device the Adam is ``torch.optim.Adam(capturable=True)``, so that
a CUDA graph can capture its step (``igm_tpu_torch.core.graphs``): its step
count lives on the device and its learning rate is a device tensor.  A
schedule is evaluated on the host from the train state's step and written
into that tensor before the step (``fill_``); inside a capture the step
instead copies its value from a slot of a device vector that the host fills
before each launch (:meth:`OptimizerSet.capture_lr_slots`).  The eager CUDA
step is the same capturable arithmetic.  On the CPU, where ``capturable``
is refused, it is the plain ``torch.optim.Adam`` with a float learning rate.

Not ported yet (they wait for the GAN and MADE slices): ``rmsprop``,
``grouped_adam``, ``clip_params`` and the stochastic-rounding helpers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .state import TrainState, _params

Schedule = Callable[[int], float]


# ------------------------------------------------------------------ schedules
def step_lr(base_lr: float, gamma: float, steps_per_epoch: int) -> Schedule:
    """torch StepLR(step_size=1 epoch, gamma): the learning rate after
    ``count`` updates."""
    spe = max(int(steps_per_epoch), 1)

    def schedule(count: int) -> float:
        return base_lr * (gamma ** (count // spe))

    return schedule


def halving_lr(base_lr: float, drop_lr_epoch: int, steps_per_epoch: int) -> Schedule:
    """torch LambdaLR(0.5 ** (epoch // drop_lr_epoch))."""
    spe = max(int(steps_per_epoch), 1)

    def schedule(count: int) -> float:
        return base_lr * (0.5 ** ((count // spe) // max(int(drop_lr_epoch), 1)))

    return schedule


# ----------------------------------------------------------------- optimizers
@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam``: eps = 1e-8 added to sqrt of the bias-corrected second
    moment, the placement ``torch.optim.Adam`` also uses, which runs it.
    ``lr`` is a float or a schedule of the update count (the count of
    updates already applied, as optax counts)."""
    lr: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def create(self, params: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
        params = list(params)
        device = params[0].device if params else torch.device("cpu")
        if device.type == "cuda":
            return torch.optim.Adam(params, lr=torch.tensor(self.lr_at(0), device=device),
                                    betas=(self.b1, self.b2), eps=self.eps,
                                    capturable=True)
        return torch.optim.Adam(params, lr=self.lr_at(0), betas=(self.b1, self.b2),
                                eps=self.eps)

    def lr_at(self, count: int) -> float:
        return float(self.lr(count) if callable(self.lr) else self.lr)


def adam(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999) -> Adam:
    return Adam(lr, float(b1), float(b2))


# -------------------------------------------------------------- named updates
class OptimizerSet:
    """Named optimizers over disjoint subsets of a model's modules."""

    def __init__(self):
        self._opts: Dict[str, Tuple[Adam, Tuple[str, ...]]] = {}
        # inside a capture: the device vectors of scheduled learning rates,
        # one slot per update of each optimizer, taken in order
        self._slots: Dict[str, torch.Tensor] = {}
        self._taken: Dict[str, int] = {}

    def add(self, name: str, tx: Adam, module_names: Iterable[str]) -> "OptimizerSet":
        self._opts[name] = (tx, tuple(module_names))
        return self

    def names(self) -> List[str]:
        return list(self._opts)

    def modules_of(self, name: str) -> Tuple[str, ...]:
        return self._opts[name][1]

    def tx(self, name: str) -> Adam:
        return self._opts[name][0]

    def init(self, modules: nn.ModuleDict) -> Dict[str, torch.optim.Optimizer]:
        """One optimizer per name, over the parameters of its modules."""
        return {name: tx.create([p for m in mods for p in modules[m].parameters()])
                for name, (tx, mods) in self._opts.items()}

    def scheduled(self) -> List[str]:
        """The optimizers whose learning rate follows a schedule."""
        return [name for name, (tx, _) in self._opts.items() if callable(tx.lr)]

    def capture_lr_slots(self, slots: Dict[str, torch.Tensor]) -> None:
        """For the capture that follows: the i-th update of optimizer
        ``name`` copies its learning rate from ``slots[name][i]``, which the
        host fills before each launch.  ``{}`` ends it."""
        self._slots = dict(slots)
        self._taken = {name: 0 for name in slots}

    def grad_step(self, state: TrainState, opt_name: str,
                  loss_fn: Callable[[], Tuple[torch.Tensor, Any]]
                  ) -> Tuple[TrainState, torch.Tensor, Any]:
        """One optimizer step on the modules owned by ``opt_name``.

        ``loss_fn() -> (loss, aux)`` runs the forward with the modules'
        current parameters.  Gradients are taken only with respect to the
        owned parameters (every other module is held fixed, as ``igm_tpu``
        differentiates only the owned subset); a parameter the loss does not
        reach gets a zero gradient, as JAX would give it."""
        opt = state.opt_states[opt_name]
        params = _params(opt)
        loss, aux = loss_fn()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        self._apply(opt_name, opt, params, grads, state.step)
        return state, loss.detach(), aux

    def apply_grads(self, state: TrainState, opt_name: str,
                    grads: Sequence[torch.Tensor]) -> TrainState:
        """Apply externally computed gradients, in the order of the owned
        modules' ``parameters()``."""
        opt = state.opt_states[opt_name]
        params = _params(opt)
        if len(grads) != len(params):
            raise ValueError(f"{opt_name}: {len(grads)} gradients for "
                             f"{len(params)} parameters")
        self._apply(opt_name, opt, params, grads, state.step)
        return state

    def _apply(self, opt_name: str, opt: torch.optim.Optimizer,
               params: List[torch.Tensor], grads, count: Optional[int] = None) -> None:
        """One update; ``count`` is the updates already applied: the train
        state's step (every model here updates each optimizer once a step),
        or, where it is not given, the optimizer's own step count, read back
        from its state (a host sync on the card)."""
        tx = self.tx(opt_name)
        if count is None:
            state = opt.state.get(params[0], {})
            count = int(state["step"]) if "step" in state else 0
        if callable(tx.lr):
            slot = None
            if opt_name in self._slots:
                slot = self._slots[opt_name][self._taken[opt_name]]
                self._taken[opt_name] += 1
            for group in opt.param_groups:
                if not isinstance(group["lr"], torch.Tensor):
                    group["lr"] = tx.lr_at(count)
                elif slot is not None:
                    group["lr"].copy_(slot)
                elif torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(f"{opt_name}: a scheduled learning rate inside "
                                       "a capture needs capture_lr_slots")
                else:
                    group["lr"].fill_(tx.lr_at(count))
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        opt.step()
        for p in params:
            p.grad = None
