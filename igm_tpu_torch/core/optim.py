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

Adam with moments *stored* in a reduced dtype (``mu_dtype``/``nu_dtype``,
``igm_tpu``'s ``_scale_by_adam_cast``, or optax's ``mu_dtype`` alone) and
parameters stored in bfloat16 are :class:`CastAdam`, an optimizer of this
module with the same state layout as ``torch.optim.Adam`` (``step``,
``exp_avg``, ``exp_avg_sq``) and the same capturable rule on the card
(device step count and learning rate, no host sync).  Its step can apply a
bfloat16 parameter's update with the counter-hash stochastic rounding of
``igm_tpu`` (``stochastic_round_bf16``), one uint32 seed a parameter,
given as a device tensor.  ``Adam.clip_norm`` chains optax's
``clip_by_global_norm`` ahead of the update.

The adversarial zoo's helpers: :func:`rmsprop` (:class:`RMSprop`, optax's
formula with eps inside the square root, capturable on the card),
:func:`grouped_adam` (one Adam over param groups, a learning rate a
module: InfoGAN's) and :func:`clip_params` (WGAN's in-place clamp).

A scheduled learning rate follows the count of its own optimizer's
updates, as optax keeps the count in each optimizer's state: the train
state counts each optimizer's updates (``TrainState.counts``), and a model
may update one optimizer twice a step (AAE) or on some steps only (AGE,
the GANs).

Data parallelism: on a data-axis mesh (``OptimizerSet.mesh``, bound by
``BaseModel.set_mesh``) every update first averages its gradients over the
ranks, one flattened buffer a dtype and one all-reduce a buffer, before
``clip_by_global_norm`` and the step (``parallel.mesh.all_reduce_``);
under NCCL inside the step's CUDA graph.  The average, not the sum,
because every loss the port's models differentiate is a mean over the
batch (or a function of batch statistics that are themselves taken over
the global batch), so that the mean of the ranks' losses is the global
batch's loss.  The inventory, model by model:

- DDPM, latent DDPM, EDM, flow matching, score-SDE, consistency,
  distillation: a (weighted) mean over the batch of the per-element error
  (the DiT's MoE aux is refused under more than one rank);
- VAE, beta-VAE, cVAE, FactorVAE (``ae``; its critic ``d``), VAE-GAN,
  AAE: batch means of the per-sample log-likelihood, KL (``normal_kld``),
  MSE and adversarial terms (``adversarial_loss``: means); VAE-GAN's
  feature loss is the batch sum over ``n``, a mean;
- VQ-VAE: MSE means (the EMA codebook's counts and sums are summed over
  the ranks by the quantizer itself);
- GAN, LSGAN, hinge, WGAN, WGAN-GP (the gradient penalty a batch mean of
  per-sample norms), speed_gan, BiGAN, InfoGAN (its code losses batch
  means): means;
- AGE: KLs of the global batch's moments (taken over the ranks) and batch
  means;
- MADE, PixelCNN, RealNVP: bits per dimension, a mean over the batch;
- TAR: the per-image summed NLL, averaged over the batch.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..parallel.mesh import all_reduce_
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


# ----------------------------------------------------- stochastic rounding
def _int32(c: int) -> int:
    """The int32 with the bits of the uint32 ``c``."""
    return c - (1 << 32) if c >= 1 << 31 else c


def hash_noise_u16(shape, seed, device=None) -> torch.Tensor:
    """``igm_tpu``'s ``_hash_noise_u16`` (``core/optim.py:114-128``) bit for
    bit: per element, 16 bits of a multiply-xor hash of its linear index
    (row-major in ``shape``) and ``seed`` (an int, or an integer tensor,
    holding a value in [0, 2**31)).  int32 tensors carry the uint32
    arithmetic: products wrap mod 2**32 as uint32 ones do, and the right
    shifts are made logical by a mask.  Returns int32 values in [0, 65535]."""
    if isinstance(seed, torch.Tensor):
        device = seed.device
        seed = seed.to(torch.int32)
    n = 1
    for d in shape:
        n *= int(d)
    if n >= 1 << 31:
        raise ValueError(f"hash_noise_u16: {n} elements, the index is 32 bits")
    h = torch.arange(n, dtype=torch.int32, device=device) * _int32(0x9E3779B1) ^ seed
    h = (h ^ ((h >> 16) & 0xFFFF)) * _int32(0x85EBCA77)
    h = h ^ ((h >> 13) & 0x7FFFF)
    return (h & 0xFFFF).reshape(shape)


def stochastic_round_bf16(x: torch.Tensor, seed) -> torch.Tensor:
    """float32 -> bfloat16 with ``igm_tpu``'s unbiased stochastic rounding
    (``core/optim.py:131-144``): the hash noise added below the bfloat16
    mantissa of the float32 bits, then truncated.  ``seed`` is the uint32
    seed ``igm_tpu`` draws from its key (``randint(key, (), 0, 2**31-1)``),
    given here as an int or an integer tensor on ``x``'s device."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + hash_noise_u16(x.shape, seed, x.device)) & _int32(0xFFFF0000)
    return rounded.view(torch.float32).to(torch.bfloat16)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: ``g`` when the global norm is below
    ``max_norm``, else ``(g / norm) * max_norm``, selected on the device
    (no host branch).  Not ``torch.nn.utils.clip_grad_norm_``, which scales
    by ``max_norm / (norm + 1e-6)`` clamped at 1."""
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for g in grads]


# ----------------------------------------------------------------- optimizers
class CastAdam(torch.optim.Optimizer):
    """Adam with moments stored in reduced dtypes and parameters that may be
    stored in bfloat16, with ``igm_tpu``'s arithmetic:

    - with ``nu_dtype`` (``_scale_by_adam_cast``, ``core/optim.py:71-111``):
      ``mu = b1 * f32(mu) + (1 - b1) * f32(g)`` and ``nu = b2 * f32(nu) +
      (1 - b2) * f32(g)**2`` in float32, stored as ``mu_dtype`` (float32
      when None) and ``nu_dtype``; the update ``(f32(mu) / bc1) /
      (sqrt(f32(nu) / bc2) + eps)`` reads the stored moments, with the bias
      corrections ``1 - b**count`` in float32;
    - with ``mu_dtype`` alone (``optax.adam(mu_dtype=...)``): the update
      reads the float32 moments before ``mu`` is stored as ``mu_dtype``,
      and ``b1 * mu`` is a product in ``mu``'s dtype, as optax computes it.

    Then ``p + (-lr) * update``: float32 parameters exactly so; bfloat16 ones
    round the float32 sum to nearest, or, with ``sr_seeds`` (one seed per
    parameter, in the optimizer's order) given to :meth:`step`, by
    :func:`stochastic_round_bf16` (``igm_tpu``'s ``apply_updates_sr``).
    The state has ``torch.optim.Adam``'s layout (``step``, ``exp_avg``,
    ``exp_avg_sq``); ``step`` is a float32 tensor on the parameter's device
    and ``lr`` may be a device tensor, so the step captures into a CUDA
    graph."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None, capturable: bool = False):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      capturable=capturable))
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype

    def _dtypes(self, p: torch.Tensor) -> Tuple[torch.dtype, torch.dtype]:
        if self.nu_dtype is not None:
            return self.mu_dtype or torch.float32, self.nu_dtype
        return self.mu_dtype or p.dtype, p.dtype

    def load_state_dict(self, state_dict) -> None:
        """``Optimizer.load_state_dict`` casts the moments to the parameter's
        dtype; they go back to their storage dtypes here."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state.get(p)
                if st:
                    mu_dt, nu_dt = self._dtypes(p)
                    st["exp_avg"] = st["exp_avg"].to(mu_dt)
                    st["exp_avg_sq"] = st["exp_avg_sq"].to(nu_dt)

    @torch.no_grad()
    def step(self, closure=None, sr_seeds: Optional[torch.Tensor] = None):
        if closure is not None:
            raise ValueError("CastAdam takes no closure")
        params = [p for group in self.param_groups for p in group["params"]]
        if sr_seeds is not None and len(sr_seeds) != len(params):
            raise ValueError(f"{len(sr_seeds)} seeds for {len(params)} parameters")
        i = 0
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, lr = group["eps"], group["lr"]
            for p in group["params"]:
                seed = None if sr_seeds is None else sr_seeds[i]
                i += 1
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    mu_dt, nu_dt = self._dtypes(p)
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p, dtype=mu_dt)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=nu_dt)
                count, mu, nu = st["step"], st["exp_avg"], st["exp_avg_sq"]
                count.add_(1.0)
                bc1 = 1.0 - torch.pow(b1, count)
                bc2 = 1.0 - torch.pow(b2, count)
                g = p.grad.float()
                if self.nu_dtype is not None:
                    mu.copy_(b1 * mu.float() + (1.0 - b1) * g)
                    nu.copy_(b2 * nu.float() + (1.0 - b2) * g.square())
                    m, v = mu.float(), nu.float()
                else:
                    b1_mu = torch.full((), b1, dtype=mu.dtype, device=mu.device)
                    m = (1.0 - b1) * g + (mu * b1_mu).float()
                    v = (1.0 - b2) * g.square() + b2 * nu.float()
                    mu.copy_(m)
                    nu.copy_(v)
                update = (m / bc1) / ((v / bc2).sqrt() + eps) * (-lr)
                if p.dtype == torch.float32:
                    p.add_(update)
                elif seed is not None:
                    p.copy_(stochastic_round_bf16(p.float() + update, seed))
                else:
                    p.copy_(p.float() + update.to(p.dtype).float())
        return None


def _env_dtype(name: str, default: Optional[torch.dtype]) -> Optional[torch.dtype]:
    """``IGM_MU_DTYPE``/``IGM_NU_DTYPE``, read as ``igm_tpu`` reads them:
    float32 (or f32) means None, another name a torch dtype."""
    env = os.environ.get(name)
    if not env:
        return default
    return None if env in ("float32", "f32") else getattr(torch, env)


@dataclasses.dataclass(frozen=True)
class Spec:
    """What :class:`OptimizerSet` names: a learning rate (a float or a
    schedule of the update count) and the optimizer it creates."""
    lr: Union[float, Schedule]

    def create(self, params: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
        raise NotImplementedError

    def create_groups(self, groups: Sequence[Tuple[str, Sequence[torch.Tensor]]]
                      ) -> torch.optim.Optimizer:
        """``groups``: (module name, its parameters), in the optimizer's
        order; one optimizer over all of them."""
        return self.create([p for _, ps in groups for p in ps])

    def lr_at(self, count: int) -> float:
        return float(self.lr(count) if callable(self.lr) else self.lr)


@dataclasses.dataclass(frozen=True)
class Adam(Spec):
    """``optax.adam``: eps = 1e-8 added to sqrt of the bias-corrected second
    moment, the placement ``torch.optim.Adam`` also uses, which runs it
    where the moments and parameters are float32; :class:`CastAdam` runs it
    where a moment dtype is given or a parameter is not float32.  ``lr`` is
    a float or a schedule of the update count (the count of updates already
    applied, as optax counts).  ``clip_norm`` clips the gradients by their
    global norm first (``optax.chain(clip_by_global_norm(clip_norm),
    adam(...))``)."""
    lr: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    mu_dtype: Optional[torch.dtype] = None
    nu_dtype: Optional[torch.dtype] = None
    clip_norm: Optional[float] = None

    def create(self, params: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
        params = list(params)
        device = params[0].device if params else torch.device("cpu")
        cuda = device.type == "cuda"
        lr = torch.tensor(self.lr_at(0), device=device) if cuda else self.lr_at(0)
        if (self.mu_dtype is not None or self.nu_dtype is not None
                or any(p.dtype != torch.float32 for p in params)):
            return CastAdam(params, lr=lr, betas=(self.b1, self.b2), eps=self.eps,
                            mu_dtype=self.mu_dtype, nu_dtype=self.nu_dtype, capturable=cuda)
        if cuda:
            return torch.optim.Adam(params, lr=lr, betas=(self.b1, self.b2), eps=self.eps,
                                    capturable=True)
        return torch.optim.Adam(params, lr=lr, betas=(self.b1, self.b2), eps=self.eps)


@dataclasses.dataclass(frozen=True)
class GroupedAdam(Adam):
    """``igm_tpu``'s ``grouped_adam`` (``optax.multi_transform`` of one
    ``adam`` a module): one Adam whose param groups are the modules, each
    with its own constant learning rate (``lrs``, by module name)."""
    lrs: Tuple[Tuple[str, float], ...] = ()

    def create_groups(self, groups: Sequence[Tuple[str, Sequence[torch.Tensor]]]
                      ) -> torch.optim.Optimizer:
        """A param group a module."""
        lrs = dict(self.lrs)
        params = [p for _, ps in groups for p in ps]
        device = params[0].device if params else torch.device("cpu")
        cuda = device.type == "cuda"
        param_groups = [{"params": list(ps),
                         "lr": torch.tensor(lrs[m], device=device) if cuda else lrs[m]}
                        for m, ps in groups]
        return torch.optim.Adam(param_groups, lr=self.lr_at(0), betas=(self.b1, self.b2),
                                eps=self.eps, capturable=cuda)


def grouped_adam(lr_by_module: Dict[str, float], b1: float, b2: float) -> GroupedAdam:
    """``igm_tpu``'s ``grouped_adam`` (``core/optim.py:252-264``): per-module
    learning rates in one optimizer (InfoGAN's ``g``: ``lrG`` for netG and
    ``lrQ`` for netQ)."""
    lrs = tuple((m, float(lr)) for m, lr in lr_by_module.items())
    return GroupedAdam(lrs[0][1], float(b1), float(b2), lrs=lrs)


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay=alpha, eps)`` with optax's default
    ``eps_in_sqrt``: ``nu = (1 - alpha) g**2 + alpha nu`` from ``nu = 0``,
    then ``p - lr * g * rsqrt(nu + eps)``.  Not ``torch.optim.RMSprop``,
    which divides by ``sqrt(nu) + eps``: the two differ wherever ``nu`` is
    near ``eps``, as on WGAN's first steps.  ``lr`` may be a device tensor
    and the state (``step``, ``square_avg``) lives on the parameter's
    device, so the step captures into a CUDA graph."""

    def __init__(self, params, lr, alpha: float = 0.99, eps: float = 1e-8,
                 capturable: bool = False):
        super().__init__(params, dict(lr=lr, alpha=float(alpha), eps=float(eps),
                                      capturable=capturable))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RMSprop takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["square_avg"] = torch.zeros_like(p)
            alpha, eps, lr = group["alpha"], group["eps"], group["lr"]
            grads = [p.grad for p in params]
            nus = [self.state[p]["square_avg"] for p in params]
            torch._foreach_add_([self.state[p]["step"] for p in params], 1.0)
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - alpha)
            torch._foreach_mul_(nus, alpha)
            torch._foreach_add_(nus, sq)
            scale = torch._foreach_add(nus, eps)
            torch._foreach_rsqrt_(scale)
            torch._foreach_mul_(scale, grads)
            torch._foreach_mul_(scale, lr)
            torch._foreach_sub_(params, scale)
        return None


@dataclasses.dataclass(frozen=True)
class RMSpropSpec(Spec):
    """The spec :func:`rmsprop` returns (the counterpart of the optax
    transform): a constant learning rate or a schedule of the update
    count, as :class:`Adam`'s; no gradient clipping."""
    alpha: float = 0.99
    eps: float = 1e-8
    clip_norm: Optional[float] = None

    def create(self, params: Sequence[torch.Tensor]) -> RMSprop:
        params = list(params)
        device = params[0].device if params else torch.device("cpu")
        cuda = device.type == "cuda"
        lr = torch.tensor(self.lr_at(0), device=device) if cuda else self.lr_at(0)
        return RMSprop(params, lr=lr, alpha=self.alpha, eps=self.eps, capturable=cuda)


def rmsprop(lr: Union[float, Schedule], alpha: float = 0.99) -> RMSpropSpec:
    """``igm_tpu``'s ``rmsprop`` (``core/optim.py:167-169``):
    ``optax.rmsprop(lr, decay=alpha, eps=1e-8)``."""
    return RMSpropSpec(lr, float(alpha), 1e-8)


@torch.no_grad()
def clip_params(module: nn.Module, limit: float) -> None:
    """WGAN's weight clipping (``igm_tpu``'s ``clip_params``,
    ``core/optim.py:172-175``): every parameter of ``module`` clamped to
    [-limit, limit], in place."""
    params = list(module.parameters())
    torch._foreach_clamp_min_(params, -float(limit))
    torch._foreach_clamp_max_(params, float(limit))


def adam(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         mu_dtype: Optional[torch.dtype] = None, nu_dtype: Optional[torch.dtype] = None,
         clip_norm: Optional[float] = None) -> Adam:
    """``igm_tpu``'s ``adam`` (``core/optim.py:46-68``): ``IGM_MU_DTYPE`` and
    ``IGM_NU_DTYPE``, read here, override the moment dtypes."""
    return Adam(lr, float(b1), float(b2), mu_dtype=_env_dtype("IGM_MU_DTYPE", mu_dtype),
                nu_dtype=_env_dtype("IGM_NU_DTYPE", nu_dtype),
                clip_norm=None if clip_norm is None else float(clip_norm))


# -------------------------------------------------------------- named updates
class OptimizerSet:
    """Named optimizers over disjoint subsets of a model's modules."""

    def __init__(self):
        self._opts: Dict[str, Tuple[Spec, Tuple[str, ...]]] = {}
        # inside a capture: the device vectors of scheduled learning rates,
        # one slot per update of each optimizer, taken in order
        self._slots: Dict[str, torch.Tensor] = {}
        self._taken: Dict[str, int] = {}
        # the data-axis mesh whose ranks average the gradients (None: one process)
        self.mesh = None

    def add(self, name: str, tx: Spec, module_names: Iterable[str]) -> "OptimizerSet":
        self._opts[name] = (tx, tuple(module_names))
        return self

    def names(self) -> List[str]:
        return list(self._opts)

    def modules_of(self, name: str) -> Tuple[str, ...]:
        return self._opts[name][1]

    def tx(self, name: str) -> Spec:
        return self._opts[name][0]

    def init(self, modules: nn.ModuleDict) -> Dict[str, torch.optim.Optimizer]:
        """One optimizer per name, over the parameters of its modules."""
        return {name: tx.create_groups([(m, list(modules[m].parameters())) for m in mods])
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
                  loss_fn: Callable[[], Tuple[torch.Tensor, Any]],
                  sr_seeds: Optional[torch.Tensor] = None
                  ) -> Tuple[TrainState, torch.Tensor, Any]:
        """One optimizer step on the modules owned by ``opt_name``.

        ``loss_fn() -> (loss, aux)`` runs the forward with the modules'
        current parameters.  Gradients are taken only with respect to the
        owned parameters (every other module is held fixed, as ``igm_tpu``
        differentiates only the owned subset); a parameter the loss does not
        reach gets a zero gradient, as JAX would give it.  ``sr_seeds``, one
        per owned parameter (a :class:`CastAdam` optimizer), applies the
        bfloat16 parameters' updates with stochastic rounding."""
        opt = state.opt_states[opt_name]
        params = _params(opt)
        loss, aux = loss_fn()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        self._apply(opt_name, opt, params, grads, state.counts.get(opt_name, 0), sr_seeds)
        state.counts[opt_name] = state.counts.get(opt_name, 0) + 1
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
        self._apply(opt_name, opt, params, grads, state.counts.get(opt_name, 0))
        state.counts[opt_name] = state.counts.get(opt_name, 0) + 1
        return state

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """An update's gradients averaged over the data axis's ranks (one
        flattened buffer a dtype); as they are in one process."""
        return grads if self.mesh is None else all_reduce_(self.mesh, grads)

    def _apply(self, opt_name: str, opt: torch.optim.Optimizer,
               params: List[torch.Tensor], grads, count: Optional[int] = None,
               sr_seeds: Optional[torch.Tensor] = None) -> None:
        """One update; ``count`` is the updates this optimizer has already
        applied: the train state's count of them (``TrainState.counts``),
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
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        grads = self.reduce_grads(grads)
        if tx.clip_norm is not None:
            grads = clip_by_global_norm(grads, tx.clip_norm)
        for p, g in zip(params, grads):
            p.grad = g
        if sr_seeds is None:
            opt.step()
        else:
            opt.step(sr_seeds=sr_seeds)
        for p in params:
            p.grad = None
