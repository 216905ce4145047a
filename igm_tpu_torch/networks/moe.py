"""Switch-style Mixture-of-Experts MLP for the DiT blocks: counterpart of
``igm_tpu/networks/moe.py`` ``SwitchMoE``.

A float32, bias-free router with top-1 gating (the first maximal
probability wins); each expert's buffer holds ``cap = ceil(cf * n / E)``
tokens, a token's slot its rank among the tokens routed to that expert
(a cumulative sum over the tokens); tokens past capacity are dropped
(their MLP output is 0, so they ride the block's residual).  Expert
weights are stacked ``w_up (E, d, h)``, ``b_up (E, h)``, ``w_dn (E, h, d)``,
``b_dn (E, d)``, the layout of ``igm_tpu``'s leaves.

``dispatch``: ``scatter`` copies each kept token into its unique slot of an
``(E * cap + 1, d)`` buffer (dropped tokens all land on the last row, which
is discarded) and gathers the expert outputs back; ``einsum`` builds the
one-hot ``[n, E, cap]`` dispatch tensor and moves tokens by products;
``auto`` takes scatter when n > 4 d.  Slots are unique, so the two are
equal; at the DiT's full width (n = 65,536 tokens) only scatter is
feasible.

The forward returns ``(out, aux, load)``: the Switch load-balance loss
``E * sum_e f_e * p_e`` and the per-expert routed fractions ``f_e``, as
tensors (no host synchronisation, so a CUDA graph can capture the step).

Initialisation mirrors Flax's: ``lecun_normal`` on the 3-D expert leaves
counts E into the fan-in (``w_up`` std 1/sqrt(E d), ``w_dn`` 1/sqrt(E h)),
the router lecun_normal over d, zero biases.

Global routing on the data axis (``bind_mesh``): on a mesh of ``world``
batch ranks, rank r's tokens are the r-th block of the one-process token
order (``Mesh.local_rows`` with one block), and the routing is the
one-process routing of the global batch:

- the capacity is ``ceil(cf * n_global / E)``, ``n_global`` the global
  batch's tokens;
- a token's slot is its rank among the rank's tokens routed to its expert
  plus the tokens the lower ranks routed there: an exclusive prefix over
  the ranks of their per-expert counts, from one all-gather of E counts
  (inside the step, so a CUDA graph captures it under NCCL);
- the rank's buffer keeps ``E * cap`` slots, filled by its own tokens
  only: the expert MLP works token by token, so no token moves;
- ``aux = E * sum_e f_e * p_e`` takes the global ``f`` and ``p``: the
  counts and probability sums are summed over the ranks by
  ``all_reduce_sum``, whose backward is the same sum, so the gradient
  averaged over the ranks is the global aux's (as BatchNorm's statistics);
  ``load`` is the global ``f``.

Expert parallelism (``mesh.mode=tensor``, ``bind_mesh`` records the model
group ``tp``): the stacked leaves' expert axis is sharded over ``model``
where it divides E (``parallel/mesh.py`` ``_tp_spec``), so model rank r
holds experts ``[r E/m, (r+1) E/m)`` (with their Adam moments and EMA
shadow).  The model group's ranks hold the same tokens (Megatron's
residual stream), so no token moves:

- every rank routes every token, from the replicated router, to the same
  expert and slot (the global routing above, on the batch group);
- a rank fills and runs its own experts' ``E/m * cap`` slots only, and the
  partial output (a token's row non-zero on its expert's rank alone) is
  summed over the model group (``reduce_from_model``; under sequence
  parallelism ``scatter_tokens``, each rank keeping its part of the
  tokens), then multiplied by ``gate * kept``;
- the expert path's input passes ``copy_to_model`` (its gradient, from
  each rank's experts, summed over the group); the router and the aux
  read the plain input, and the gate multiplies the summed output, so
  their gradients are whole on every rank (under sequence parallelism the
  gate's rank part is taken by ``split_tokens``, whose backward gathers
  the parts).

Where ``model`` does not divide E the experts are replicated (``_tp_spec``
gives ``()``, as ``igm_tpu``'s): every rank computes every expert and no
expert collective runs.

Every forward adds to the tracing registry's device counter ``moe.tokens``
(``core/trace.py``) this rank's routed tokens, its kept tokens and the
expert slots computed for them (E times the capacity), inside the step's
graph when it is captured: three small kernels a block, no host read.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import trace
from ..parallel.mesh import all_gather_into, all_reduce_sum
from ..parallel.tensor import (TensorParallel, copy_to_model, reduce_from_model,
                               scatter_tokens, split_tokens)
from .base import FlaxDense, lecun_normal_


class SwitchMoE(nn.Module):
    def __init__(self, dim: int, hidden: int, experts: int,
                 capacity_factor: float = 1.25, dtype: torch.dtype | None = None,
                 dispatch: str = "auto"):
        super().__init__()
        if dispatch not in ("auto", "scatter", "einsum"):
            raise ValueError(f"dispatch must be auto|scatter|einsum, got {dispatch!r}")
        self.dim, self.hidden, self.experts = dim, hidden, experts
        self.capacity_factor, self.dtype, self.dispatch = capacity_factor, dtype, dispatch
        self.router = FlaxDense(dim, experts, use_bias=False)
        self.w_up = nn.Parameter(torch.empty(experts, dim, hidden))
        self.b_up = nn.Parameter(torch.empty(experts, hidden))
        self.w_dn = nn.Parameter(torch.empty(experts, hidden, dim))
        self.b_dn = nn.Parameter(torch.empty(experts, dim))
        # the data-axis mesh routed over (None: one process)
        self.mesh = None
        # the model group of mesh.mode=tensor (None: none)
        self.tp = None

    def bind_mesh(self, mesh, blocks: int = 1) -> None:
        """Route over ``mesh``'s batch ranks (None: this process's tokens);
        on a model axis in ``tensor`` mode, record the model group (the
        experts are sharded over it where the sharding placed their leaves
        so: ``forward`` reads it from ``w_up``'s shape).  Refused: a
        step that splits its batch into ``blocks > 1`` row blocks (rank r's
        tokens are then not the r-th block of the global order)."""
        if mesh is not None and mesh.grouped and blocks != 1:
            raise ValueError(f"the Switch-MoE routes over the global batch, which a step "
                             f"of {blocks} blocks does not hand out in order")
        self.mesh = mesh if mesh is not None and mesh.grouped else None
        self.tp = (TensorParallel.of(mesh, 1)
                   if mesh is not None and mesh.sharded and mesh.mode == "tensor" else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        e = self.experts
        lecun_normal_(self.w_up, e * self.dim, generator)
        lecun_normal_(self.w_dn, e * self.hidden, generator)
        with torch.no_grad():
            self.b_up.zero_()
            self.b_dn.zero_()

    def capacity(self, n: int) -> int:
        return max(1, int(math.ceil(self.capacity_factor * n / self.experts)))

    def forward(self, x: torch.Tensor, split: bool = False) -> tuple:
        """[B, T, d] -> ([B, T, d], aux (), load (E,)).  ``split``
        (sequence parallelism on the model group): ``x`` holds all T
        tokens, the output the rank's part of them (``split_tokens``')."""
        b, t, d = x.shape
        e, n = self.experts, b * t
        mesh = self.mesh
        cap = self.capacity(n * (1 if mesh is None else mesh.world))
        xf = x.reshape(n, d)

        probs = torch.softmax(self.router(xf.float()), dim=-1)      # [n, e] f32
        gate = probs.amax(dim=-1)
        idx = probs.argmax(dim=-1)
        # a token's 0-based rank among those routed to its expert (a running
        # count, exact in float32), past capacity its dispatch weight is 0;
        # the one-hot is built expert-major, [e, n], so the count runs along
        # the contiguous axis (torch's CUDA scan down a leading axis of
        # 65,536 rows and 8 columns took 10.5 ms a call on an H100)
        onehot_t = (idx[None, :] == torch.arange(e, device=x.device)[:, None]).float()
        pos_t = torch.cumsum(onehot_t, dim=1) * onehot_t - onehot_t
        if mesh is not None:
            # the tokens the lower ranks routed to each expert come first
            counts = onehot_t.sum(dim=1)
            every = torch.empty(mesh.world * e, dtype=counts.dtype, device=x.device)
            all_gather_into(every, counts, mesh.group)
            before = every.view(mesh.world, e)[:mesh.rank].sum(dim=0)
            pos_t = pos_t + before[:, None] * onehot_t
        keep = ((pos_t < cap).float() * onehot_t).t()                  # [n, e]
        pos_i = (pos_t * onehot_t).sum(dim=0).long()
        kept = keep.sum(dim=-1)
        onehot = onehot_t.t()
        tokens = trace.device_counter("moe.tokens", 3, x.device)    # routed, kept, slots
        tokens[1].add_(kept.sum())
        torch._foreach_add_([tokens[0], tokens[2]], [float(n), float(e * cap)])

        cdt = self.dtype or torch.float32
        mode = self.dispatch
        if mode == "auto":
            mode = "scatter" if n > 4 * d else "einsum"
        tp, el = self.tp, self.w_up.shape[0]
        sharded = el != e          # the rank holds its share of the experts alone
        if sharded:    # the expert path's gradient comes from the rank's experts alone
            xf_e, first = copy_to_model(xf, tp), tp.rank * el
        else:
            xf_e, first = xf, 0
        part = self._experts(xf_e, idx, keep, pos_i, cap, mode, first, el).reshape(b, t, d)
        weight = (gate * kept).reshape(b, t, 1).to(cdt)
        if split:
            weight = split_tokens(weight, tp)
            part = scatter_tokens(part, tp) if sharded else split_tokens(part, tp)
        elif sharded:
            part = reduce_from_model(part, tp)
        out = (part * weight).to(x.dtype)

        if mesh is None:
            load = onehot.mean(dim=0)
            mean_p = probs.mean(dim=0)
        else:           # the global batch's fractions and mean probabilities
            n_global = n * mesh.world
            load = all_reduce_sum(mesh, onehot_t.sum(dim=1)) / n_global
            mean_p = all_reduce_sum(mesh, probs.sum(dim=0)) / n_global
        aux = e * torch.sum(load * mean_p)
        return out, aux, load

    def _experts(self, xf, idx, keep, pos_i, cap: int, mode: str, first: int, el: int):
        """Experts ``[first, first + el)`` (this rank's; all E in one
        process or when they are replicated) on their ``el * cap`` slots:
        the tokens' ``[n, d]`` ungated outputs, 0 for a token dropped or
        routed to another rank's expert."""
        d = xf.shape[1]
        cdt = self.dtype or torch.float32
        if mode == "scatter":
            mine = (keep[:, first:first + el].sum(dim=-1) > 0)
            slot_i = torch.where(mine, (idx - first) * cap + pos_i, el * cap)
            buf = torch.zeros(el * cap + 1, d, dtype=cdt, device=xf.device)
            buf = buf.index_copy(0, slot_i, xf.to(cdt))      # unique but the dump row
            buf = buf[:el * cap].reshape(el, cap, d)
        else:
            slot = (pos_i[:, None] == torch.arange(cap, device=xf.device)).float()
            dispatch = keep[:, first:first + el, None] * slot[:, None, :]   # [n, el, cap]
            buf = torch.einsum("nec,nd->ecd", dispatch.to(cdt), xf.to(cdt))

        h = torch.bmm(buf, self.w_up.to(cdt)) + self.b_up[:, None, :].to(cdt)
        h = F.gelu(h, approximate="tanh")
        out_e = torch.bmm(h, self.w_dn.to(cdt)) + self.b_dn[:, None, :].to(cdt)

        if mode == "scatter":
            picked = out_e.reshape(el * cap, d)[torch.clamp(slot_i, max=el * cap - 1)]
            return torch.where(mine[:, None], picked, 0.0)
        return torch.einsum("nec,ecd->nd", dispatch.to(cdt), out_e)
