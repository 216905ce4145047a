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

Under data parallelism of more than one rank the capacity and the slots
would have to count the global batch's tokens (a cumulative sum across the
ranks): ``bind_mesh`` refuses such a mesh until ROADMAP slice 7d gives the
MoE global routing.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

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

    def bind_mesh(self, mesh) -> None:
        if mesh is not None and mesh.world > 1:
            raise NotImplementedError(
                "the Switch-MoE under data parallelism (more than one rank) needs global "
                "routing (the capacity and slots over the global batch's tokens), "
                "ROADMAP Queue 1 slice 7d, not ported yet")

    def reset_parameters(self, generator: torch.Generator) -> None:
        e = self.experts
        lecun_normal_(self.w_up, e * self.dim, generator)
        lecun_normal_(self.w_dn, e * self.hidden, generator)
        with torch.no_grad():
            self.b_up.zero_()
            self.b_dn.zero_()

    def capacity(self, n: int) -> int:
        return max(1, int(math.ceil(self.capacity_factor * n / self.experts)))

    def forward(self, x: torch.Tensor) -> tuple:
        """[B, T, d] -> ([B, T, d], aux (), load (E,))."""
        b, t, d = x.shape
        e, n = self.experts, b * t
        cap = self.capacity(n)
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
        keep = ((pos_t < cap).float() * onehot_t).t()                  # [n, e]
        pos_i = (pos_t * onehot_t).sum(dim=0).long()
        kept = keep.sum(dim=-1)
        onehot = onehot_t.t()

        cdt = self.dtype or torch.float32
        mode = self.dispatch
        if mode == "auto":
            mode = "scatter" if n > 4 * d else "einsum"
        if mode == "scatter":
            slot_i = torch.where(kept > 0, idx * cap + pos_i, e * cap)
            buf = torch.zeros(e * cap + 1, d, dtype=cdt, device=x.device)
            buf = buf.index_copy(0, slot_i, xf.to(cdt))    # unique but the dump row
            buf = buf[:e * cap].reshape(e, cap, d)
        else:
            slot = (pos_i[:, None] == torch.arange(cap, device=x.device)).float()
            dispatch = keep[:, :, None] * slot[:, None, :]             # [n, e, cap]
            buf = torch.einsum("nec,nd->ecd", dispatch.to(cdt), xf.to(cdt))

        h = torch.bmm(buf, self.w_up.to(cdt)) + self.b_up[:, None, :].to(cdt)
        h = F.gelu(h, approximate="tanh")
        out_e = torch.bmm(h, self.w_dn.to(cdt)) + self.b_dn[:, None, :].to(cdt)

        if mode == "scatter":
            picked = out_e.reshape(e * cap, d)[torch.clamp(slot_i, max=e * cap - 1)]
            out = picked * (gate * kept)[:, None].to(cdt)
        else:
            combine = dispatch * gate[:, None, None]
            out = torch.einsum("nec,ecd->nd", combine.to(cdt), out_e)

        load = onehot.mean(dim=0)
        aux = e * torch.sum(load * probs.mean(dim=0))
        return out.reshape(b, t, d).to(x.dtype), aux, load
