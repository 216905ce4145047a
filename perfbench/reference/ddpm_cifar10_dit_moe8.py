"""Plain reference of ``ddpm_cifar10_dit_moe8``: the DiT denoiser
(Peebles & Xie 2023, arXiv:2212.09748: patch tokens, fixed 2-D sin-cos
positions, adaLN-Zero blocks) whose every second block's MLP is a
Switch mixture of experts (Fedus et al. 2021, arXiv:2101.03961), at the
configuration's sizes, in float32 and plain ``torch`` operations.

- Tokens: 2 x 2 patches of the NHWC image, row-major, each patch's pixels
  row-major with channels last; a dense embedding; the 2-D table (half the
  channels the row, half the column; sin then cos; frequencies
  10000^(-i/(d/4))).
- Conditioning ``c``: the timestep's 256-wide sin | cos embedding (the
  frequency step divides by 127), Dense, SiLU, Dense.
- A block: ``Dense(SiLU(c))`` gives shift, scale and gate for the
  attention and for the MLP; LayerNorm (eps 1e-6, no affine) times
  (1 + scale) plus shift; ``qkv`` packed by head (each head's q, k, v one
  block of 3 x 64); softmax(q k^T / 8) v; ``proj``; gated residual; the
  same for the MLP (4 x wide, tanh GELU) or the MoE.
- The MoE: a float32 bias-free router, softmax, top-1 (the first maximal
  probability), the token's slot its rank among the tokens sent to its
  expert in token order over the whole batch, capacity ceil(1.25 n / E),
  tokens past it dropped (output 0); the expert's output times the gate;
  the load-balance aux ``E sum_e f_e p_e`` (``f`` the routed fractions,
  dropped tokens included, ``p`` the mean probabilities), averaged over the
  MoE blocks.
- The final layer: shift and scale from ``Dense(SiLU(c))``, LayerNorm, a
  dense head back to 2 x 2 x 3 a token.

``q`` rounds the operands of every product but the router's (which the
configuration computes in float32) to the precision under test.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .ddpm_cifar10_unet import time_embedding


def _moe_blocks(cfg: dict):
    every = cfg["moe_every"]
    return [i for i in range(cfg["depth"]) if i % every == every - 1]


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    d, p, ch = cfg["hidden_dim"], cfg["patch"], cfg["channels"]
    mlp, e = 4 * d, cfg["moe_experts"]
    shapes: Dict[str, tuple] = {}

    def dense(name, i, o):
        shapes[f"{name}.weight"] = (o, i)
        shapes[f"{name}.bias"] = (o,)

    dense("patch_embed", p * p * ch, d)
    dense("Dense_0", 256, d)
    dense("Dense_1", d, d)
    moe = _moe_blocks(cfg)
    for i in range(cfg["depth"]):
        b = f"DiTBlock_{i}"
        dense(f"{b}._Modulation_0.Dense_0", d, 6 * d)
        dense(f"{b}.qkv", d, 3 * d)
        dense(f"{b}.proj", d, d)
        if i in moe:
            shapes[f"{b}.moe.router.weight"] = (e, d)
            shapes[f"{b}.moe.w_up"] = (e, d, mlp)
            shapes[f"{b}.moe.b_up"] = (e, mlp)
            shapes[f"{b}.moe.w_dn"] = (e, mlp, d)
            shapes[f"{b}.moe.b_dn"] = (e, d)
        else:
            dense(f"{b}.Dense_0", d, mlp)
            dense(f"{b}.Dense_1", mlp, d)
    dense("_Modulation_0.Dense_0", d, 2 * d)
    dense("head", d, p * p * ch)
    return shapes


def sincos_2d(h: int, w: int, dim: int) -> torch.Tensor:
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter))

    def axis(pos):
        args = np.outer(pos, omega)
        return np.concatenate([np.sin(args), np.cos(args)], axis=1)

    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    emb = np.concatenate([axis(gy.reshape(-1)), axis(gx.reshape(-1))], axis=1)
    return torch.from_numpy(emb.astype(np.float32))


def _dense(p, name, x, q):
    return F.linear(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"])


def _ln(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def route(logits_input: torch.Tensor, router: torch.Tensor, experts: int,
          capacity_factor: float) -> dict:
    """Switch top-1 routing of ``[n, d]`` tokens over the whole batch."""
    n = logits_input.shape[0]
    probs = torch.softmax(logits_input @ router.t(), dim=-1)
    gate, idx = probs.max(dim=-1)
    cap = max(1, int(math.ceil(capacity_factor * n / experts)))
    onehot = F.one_hot(idx, experts).float()
    pos = ((torch.cumsum(onehot, dim=0) - 1.0) * onehot).sum(dim=-1)
    kept = pos < cap
    load = onehot.mean(dim=0)
    aux = experts * torch.sum(load * probs.mean(dim=0))
    return dict(probs=probs, gate=gate, idx=idx, kept=kept, cap=cap, aux=aux)


def _moe(p, name, x, q, cfg, routed: list):
    b, t, d = x.shape
    e = cfg["moe_experts"]
    xf = x.reshape(b * t, d)
    r = route(xf, p[f"{name}.router.weight"], e, cfg["moe_capacity"])
    routed.append({k: r[k].detach() for k in ("idx", "kept")})
    out = torch.zeros_like(xf)
    for k in range(e):
        rows = torch.nonzero((r["idx"] == k) & r["kept"]).squeeze(1)
        if rows.numel() == 0:
            continue
        h = F.gelu(q(xf[rows]) @ q(p[f"{name}.w_up"][k]) + p[f"{name}.b_up"][k],
                   approximate="tanh")
        y = q(h) @ q(p[f"{name}.w_dn"][k]) + p[f"{name}.b_dn"][k]
        out = out.index_copy(0, rows, y)
    out = out * r["gate"][:, None]
    return out.reshape(b, t, d), r["aux"]


def make_forward(cfg: dict, routed: list | None = None):
    """``forward(params, x, t, q)`` -> (eps prediction, the MoE blocks'
    mean aux).  ``routed``, when given, collects each MoE block's expert
    index and kept mask of its last call."""
    d, heads, p_sz, ch = cfg["hidden_dim"], cfg["heads"], cfg["patch"], cfg["channels"]
    hd = d // heads
    moe = set(_moe_blocks(cfg))
    sink = routed if routed is not None else []

    def forward(p, x, t, q):
        sink.clear()
        b, hh, ww, cc = x.shape
        gh, gw = hh // p_sz, ww // p_sz
        n = gh * gw
        tok = x.reshape(b, gh, p_sz, gw, p_sz, cc).permute(0, 1, 3, 2, 4, 5)
        tok = _dense(p, "patch_embed", tok.reshape(b, n, p_sz * p_sz * cc), q)
        tok = tok + sincos_2d(gh, gw, d).to(tok.device)[None]
        c = _dense(p, "Dense_1", F.silu(_dense(p, "Dense_0", time_embedding(t, 256), q)), q)
        auxes = []
        for i in range(cfg["depth"]):
            blk = f"DiTBlock_{i}"
            mod = _dense(p, f"{blk}._Modulation_0.Dense_0", F.silu(c), q)[:, None, :]
            s_a, g_a, gate_a, s_m, g_m, gate_m = mod.chunk(6, dim=-1)
            a = _ln(tok) * (1.0 + g_a) + s_a
            qkv = _dense(p, f"{blk}.qkv", a, q).reshape(b, n, heads, 3 * hd)
            qh, kh, vh = (z.permute(0, 2, 1, 3) for z in qkv.split(hd, dim=-1))
            logits = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(hd)
            o = q(torch.softmax(logits, dim=-1)) @ q(vh)
            o = _dense(p, f"{blk}.proj", o.permute(0, 2, 1, 3).reshape(b, n, d), q)
            tok = tok + gate_a * o
            m = _ln(tok) * (1.0 + g_m) + s_m
            if i in moe:
                m, aux = _moe(p, f"{blk}.moe", m, q, cfg, sink)
                auxes.append(aux)
            else:
                m = _dense(p, f"{blk}.Dense_1",
                           F.gelu(_dense(p, f"{blk}.Dense_0", m, q), approximate="tanh"), q)
            tok = tok + gate_m * m
        s_f, g_f = _dense(p, "_Modulation_0.Dense_0", F.silu(c), q)[:, None, :].chunk(2, -1)
        tok = _dense(p, "head", _ln(tok) * (1.0 + g_f) + s_f, q)
        out = tok.reshape(b, gh, gw, p_sz, p_sz, cc).permute(0, 1, 3, 2, 4, 5)
        aux = sum(auxes) / len(auxes) if auxes else 0.0
        return out.reshape(b, hh, ww, cc), aux

    return forward
