"""Model FLOPs of ``ddpm_cifar10_dit_moe8``, counted from the
configuration's shapes: every dense layer (2 rows in out), the attention's
two products (2 N^2 hd a head each), the router, and each token's one
expert MLP (top-1: the tokens routed, not the slots an implementation
pads its expert buffers to), per image and forward pass.  Norms,
activations, softmax and adds are not counted.  A training step counts
three forward passes (the backward twice the forward)."""
from __future__ import annotations


def forward_flops(cfg: dict) -> float:
    d, p, ch = cfg["hidden_dim"], cfg["patch"], cfg["channels"]
    n = (cfg["width"] // p) * (cfg["height"] // p)
    heads, e, every = cfg["heads"], cfg["moe_experts"], cfg["moe_every"]
    mlp = 4 * d
    total = 2.0 * n * p * p * ch * d + 2.0 * 256 * d + 2.0 * d * d
    for i in range(cfg["depth"]):
        total += 2.0 * d * 6 * d                         # adaLN modulation
        total += 2.0 * n * d * 3 * d + 2.0 * n * d * d     # qkv, proj
        total += 2 * 2.0 * heads * n * n * (d // heads)    # q k^T, probs v
        total += 2 * 2.0 * n * d * mlp                     # the MLP or the token's expert
        if e and i % every == every - 1:
            total += 2.0 * n * d * e                       # the router
    total += 2.0 * d * 2 * d + 2.0 * n * d * p * p * ch
    return total


def train_flops(cfg: dict) -> float:
    return 3.0 * forward_flops(cfg)
