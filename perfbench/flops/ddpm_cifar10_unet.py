"""Model FLOPs of ``ddpm_cifar10_unet``, counted from the configuration's
shapes: every convolution (2 Ho Wo Cout Cin k^2; a transposed one 2 Hin
Win Cin Cout k^2), dense layer (2 rows in out) and the linear attention's
two products (2 N D^2 a head each), per image and forward pass.  Norms,
activations, softmax and adds are not counted.  A training step counts
three forward passes (the backward twice the forward)."""
from __future__ import annotations


def forward_flops(cfg: dict) -> float:
    dim, ch, size = cfg["hidden_dim"], cfg["channels"], cfg["width"]
    dims = [ch] + [dim * m for m in cfg["dim_mults"]]
    in_out = list(zip(dims[:-1], dims[1:]))
    heads, dim_head = 4, 32
    hidden = heads * dim_head
    total = 0.0

    def conv(hw, ci, co, k):
        return 2.0 * hw * co * ci * k * k

    def resnet(hw, ci, co):
        f = conv(hw, ci, co, 3) + 2.0 * dim * co + conv(hw, co, co, 3)
        return f + (conv(hw, ci, co, 1) if ci != co else 0.0)

    def attn(hw, c):
        return 2.0 * hw * c * 3 * hidden + 2 * 2.0 * heads * hw * dim_head ** 2 \
            + conv(hw, hidden, c, 1)

    total += 2.0 * dim * 4 * dim * 2                  # the time MLP
    side, d_in = size, ch
    for ind, (_, d_out) in enumerate(in_out):
        hw = side * side
        total += resnet(hw, d_in, d_out) + resnet(hw, d_out, d_out) + attn(hw, d_out)
        if ind < len(in_out) - 1:
            side //= 2
            total += conv(side * side, d_out, d_out, 3)
        d_in = d_out
    hw, mid = side * side, dims[-1]
    total += 2 * resnet(hw, mid, mid) + attn(hw, mid)
    for d_in, d_out in reversed(in_out[1:]):
        total += resnet(hw, 2 * d_out, d_in) + resnet(hw, d_in, d_in) + attn(hw, d_in)
        total += 2.0 * hw * d_in * d_in * 16           # 4x4 transposed conv, stride 2
        side *= 2
        hw = side * side
    total += conv(hw, dims[1], dims[1], 3) + conv(hw, dims[1], ch, 1)
    return total


def train_flops(cfg: dict) -> float:
    return 3.0 * forward_flops(cfg)
