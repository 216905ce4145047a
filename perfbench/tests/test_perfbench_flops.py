"""The benchmark's FLOP counts read what ``torch.utils.flop_counter``
counts over the plain references' forward passes at small sizes (a
training step is three forward passes by definition), and the copied
kernel-bound arithmetic gives the bounds ``PERF.md``'s kernel table
states at its shapes."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _tiny import bench
from perfbench.harness import device as dev
from perfbench.harness.weights import make_weights

SMALL = {
    "ddpm_cifar10_unet": {"hidden_dim": 8, "dim_mults": [1, 2, 4]},
    # capacity factor E: no token is dropped, so every routed token's expert runs
    "ddpm_cifar10_dit_moe8": {"hidden_dim": 32, "depth": 4, "heads": 2, "moe_capacity": 8.0},
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_counted_flops_match_the_flop_counter(name):
    torch.set_num_threads(1)
    cfg = bench.config(name)
    sizes = {**bench.sizes(cfg), **SMALL[name], "width": 16, "height": 16}
    ref = bench.reference(name)
    weights = make_weights(ref.param_shapes(sizes), 3, "cpu")
    x = torch.randn(2, 16, 16, 3)
    t = torch.tensor([3, 700])
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.make_forward(sizes)(weights, x, t, lambda z: z)
    counted = bench.flops(name)
    assert counter.get_total_flops() == 2 * counted.forward_flops(sizes)
    assert counted.train_flops(sizes) == 3 * counted.forward_flops(sizes)


def test_kernel_bounds_match_the_kernel_table():
    flagship = {"channels": 3, "hidden_dim": 64, "dim_mults": [1, 2, 4], "width": 32}
    gn, la = dev.unet_kernel_calls(flagship)
    # chip_smoke.py GN_SHAPES and LA_SHAPES: calls a UNet forward
    assert sorted({s: gn.count(s) for s in gn}.items()) == sorted(
        {(32, 32, 64): 5, (16, 16, 128): 4, (8, 8, 256): 8, (8, 8, 128): 4,
         (16, 16, 64): 4}.items())
    assert sorted(la) == sorted([1024, 256, 256, 64, 64, 64])
    ms = {k: 1e3 * v for k, v in dev.unet_bounds(flagship, 256).items()
          if k not in ("gn_calls", "la_calls")}
    # PERF.md's kernel table, batch 256 bf16, all calls of one UNet pass
    assert round(ms["gn"], 3) == 0.210
    assert round(ms["gn_bwd"], 3) == 0.316
    assert round(ms["la"], 3) == 0.135
    assert round(ms["la_bwd"], 3) == 0.237
    assert round(1e3 * dev.unet_bounds(flagship, 64)["gn"], 3) == 0.053


def test_roofline_share_counts_whole_passes():
    flagship = {"channels": 3, "hidden_dim": 64, "dim_mults": [1, 2, 4], "width": 32}
    b = dev.unet_bounds(flagship, 128)
    summary = {"kernels": {"group_norm_mish_onepass_kernel": 2 * b["gn"] * 2,
                           "linear_attention_mma_kernel": 2 * b["la"] * 4},
               "launches": {"group_norm_mish_onepass_kernel": 50,
                            "linear_attention_mma_kernel": 12}}
    share = dev.roofline_share(summary, flagship, 128, ("gn", "la"))
    assert share == pytest.approx(100 * (2 * b["gn"] + 2 * b["la"])
                                  / (4 * b["gn"] + 8 * b["la"]))
    assert dev.roofline_share({"kernels": {}, "launches": {}}, flagship, 128, ("gn",)) is None
