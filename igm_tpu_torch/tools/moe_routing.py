"""The Switch-MoE DiT's routing on the card against the CPU.

A full-width MoE DiT (384 wide, 8 deep, 6 heads, 8 experts every 2nd
block, scatter dispatch) with seeded Flax-default weights, each moved by
0.05 N(0, 1), runs one float32 forward (TF32 off) on the CPU and on the
card from the same inputs.  ``--dense-first`` draws a dense DiT's weights
from the generator before the MoE DiT's, as ``chip_smoke.py``'s
``dit_reference`` does.  For every MoE block and token it compares the
expert each side routed the token to and whether the token kept a slot
(its position among the tokens routed there below the capacity), and
prints the tokens where they differ with each one's top-1 router-logit
margin (the CPU's logits: the largest minus the second), beside the
forward's largest difference.  A difference whose margin is within float
rounding of the logits is a near-tie, which the other side's summation
order decides; a larger one is a fault.

    python -m igm_tpu_torch.tools.moe_routing [--batch 4] [--seed 21] [--seeds 1]
        [--dense-first]

It prints one JSON object a seed (``--seeds`` N: seed, seed + 1, ...).
Run it in two checkouts to compare their routing.
"""
from __future__ import annotations

import argparse
import json
import math

import torch

WIDTH = dict(dim=384, depth=8, heads=6, patch=2, channels=3, moe_experts=8, moe_every=2,
             moe_dispatch="scatter")


def _seeded(gen: torch.Generator, moe: bool = True):
    from igm_tpu_torch.networks.dit import DiT
    width = WIDTH if moe else {k: v for k, v in WIDTH.items() if not k.startswith("moe")}
    net = DiT(**width).eval()
    for m in net.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return net


def _forward(net, x, t) -> tuple:
    """The output and each MoE block's router logits, (block, [n, E])."""
    from igm_tpu_torch.networks.moe import SwitchMoE
    logits, hooks = [], []
    for name, module in net.named_modules():
        if isinstance(module, SwitchMoE):
            hooks.append(module.router.register_forward_hook(
                lambda mod, args, out, name=name: logits.append((name, out.detach().float()))))
    with torch.no_grad():
        out = net(x, t)
    for h in hooks:
        h.remove()
    return out, logits


def _route(logits: torch.Tensor, cap: int) -> tuple:
    """Each token's expert and whether it keeps a slot."""
    idx = torch.softmax(logits, dim=-1).argmax(dim=-1)
    onehot = torch.nn.functional.one_hot(idx, logits.shape[-1]).float()
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    return idx, pos < cap


def routing_gap(batch: int = 4, seed: int = 21, dense_first: bool = False) -> dict:
    """The card's routing against the CPU's at ``batch`` (module doc)."""
    from igm_tpu_torch.utils.platform import set_numerics
    set_numerics()
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, 32, 32, 3, generator=gen)
    t = torch.rand(batch, generator=gen) * 999
    if dense_first:
        _seeded(gen, moe=False)
    net = _seeded(gen)
    want, cpu = _forward(net, x, t)
    net.to("cuda")
    got, card = _forward(net, x.cuda(), t.cuda())
    tokens = []
    for (name, lc), (_, lg) in zip(cpu, card):
        lg = lg.cpu()
        moe = net.get_submodule(name)
        cap = moe.capacity(lc.shape[0])
        ic, kc = _route(lc, cap)
        ig, kg = _route(lg, cap)
        top2 = lc.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        for i in torch.nonzero((ic != ig) | (kc != kg)).flatten().tolist():
            tokens.append(dict(block=name, token=i, expert_cpu=int(ic[i]), expert_card=int(ig[i]),
                               kept_cpu=bool(kc[i]), kept_card=bool(kg[i]),
                               margin=float(margin[i]),
                               logit_abs_max=float(lc[i].abs().max()),
                               card_logit_err=float((lg[i] - lc[i]).abs().max())))
    err = float((got.cpu() - want).abs().max())
    scale = float(want.abs().max())
    # a flip of the expert moves the positions of later tokens routed to
    # either expert, so only the tokens whose own expert flipped are causes
    flips = [tok for tok in tokens if tok["expert_cpu"] != tok["expert_card"]]
    return dict(batch=batch, seed=seed, dense_first=dense_first, tokens_differing=len(tokens),
                expert_flips=len(flips),
                largest_flip_margin=max((tok["margin"] for tok in flips), default=None),
                forward_max_abs_err=err, output_abs_max=scale,
                tokens=tokens[:64], finite=math.isfinite(err),
                card=torch.cuda.get_device_name(0))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--seed", type=int, default=21)
    parser.add_argument("--seeds", type=int, default=1)
    parser.add_argument("--dense-first", action="store_true")
    args = parser.parse_args(argv)
    for seed in range(args.seed, args.seed + args.seeds):
        print(json.dumps(routing_gap(args.batch, seed, args.dense_first)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
