"""DiT, the patch-token diffusion transformer: counterpart of
``igm_tpu/networks/dit.py`` (``_sincos_2d``, ``_Modulation``,
``_layernorm_f32``, ``DiTBlock``, ``DiT``).

Call signature as the UNet's: ``(x NHWC, time (B,), y optional (B,) int)``
-> NHWC prediction (float32), so the models swap backbones with
``model.network=dit``.

Submodules carry Flax's names (``patch_embed``, ``Dense_0``, ``Dense_1``,
``class_emb``, ``DiTBlock_{i}/{_Modulation_0/Dense_0, qkv, proj, Dense_0,
Dense_1, moe}``, ``_Modulation_0``, ``head``), so ``interop.flax_to_torch``
maps an ``igm_tpu`` tree onto the ``state_dict``; the stacked ``blocks``
tree of ``block_mode="scan"`` is split onto the per-block modules there.

Numerics follow ``igm_tpu``'s with a compute ``dtype`` (bfloat16 on the
card): the residual stream is in ``dtype``; LayerNorm statistics are
float32 and its output goes back to the stream's dtype; the attention
logits are the float32 accumulator of the q.k products (not rounded to
``dtype``), the softmax is float32, the probabilities are cast to
``dtype`` and the probs.v product comes out float32 again before the cast
for ``proj``; the output head is a float32 Dense on float32 tokens.  In
bfloat16 both products run as ``torch.bmm(..., out_dtype=torch.float32)``
(bf16 tensor-core products, float32 results); their backward rounds the
logits' float32 cotangent to bfloat16 before its products (``_ProductF32``).

``attn``: ``auto`` and ``xla`` the explicit product-softmax-product;
``remat`` the same core recomputed in the backward
(``torch.utils.checkpoint``); ``flash`` ``F.scaled_dot_product_attention``,
the counterpart of the stock flash kernel ``igm_tpu`` calls there, with
its rule that the token count be a multiple of 128.

Initialisation is Flax's defaults, not the port's torch-parity ``Dense``:
lecun_normal (truncated normal) kernels and zero biases, exact zeros for
every ``_Modulation`` and the ``head`` kernel (adaLN-Zero: the network
outputs exactly 0 at init), N(0, 1/dim) for ``class_emb``
(``num_classes + 1`` rows, the last the null token).

Tensor parallelism (``mesh.mode=tensor``, ``parallel/tensor.py``): a
block bound to such a mesh (``bind_mesh``) computes with its
rank's shards of the column layers (``qkv``, ``Dense_0``,
``_Modulation_0/Dense_0``) and row layers (``proj``, ``Dense_1``), which
the model's sharding put in the modules: the local heads' attention
where the model axis divides the heads, else every head's from the
gathered ``qkv``; a Switch-MoE MLP its rank's experts (expert
parallelism, ``networks/moe.py``).

Pipeline parallelism (``pipe_mesh``, a mesh with a ``stage`` axis,
``parallel/pipeline.py``): block ``i`` belongs to stage ``i // (depth /
S)`` (its ``pipe_stage``, which the model's sharding reads), and the block
stack runs through ``gpipe_apply`` in ``pipe_microbatches``
microbatches; a batch they do not divide takes them one at a time (the
sequential stack, ``igm_tpu``'s rule for init and eval probes).  On the
stages before the last the head runs on detached parameters and ``c``:
the last stage alone gives the head's gradient.  While the model's state
is whole (``BaseModel.unsharded``) or no mesh is bound the stack runs
sequentially on the rank.

Sequence parallelism (``sp_mesh``, Megatron-SP, ``parallel/tensor.py``
``split_tokens``/``gather_tokens``/``scatter_tokens``) on a bound mesh
with a ``model`` axis: between blocks each model rank holds ``N/m`` of the
tokens (the last padded with zero rows where ``m`` does not divide N, in
the split storage only).  In ``tensor`` mode the block gathers the
tokens before ``qkv`` and the MLP's ``Dense_0`` and reduce-scatters them
after ``proj`` and ``Dense_1`` in place of the all-reduce; LayerNorm,
modulation, gates and residuals run on the rank's tokens, and what they
read whole (the modulation vectors, the row layers' biases) sums its
gradient over the model group (``copy_to_model``).  The final LayerNorm
runs on the rank's tokens; they are gathered before the head (whose FSDP
leaves its own call gathers, their gradient then whole on every rank).
A Switch-MoE block gathers the ``n_tokens`` tokens before its router
(one process's routing order, no padding row routed) and its experts'
summed output is reduce-scattered to the rank's part (``networks/
moe.py``).  In ``fsdp`` mode a block gathers the tokens at its entry and
keeps the rank's part at its exit, and the head runs on all of them.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.causal_attention import flash_full_attention
from ..parallel.mesh import MODEL_AXIS, STAGE_AXIS
from ..parallel.pipeline import block_stage, gpipe_apply
from ..parallel.tensor import (TensorParallel, copy_to_model, gather_features, gather_tokens,
                               reduce_from_model, scatter_tokens, split_tokens)
from .base import FlaxDense, compute_dtype
from .moe import SwitchMoE
from .unet import Embed, sinusoidal_pos_emb


def _sincos_2d(h: int, w: int, dim: int) -> np.ndarray:
    """Fixed 2-D sin/cos position table, (h*w, dim), float32 numpy.  Half
    the channels encode the row index, half the column."""
    assert dim % 4 == 0, "DiT width must be divisible by 4 for 2-D sincos"
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter))

    def axis(pos):  # (n,) -> (n, dim//2)
        args = np.outer(pos, omega)
        return np.concatenate([np.sin(args), np.cos(args)], axis=1)

    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    emb = np.concatenate([axis(gy.reshape(-1)), axis(gx.reshape(-1))], axis=1)
    return emb.astype(np.float32)


class _Modulation(nn.Module):
    """adaLN-Zero projection: conditioning -> ``n_chunks`` (B, 1, dim)
    modulation vectors, zero-initialised."""

    def __init__(self, dim: int, n_chunks: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.n_chunks = n_chunks
        self.Dense_0 = FlaxDense(dim, dim * n_chunks, dtype=dtype, zero_kernel=True)

    def forward(self, c: torch.Tensor, tp=None, seq=None) -> tuple:
        """``tp``: column-parallel over the model group; ``seq``: the
        vectors modulate the rank's tokens alone (sequence parallelism),
        so their gradient is summed over ``seq``'s group."""
        if tp is None:
            y = self.Dense_0(F.silu(c))
        else:       # column-parallel: every rank needs every modulation vector
            y = gather_features(self.Dense_0(copy_to_model(F.silu(c), tp)), tp, partial=False)
        if seq is not None:
            y = copy_to_model(y, seq)
        return torch.chunk(y[:, None, :], self.n_chunks, dim=-1)


def _row(layer: FlaxDense, x: torch.Tensor, tp, seq: bool = False) -> torch.Tensor:
    """A row-parallel layer: the rank's input features' product, summed
    over the model group, then the bias, once; ``seq``: the sum
    reduce-scattered over the tokens (each rank its part) and the bias
    added to them."""
    dt = compute_dtype(x, layer.weight, layer.dtype)
    y = F.linear(x.to(dt), layer.weight.to(dt))
    y = scatter_tokens(y, tp) if seq else reduce_from_model(y, tp)
    if layer.bias is None:
        return y
    return y + (copy_to_model(layer.bias, tp) if seq else layer.bias).to(dt)


def _detached(module: nn.Module, *args):
    """``module(*args)`` on its parameters detached: no gradient reaches
    them."""
    return torch.func.functional_call(
        module, {k: v.detach() for k, v in module.named_parameters()}, args)


def _layernorm_f32(x: torch.Tensor) -> torch.Tensor:
    """Affine-free LayerNorm (eps 1e-6) with float32 statistics, output in
    x's dtype: torch's kernel reads a bfloat16 x into float32, normalises in
    float32 and rounds once to bfloat16, as ``igm_tpu``'s casts around its
    float32 LayerNorm do."""
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


class _ProductF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=torch.float32)`` for bfloat16 a, b on the
    card (its own backward: torch has none for the ``out_dtype`` form).
    The gradients are bfloat16 products with float32 accumulation, rounded
    once to the operand's dtype; the float32 cotangent is rounded to
    bfloat16 first (exact for the probs.v product, whose output is cast to
    bfloat16 next; for the q.k logits it rounds the softmax's cotangent,
    where XLA would multiply it in float32)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.bmm(g, b.transpose(1, 2)), torch.bmm(a.transpose(1, 2), g)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b with a float32 result: float32 operands multiply in
    float32; bfloat16 ones on the card's tensor cores with float32
    accumulation, the accumulator returned unrounded
    (``preferred_element_type``), and off the card as float32 products of
    the same values (exact: a product of two bfloat16 values fits in
    float32)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return _ProductF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, N, H, hd) q, k, v -> (B, N, H, hd) float32: softmax(q.k / sqrt(hd))
    over float32 logits, the probabilities cast to v's dtype, then probs.v
    with a float32 result."""
    b, n, h, hd = q.shape

    def heads(x):                              # (B, N, H, hd) -> (B*H, N, hd)
        return x.permute(0, 2, 1, 3).reshape(b * h, n, hd)

    logits = _product_f32(heads(q), heads(k).transpose(1, 2))
    probs = torch.softmax(logits * (1.0 / math.sqrt(hd)), dim=-1)
    out = _product_f32(probs.to(v.dtype), heads(v))
    return out.reshape(b, h, n, hd).permute(0, 2, 1, 3)


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block: modulated LayerNorm -> fused
    head-grouped qkv -> attention -> proj, gated residual; modulated
    LayerNorm -> MLP (or Switch-MoE) -> gated residual."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype | None = None, attn: str = "xla",
                 moe_experts: int = 0, moe_capacity: float = 1.25,
                 moe_dispatch: str = "auto"):
        super().__init__()
        self.dim, self.heads, self.dtype, self.attn = dim, heads, dtype, attn
        self._Modulation_0 = _Modulation(dim, 6, dtype)
        self.qkv = FlaxDense(dim, 3 * dim, dtype=dtype)
        self.proj = FlaxDense(dim, dim, dtype=dtype)
        if moe_experts:
            self.moe = SwitchMoE(dim, mlp_ratio * dim, moe_experts, moe_capacity,
                                 dtype=dtype, dispatch=moe_dispatch)
        else:
            self.Dense_0 = FlaxDense(dim, mlp_ratio * dim, dtype=dtype)
            self.Dense_1 = FlaxDense(mlp_ratio * dim, dim, dtype=dtype)
        # the last forward's Switch load-balance aux and per-expert load
        # (``igm_tpu`` sows them into its "moe" collection)
        self.moe_aux: Optional[torch.Tensor] = None
        self.moe_load: Optional[torch.Tensor] = None
        # the model axis's share (parallel/tensor.py); None: the whole block
        self.tp = None

    def bind_mesh(self, mesh, blocks: int = 1) -> None:
        """On a model axis in ``tensor`` mode, compute with the rank's
        Megatron shards of the column and row layers, which the model's
        sharding put in the modules (the width must divide by the axis);
        else the whole block."""
        self.tp = None
        if mesh is None or not mesh.sharded or mesh.mode != "tensor":
            return
        m = mesh.size(MODEL_AXIS)
        if self.dim % m:
            raise ValueError(f"mesh.mode=tensor: the DiT width {self.dim} does not split "
                             f"over the model axis of {m}")
        self.tp = TensorParallel.of(mesh, self.heads)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                n_tokens: Optional[int] = None) -> torch.Tensor:
        """``n_tokens``: Megatron-SP on the model group (tensor mode): ``x``
        is the rank's part of the ``n_tokens`` tokens, and so is the
        result."""
        d, h, tp = self.dim, self.heads, self.tp
        hd = d // h
        seq = n_tokens is not None and tp is not None
        s_a, g_a, gate_a, s_m, g_m, gate_m = self._Modulation_0(c, tp, tp if seq else None)

        a = _layernorm_f32(x) * (1.0 + g_a) + s_a
        if seq:
            a = gather_tokens(a, tp, n_tokens, partial=True)
        elif tp is not None:
            a = copy_to_model(a, tp)
        qkv = self.qkv(a)
        b, n, _ = qkv.shape
        if tp is not None:
            if tp.whole_heads:
                h = h // tp.size
            else:       # a head split between ranks: every head, from the whole qkv
                qkv = gather_features(qkv, tp, partial=True)
        # head-grouped packing: each head's q, k, v are one 3*hd block
        q, k, v = torch.split(qkv.reshape(b, n, h, 3 * hd), hd, dim=-1)
        if self.attn == "flash":
            o = flash_full_attention(q, k, v, sm_scale=1.0 / math.sqrt(hd))
        elif self.attn == "remat" and torch.is_grad_enabled():
            o = checkpoint(attention_core, q, k, v, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            o = attention_core(q, k, v)
        o = o.to(self.dtype or torch.float32).reshape(b, n, h * hd)
        if tp is None:
            o = self.proj(o)
        else:
            if not tp.whole_heads:      # the rank's features of proj's input
                o = o.chunk(tp.size, dim=-1)[tp.rank]
            o = _row(self.proj, o, tp, seq)
        x = x + gate_a * o

        m = _layernorm_f32(x) * (1.0 + g_m) + s_m
        if hasattr(self, "moe"):
            if seq:       # the MoE routes the n tokens, in one process's order
                m = gather_tokens(m, tp, n_tokens, partial=False)
            m, self.moe_aux, self.moe_load = self.moe(m, split=seq)
        elif tp is None:
            m = self.Dense_1(F.gelu(self.Dense_0(m), approximate="tanh"))
        else:
            m = gather_tokens(m, tp, n_tokens, partial=True) if seq else copy_to_model(m, tp)
            m = _row(self.Dense_1, F.gelu(self.Dense_0(m), approximate="tanh"), tp, seq)
        return x + gate_m * m


class DiT(nn.Module):
    """Patch-token diffusion transformer.  ``num_classes > 0`` adds the
    class table with a trailing null-token row; ``y`` is then required.
    ``moe_experts > 0`` makes every ``moe_every``-th block's MLP a
    Switch-MoE; :meth:`take_moe_stats` hands over their last aux and load.
    ``block_mode="scan"`` is ``igm_tpu``'s stacked layout, which
    ``interop`` splits onto the same per-block modules: the same
    computation.  ``pipe_mesh`` (with ``block_mode="scan"``) and
    ``sp_mesh``: pipeline and sequence parallelism (the module's
    docstring)."""

    def __init__(self, dim: int = 384, depth: int = 8, heads: int = 6, patch: int = 2,
                 channels: int = 3, mlp_ratio: int = 4, num_classes: int = 0,
                 dtype: torch.dtype | None = None, remat: bool = False,
                 attn: str = "auto", block_mode: str = "unroll", pipe_mesh=None,
                 pipe_microbatches: int = 1, moe_experts: int = 0, moe_every: int = 2,
                 moe_capacity: float = 1.25, moe_dispatch: str = "auto", sp_mesh=None):
        super().__init__()
        self._config = dict(dim=dim, depth=depth, heads=heads, patch=patch, channels=channels,
                            mlp_ratio=mlp_ratio, num_classes=num_classes, dtype=dtype,
                            remat=remat, attn=attn, block_mode=block_mode,
                            pipe_mesh=pipe_mesh, pipe_microbatches=pipe_microbatches,
                            moe_experts=moe_experts, moe_every=moe_every,
                            moe_capacity=moe_capacity, moe_dispatch=moe_dispatch,
                            sp_mesh=sp_mesh)
        if block_mode not in ("unroll", "scan"):
            raise ValueError(f"block_mode must be unroll|scan, got {block_mode!r}")
        if (block_mode == "scan" or pipe_mesh is not None) and moe_experts:
            raise ValueError("moe_experts needs the unrolled block layout "
                             "(block_mode='unroll')")
        if pipe_mesh is not None and STAGE_AXIS not in pipe_mesh.axis_names:
            raise ValueError("pipe_mesh needs a 'stage' axis")
        if sp_mesh is not None and pipe_mesh is not None:
            raise ValueError("sp_mesh and pipe_mesh are mutually exclusive")
        self.pipe_mesh, self.pipe_microbatches = pipe_mesh, int(pipe_microbatches)
        self.sp_mesh = sp_mesh
        # the mesh the model bound (bind_mesh); the pipeline runs while the
        # blocks are split (the model's state is not whole)
        self.mesh = None
        self._pipelined = pipe_mesh is not None
        attn = "xla" if attn == "auto" else attn
        if attn not in ("xla", "remat", "flash"):
            raise ValueError(f"attn must be auto|xla|remat|flash, got {attn!r}")
        self.dim, self.depth, self.patch, self.channels = dim, depth, patch, channels
        self.num_classes, self.dtype, self.remat, self.attn = num_classes, dtype, remat, attn
        self.patch_embed = FlaxDense(patch * patch * channels, dim, dtype=dtype)
        self.Dense_0 = FlaxDense(256, dim, dtype=dtype)
        self.Dense_1 = FlaxDense(dim, dim, dtype=dtype)
        if num_classes:
            self.class_emb = Embed(num_classes + 1, dim)
        self.blocks = []
        for i in range(depth):
            moe = (moe_experts if moe_experts and i % max(1, moe_every) == moe_every - 1
                   else 0)
            block = DiTBlock(dim, heads, mlp_ratio, dtype, attn, moe, moe_capacity,
                             moe_dispatch)
            if pipe_mesh is not None:
                block.pipe_stage = block_stage(i, depth, pipe_mesh.size(STAGE_AXIS))
            self.add_module(f"DiTBlock_{i}", block)
            self.blocks.append(block)
        self._Modulation_0 = _Modulation(dim, 2, dtype)
        self.head = FlaxDense(dim, patch * patch * channels, zero_kernel=True)
        self._pos: dict = {}

    def clone(self, **changes) -> "DiT":
        """A new DiT of this one's keywords with ``changes`` (Flax's
        ``Module.clone``), its parameters drawn anew."""
        return DiT(**{**self._config, **changes})

    def bind_mesh(self, mesh, blocks: int = 1) -> None:
        """The model's mesh (None: one process): the pipeline runs on a
        ``pipeline``-mode mesh (the blocks split between the stages), the
        sequence split on one with a model axis."""
        self.mesh = mesh
        self._pipelined = (self.pipe_mesh is not None and mesh is not None
                           and mesh.mode == "pipeline")

    def _sequence(self) -> Optional[TensorParallel]:
        """The model group that splits the tokens (None: no split)."""
        if self.sp_mesh is None:
            return None
        if MODEL_AXIS not in self.sp_mesh.axis_names:
            raise ValueError("sp_mesh needs a 'model' axis")
        mesh = self.mesh
        if mesh is None or mesh.size(MODEL_AXIS) < 2:
            return None
        return TensorParallel.of(mesh, self.blocks[0].heads)

    def _block(self, block: "DiTBlock", tok, c, n_tokens=None):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, tok, c, n_tokens, use_reentrant=False,
                              preserve_rng_state=False)
        return block(tok, c, n_tokens)

    def _blocks(self, tok: torch.Tensor, c: torch.Tensor, n: int,
                seq: Optional[TensorParallel]) -> torch.Tensor:
        """The block stack: through the pipeline, the sequence split over
        ``seq``, or in order on the rank."""
        if self._pipelined:
            micro = self.pipe_microbatches
            if tok.shape[0] % micro:      # igm_tpu's rule: the sequential stack
                micro = 1
            return gpipe_apply(lambda block, x, cc: self._block(block, x, cc), self.blocks,
                               tok, c, self.pipe_mesh, micro)
        if seq is None:
            for block in self.blocks:
                tok = self._block(block, tok, c)
            return tok
        tok = split_tokens(tok, seq)
        for block in self.blocks:
            if block.tp is not None:          # Megatron-SP inside the block
                tok = self._block(block, tok, c, n)
            else:                             # whole blocks: all tokens in, the rank's out
                tok = split_tokens(self._block(block, gather_tokens(tok, seq, n, False), c),
                                   seq)
        return tok

    def _pos_table(self, gh: int, gw: int, device) -> torch.Tensor:
        """The (gh*gw, dim) position table on ``device``, built once per
        grid (on a first call, which runs eagerly before any graph
        capture)."""
        key = (gh, gw, str(device))
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(_sincos_2d(gh, gw, self.dim)).to(device)
        return self._pos[key]

    def take_moe_stats(self) -> list:
        """(aux, load) of each MoE block's last forward, in block order; the
        blocks let go of them (a kept aux would keep the step's autograd
        graph alive into the next step, which a CUDA graph capture of the
        next step cannot take)."""
        stats = []
        for blk in self.blocks:
            if hasattr(blk, "moe"):
                stats.append((blk.moe_aux, blk.moe_load))
                blk.moe_aux = blk.moe_load = None
        return stats

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, hh, ww, cc = x.shape
        p = self.patch
        if hh % p or ww % p:
            raise ValueError(f"image {hh}x{ww} not divisible by patch {p}")
        gh, gw = hh // p, ww // p
        if self.attn == "flash" and (gh * gw) % 128:
            raise ValueError(f"attn=flash needs token count % 128 == 0, got {gh * gw}")

        tok = x.reshape(b, gh, p, gw, p, cc).permute(0, 1, 3, 2, 4, 5)
        tok = self.patch_embed(tok.reshape(b, gh * gw, p * p * cc))
        tok = tok + self._pos_table(gh, gw, tok.device)[None].to(tok.dtype)

        c = self.Dense_1(F.silu(self.Dense_0(sinusoidal_pos_emb(time, 256))))
        if self.num_classes:
            if y is None:
                raise ValueError("conditional DiT (num_classes>0) needs y")
            c = c + self.class_emb(y).to(c.dtype)

        n = gh * gw
        seq = self._sequence()
        tok = self._blocks(tok, c, n, seq)
        if seq is not None and not self.blocks[0].tp:
            tok, seq = gather_tokens(tok, seq, n, False), None   # fsdp: the head whole

        if self._pipelined and self.pipe_mesh.coord(STAGE_AXIS) < self.pipe_mesh.size(
                STAGE_AXIS) - 1:
            # the last stage's head gives its gradient: here the same values, detached
            s_f, g_f = _detached(self._Modulation_0, c.detach())
            tok = _layernorm_f32(tok) * (1.0 + g_f) + s_f
            tok = _detached(self.head, tok.float())
        elif seq is not None:    # Megatron-SP: the final LayerNorm on the rank's tokens
            s_f, g_f = self._Modulation_0(c, seq=seq)
            tok = _layernorm_f32(tok) * (1.0 + g_f) + s_f
            # the head (its FSDP leaves gathered by its own call) on all of them
            tok = self.head(gather_tokens(tok, seq, n, False).float())
        else:
            s_f, g_f = self._Modulation_0(c)
            tok = _layernorm_f32(tok) * (1.0 + g_f) + s_f
            tok = self.head(tok.float())
        out = tok.reshape(b, gh, gw, p, p, cc).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, hh, ww, cc)
