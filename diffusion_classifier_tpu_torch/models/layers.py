"""Shared building blocks — port of ``models/layers.py``.

Mixed precision follows flax: parameters stay float32, and each ``Dense``
or ``Conv2d`` casts its input, weight and bias to the module's compute dtype
at the call (flax ``nn.Dense(dtype=...)``). No ``torch.autocast``, which
places its casts elsewhere. Images stay NHWC between modules; a conv views
its input as NCHW (``permute``, channels-last strides, no copy) for
``F.conv2d`` and views the result back.

Normalisation keeps the JAX module's arithmetic:

- :func:`group_norm` sums its statistics in float32, but a bf16 input's
  squares are formed in bf16 before the sum (``group_norm_mxu``); the
  per-channel ``w``/``b`` are folded in float32 and cast to the input dtype,
  so ``y = x·w + b`` rounds in that dtype. GroupNorm eps is 1e-5, 1e-6 in
  front of a :class:`SpatialTransformer`.
- :class:`LayerNorm` computes in float32 (flax ``LayerNorm(dtype=float32)``,
  variance ``E[x²] − E[x]²`` clipped at 0) and returns float32; the blocks
  cast back to the compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling

from ..ops.attention import attention
from ..parallel.collectives import copy_to_group, gather_from_group, reduce_from_group

__all__ = [
    "AttentionBlock2D",
    "BasicTransformerBlock",
    "Conv2d",
    "Dense",
    "Downsample2D",
    "GEGLUFeedForward",
    "GroupNorm",
    "LayerNorm",
    "MultiHeadAttention",
    "ResnetBlock2D",
    "SpatialTransformer",
    "TimestepEmbedding",
    "Upsample2D",
    "group_norm",
    "layer_norm",
    "lecun_normal_",
    "reset_parameters",
    "sinusoidal_embedding",
]


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init: normal with variance 1/fan_in, truncated at 2σ."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # truncation correction
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


class Dense(nn.Module):
    """``y = x·Wᵀ + b`` computed in ``dtype`` from float32 parameters (flax ``nn.Dense``).

    ``weight`` is ``[out, in]`` (torch's layout; the flax kernel transposed).
    Under tensor parallelism ``tp`` (a ``parallel.sharding.TPSpec``) holds
    the layer's part: a column layer holds a row slice of the weight and
    the bias, a row layer a column slice, its partial products summed over
    the model group before the whole bias is added.
    """

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32, *, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.tp = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight.data, self.weight.shape[1], generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        tp = self.tp
        if tp is None:
            return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)
        if tp.kind == "row":
            y = reduce_from_group(F.linear(x.to(self.dtype), self.weight.to(self.dtype)), tp.group)
            return y if bias is None else y + bias
        y = F.linear(copy_to_group(x.to(self.dtype), tp.group), self.weight.to(self.dtype), bias)
        return gather_from_group(y, tp.group) if tp.gather else y


class Conv2d(nn.Module):
    """NHWC convolution in ``dtype`` from float32 parameters (flax ``nn.Conv``).

    ``weight`` is OIHW (the flax HWIO kernel transposed); padding is
    symmetric, as flax's integer ``padding``; ``bias=False`` is flax's
    ``use_bias=False``.
    """

    def __init__(
        self, in_ch: int, out_ch: int, kernel: int, dtype=torch.float32, *,
        stride: int = 1, padding: int = 0, bias: bool = True,
    ):
        super().__init__()
        self.dtype, self.stride, self.padding = dtype, stride, padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight.data, self.weight[0].numel(), generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(x.to(self.dtype), self.weight, self.bias, self.stride, self.padding)


def conv_nhwc(x, weight, bias, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``F.conv2d`` on an NHWC tensor in ``x.dtype``; ``weight`` OIHW, ``bias`` may be None."""
    bias = bias.to(x.dtype) if bias is not None else None
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), bias, stride, padding)
    return y.permute(0, 2, 3, 1)


def sinusoidal_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal embedding of a ``[B]`` float vector → ``[B, dim]`` (float32).

    diffusers ``Timesteps``; the "timesteps" here are continuous logSNR values.
    """
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - freq_shift)
    emb = timesteps.to(torch.float32)[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting the sinusoidal embedding to ``time_embed_dim``."""

    def __init__(self, in_dim: int, time_embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.linear_1 = Dense(in_dim, time_embed_dim, dtype)
        self.linear_2 = Dense(time_embed_dim, time_embed_dim, dtype)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


def group_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, num_groups: int, eps: float
) -> torch.Tensor:
    """GroupNorm over the channels of a ``[N, ..., C]`` tensor, in ``group_norm_mxu``'s arithmetic.

    The span ``norm.group`` (``utils/profiling.py``).
    """
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"groups {num_groups} must divide channels {c}")
    with profiling.span("norm.group"):
        cg = c // num_groups
        xg = x.reshape(n, -1, num_groups, cg)
        count = xg.shape[1] * cg
        # squares in x.dtype (bf16 rounds them), sums in float32
        s_g = xg.sum(dim=(1, 3), dtype=torch.float32)
        ss_g = (xg * xg).sum(dim=(1, 3), dtype=torch.float32)
        mean = s_g / count
        var = torch.clamp(ss_g / count - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        mean_c = mean.repeat_interleave(cg, dim=1)  # [n, c]
        inv_c = inv.repeat_interleave(cg, dim=1)
        w = (inv_c * scale[None, :]).to(x.dtype)
        b = (bias[None, :] - mean_c * inv_c * scale[None, :]).to(x.dtype)
        y = x.reshape(n, -1, c) * w[:, None, :] + b[:, None, :]
        return y.reshape(x.shape)


class GroupNorm(nn.Module):
    """:func:`group_norm` with float32 ``weight`` (flax ``scale``) and ``bias`` (``GroupNormF32``)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, num_groups=self.num_groups, eps=self.eps)


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """flax ``LayerNorm(use_bias=False, use_scale=False, dtype=float32)``: float32 out; the span ``norm.layer``."""
    with profiling.span("norm.layer"):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (xf - mean) * torch.rsqrt(var + eps)


class LayerNorm(nn.Module):
    """flax ``LayerNorm(epsilon, dtype=float32)`` with scale and bias: float32 out."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.eps) * self.weight + self.bias


class ResnetBlock2D(nn.Module):
    """GN→SiLU→conv3×3, + time embedding, GN→SiLU→dropout→conv3×3, 1×1 shortcut on a channel change.

    ``in_ch`` counts the skip's channels when the block is given one
    (``forward(x, temb, skip)``): its input is then ``concat([x, skip])``,
    computed split-wise when each half's channels are a whole number of
    GroupNorm groups — GroupNorm per half (``gh = groups·xc / in_ch`` groups
    on the x half), conv1 and the shortcut per half on input-channel slices
    of their weights, the skip half's conv1 without bias — and by an actual
    concat when the groups straddle the boundary (``layers.py:203-217``).
    The flax tree's flat names map onto the submodules: ``norm1_scale`` →
    ``norm1.weight``, ``conv1_kernel`` → ``conv1.weight``,
    ``shortcut_kernel [in, out]`` → ``shortcut.weight [out, in]``,
    ``time_emb_kernel`` → ``time_emb.weight``.

    Dropout (``dropout > 0``, before conv2) applies only under
    ``deterministic=False``, as in the flax block; the module's
    ``training`` flag plays no part. Its mask comes from torch's default
    generator, whose state ``torch.utils.checkpoint`` restores when a
    rematerialised block is recomputed.
    """

    def __init__(
        self, in_ch: int, out_ch: int, temb_dim: int, *, dropout: float = 0.0,
        groups: int = 32, eps: float = 1e-5, dtype=torch.float32,
    ):
        super().__init__()
        self.groups, self.dropout, self.dtype = groups, dropout, dtype
        self.norm1 = GroupNorm(in_ch, groups, eps)
        self.conv1 = Conv2d(in_ch, out_ch, 3, dtype, padding=1)
        self.time_emb = Dense(temb_dim, out_ch, dtype)
        self.norm2 = GroupNorm(out_ch, groups, eps)
        self.conv2 = Conv2d(out_ch, out_ch, 3, dtype, padding=1)
        self.shortcut = Dense(in_ch, out_ch, dtype) if in_ch != out_ch else None

    def _gn_silu(self, x, norm: GroupNorm, lo: int, hi: int, groups: int):
        return F.silu(group_norm(
            x, norm.weight[lo:hi], norm.bias[lo:hi], num_groups=groups, eps=norm.eps
        ))

    def forward(
        self, x: torch.Tensor, temb: torch.Tensor, skip: Optional[torch.Tensor] = None,
        *, deterministic: bool = True,
    ) -> torch.Tensor:
        split = False
        if skip is not None:
            if x.shape[-1] % ((x.shape[-1] + skip.shape[-1]) // self.groups) == 0:
                split = True
            else:  # groups straddle the boundary: concat
                x, skip = torch.cat([x, skip], dim=-1), None
        in_ch = self.norm1.weight.shape[0]
        w1 = self.conv1.weight
        if not split:
            h = self.conv1(self._gn_silu(x, self.norm1, 0, in_ch, self.groups))
        else:
            xc = x.shape[-1]
            gh = self.groups * xc // in_ch
            hx = self._gn_silu(x, self.norm1, 0, xc, gh)
            hs = self._gn_silu(skip, self.norm1, xc, in_ch, self.groups - gh)
            h = conv_nhwc(hx.to(self.dtype), w1[:, :xc], self.conv1.bias, padding=1)
            h = h + conv_nhwc(hs.to(self.dtype), w1[:, xc:], None, padding=1)
        h = h + self.time_emb(F.silu(temb))[:, None, None, :]
        h = F.silu(group_norm(
            h, self.norm2.weight, self.norm2.bias, num_groups=self.groups, eps=self.norm2.eps
        ))
        if self.dropout > 0.0 and not deterministic:
            h = F.dropout(h, self.dropout, training=True)
        h = self.conv2(h)

        if self.shortcut is None:
            return (torch.cat([x, skip], dim=-1) if split else x) + h
        w, b = self.shortcut.weight.to(self.dtype), self.shortcut.bias.to(self.dtype)
        if not split:
            res = F.linear(x.to(self.dtype), w)
        else:
            xc = x.shape[-1]
            res = F.linear(x.to(self.dtype), w[:, :xc]) + F.linear(skip.to(self.dtype), w[:, xc:])
        return (res + b) + h


class MultiHeadAttention(nn.Module):
    """Q/K/V projections (no bias), attention through ``ops/attention.py``, output projection.

    Self-attention when ``context_dim`` is None. With ``one_token_context``
    the context is a single token: softmax over one key is 1, so the output
    is ``to_out(broadcast(to_v(context)))`` and the module has no
    ``to_q``/``to_k`` — as the flax tree, which never creates them. Under
    tensor parallelism the projections hold whole heads, and the head count
    comes from the local width.
    """

    def __init__(
        self, dim: int, num_heads: int, head_dim: int, dtype=torch.float32, *,
        context_dim: Optional[int] = None, one_token_context: bool = False,
        attn_backend: str = "xla",
    ):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.one_token_context, self.attn_backend = one_token_context, attn_backend
        ctx_dim = dim if context_dim is None else context_dim
        if not one_token_context:
            self.to_q = Dense(dim, inner, dtype, bias=False)
            self.to_k = Dense(ctx_dim, inner, dtype, bias=False)
        self.to_v = Dense(ctx_dim, inner, dtype, bias=False)
        self.to_out = Dense(inner, dim, dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, sq, _ = x.shape
        sk = ctx.shape[1]
        v = self.to_v(ctx)
        if self.one_token_context:
            if sk != 1:
                raise ValueError(f"built for a one-token context, got {sk} tokens")
            # to_out per row, then broadcast: the same values as to_out(broadcast(v))
            return self.to_out(v).expand(b, sq, -1)
        d = self.head_dim
        h = v.shape[-1] // d  # this rank's heads
        q = self.to_q(x).view(b, sq, h, d)
        k = self.to_k(ctx).view(b, sk, h, d)
        o = attention(q, k, v.view(b, sk, h, d), backend=self.attn_backend)
        return self.to_out(o.reshape(b, sq, h * d))


class GEGLUFeedForward(nn.Module):
    """``Linear(d, 8d) → split → x·gelu_tanh(gate) → Linear(4d, d)`` (flax ``nn.gelu`` is the tanh form).

    Under tensor parallelism ``proj_in`` holds matching slices of the value
    and gate halves, so the split pairs them on every rank.
    """

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.proj_in = Dense(dim, 2 * mult * dim, dtype)
        self.proj_out = Dense(mult * dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(h * F.gelu(gate, approximate="tanh"))


class BasicTransformerBlock(nn.Module):
    """LayerNorm + self-attention, LayerNorm + cross-attention, LayerNorm + GEGLU (pre-norm residuals).

    ``context_tokens``: None — no cross-attention; 1 — the one-token
    shortcut, which needs neither ``norm2`` nor ``to_q``/``to_k``; more —
    full cross-attention.
    """

    def __init__(
        self, dim: int, num_heads: int, head_dim: int, dtype=torch.float32, *,
        context_dim: Optional[int] = None, context_tokens: Optional[int] = None,
        attn_backend: str = "xla",
    ):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn1 = MultiHeadAttention(dim, num_heads, head_dim, dtype, attn_backend=attn_backend)
        self.attn2 = self.norm2 = None
        if context_tokens is not None:
            if context_tokens > 1:
                self.norm2 = LayerNorm(dim)
            self.attn2 = MultiHeadAttention(
                dim, num_heads, head_dim, dtype, context_dim=context_dim,
                one_token_context=context_tokens == 1, attn_backend=attn_backend,
            )
        self.norm3 = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x).to(self.dtype))
        if (context is None) != (self.attn2 is None):
            raise ValueError("the context must be given exactly when the block has cross-attention")
        if self.attn2 is not None:
            h = x if self.norm2 is None else self.norm2(x).to(self.dtype)
            x = x + self.attn2(h, context)
        return x + self.ff(self.norm3(x).to(self.dtype))


class AttentionBlock2D(nn.Module):
    """GroupNorm → self-attention over the ``H·W`` tokens → + residual (diffusers ``AttnDownBlock2D``)."""

    def __init__(
        self, channels: int, num_heads: int, head_dim: int, *, groups: int = 32,
        dtype=torch.float32, attn_backend: str = "xla",
    ):
        super().__init__()
        self.group_norm = GroupNorm(channels, groups, 1e-5)
        self.attention = MultiHeadAttention(
            channels, num_heads, head_dim, dtype, attn_backend=attn_backend
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hgt, wid, c = x.shape
        h = self.attention(self.group_norm(x).reshape(b, hgt * wid, c))
        return x + h.reshape(b, hgt, wid, c)


class SpatialTransformer(nn.Module):
    """GroupNorm (eps 1e-6) → 1×1 ``proj_in`` → tokens → transformer blocks → 1×1 ``proj_out`` → + residual."""

    def __init__(
        self, channels: int, num_heads: int, head_dim: int, *, depth: int = 1,
        groups: int = 32, dtype=torch.float32, context_dim: Optional[int] = None,
        context_tokens: Optional[int] = None, attn_backend: str = "xla",
    ):
        super().__init__()
        self.norm = GroupNorm(channels, groups, 1e-6)
        self.proj_in = Conv2d(channels, channels, 1, dtype)
        self.blocks = nn.ModuleList(
            BasicTransformerBlock(
                channels, num_heads, head_dim, dtype, context_dim=context_dim,
                context_tokens=context_tokens, attn_backend=attn_backend,
            )
            for _ in range(depth)
        )
        self.proj_out = Conv2d(channels, channels, 1, dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor]) -> torch.Tensor:
        b, hgt, wid, c = x.shape
        h = self.proj_in(self.norm(x)).reshape(b, hgt * wid, c)
        for block in self.blocks:
            h = block(h, context)
        return self.proj_out(h.reshape(b, hgt, wid, c)) + x


class Downsample2D(nn.Module):
    """3×3 stride-2 conv, symmetric padding 1 (diffusers ``downsample_type='conv'``)."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 3, dtype, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """Exact nearest-neighbour 2× upsample (a broadcast), then a 3×3 conv."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 3, dtype, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
        return self.conv(x)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with flax's defaults: lecun-normal kernels and embeddings, zero biases, unit norms."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv2d)):
            m.reset_parameters(generator)
        elif isinstance(m, (GroupNorm, LayerNorm)):
            m.weight.data.fill_(1.0)
            m.bias.data.zero_()
        elif isinstance(m, nn.Embedding):
            lecun_normal_(m.weight.data, m.weight.shape[1], generator)
