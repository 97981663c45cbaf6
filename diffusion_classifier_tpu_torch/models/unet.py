"""Conditional 2D UNet denoiser over NHWC — port of ``models/unet.py``.

Same structure as the flax module, and the same submodule names, so the
flax tree converts leaf for leaf (``utils/convert.py``): ``conv_in``,
``time_embedding``, ``down_<i>_res_<j>``, ``down_<i>_attn_<j>``,
``down_<i>_downsample``, ``encoder_hid_proj``, ``mid_res_0``, ``mid_attn_0``,
``mid_res_1``, ``up_<i>_res_<j>``, ``up_<i>_attn_<j>``, ``up_<i>_upsample``,
``conv_norm_out``, ``conv_out``.

- ``attention_head_dim`` is the number of heads per level (diffusers'
  ``UNet2DConditionModel`` quirk), unless ``attention_head_dim_is_dim``.
- ``freq_shift`` is 0 here (the DiT's is 1).
- Up-path resnets take their skip separately: the concat is computed
  split-wise (``ResnetBlock2D``).
- The prefix split: the down levels before the first cross-attention level
  (with ``conv_in`` and the time embedding) do not depend on the condition.
  ``mode='encode'`` returns ``(h, skips, temb)`` after them, ``mode='tail'``
  runs the rest from that state, and ``mode='full'`` is tail ∘ encode.
- The cross-attention context has ``context_tokens`` tokens of width
  ``context_dim``: what the encoder gives. The class embedder gives one
  token of ``encoder_hid_dim`` (the default), and a one-token
  cross-attention has no ``to_q``, ``to_k`` or ``norm2`` (as the flax
  tree, which never creates them). A T5 class table gives S tokens of its
  own width D: ``encoder_hid_proj`` (``text_proj``) then maps D to
  ``cross_attention_dim``, or without it ``to_k``/``to_v`` take D, as
  flax's ``nn.Dense`` infers its input width from the context.
- ``remat``: under grad, each resnet block, spatial transformer and
  self-attention block runs through ``torch.utils.checkpoint`` (the flax
  module's ``nn.remat`` boundaries): its activations are recomputed in the
  backward instead of stored. The down/upsample convs, ``conv_in`` and
  ``conv_out`` stay outside. The recomputation repeats the same operations,
  so the loss and the gradients do not change (bit for bit on the CPU).
- ``deterministic=False`` turns the resnet blocks' dropout on (the flax
  module's flag); the engine never passes it, as the JAX engine does not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (
    AttentionBlock2D,
    Conv2d,
    Dense,
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    SpatialTransformer,
    TimestepEmbedding,
    Upsample2D,
    reset_parameters,
    sinusoidal_embedding,
)

__all__ = ["UNet2D", "UNetCondition2D", "UNetConfig"]

DOWN_BLOCK_TYPES = ("DownBlock2D", "AttnDownBlock2D", "CrossAttnDownBlock2D")
UP_BLOCK_TYPES = ("UpBlock2D", "AttnUpBlock2D", "CrossAttnUpBlock2D")


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The JAX ``UNetConfig`` knobs (diffusers ``UNet2DConditionModel``)."""

    sample_size: int = 32
    in_channels: int = 3
    out_channels: int = 3
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: Sequence[str] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    mid_block_type: Optional[str] = "UNetMidBlock2DCrossAttn"
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: Union[int, Sequence[int]] = 2
    attention_head_dim: Union[int, Sequence[int]] = 8  # heads per level, see the module docstring
    attention_head_dim_is_dim: bool = False
    cross_attention_dim: int = 1280
    transformer_layers_per_block: int = 1
    encoder_hid_dim: Optional[int] = None
    encoder_hid_dim_type: Optional[str] = None  # 'text_proj' or None
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    dropout: float = 0.0
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    attn_backend: str = "auto"
    remat: bool = False

    def __post_init__(self):
        n = len(self.block_out_channels)
        if len(self.down_block_types) != n or len(self.up_block_types) != n:
            raise ValueError("one down and one up block type per level")
        for t in self.down_block_types:
            if t not in DOWN_BLOCK_TYPES:
                raise ValueError(f"unknown down block {t}")
        for t in self.up_block_types:
            if t not in UP_BLOCK_TYPES:
                raise ValueError(f"unknown up block {t}")
        if self.mid_block_type not in ("UNetMidBlock2DCrossAttn", "UNetMidBlock2D", None):
            raise ValueError(f"unknown mid block {self.mid_block_type}")

    def layers_for(self, i: int) -> int:
        lpb = self.layers_per_block
        return lpb if isinstance(lpb, int) else lpb[i]

    def heads_for(self, i: int) -> int:
        v = self.attention_head_dim
        v = v if isinstance(v, int) else v[i]
        if self.attention_head_dim_is_dim:
            ch = self.block_out_channels[i]
            if ch % v:
                raise ValueError(f"attention_head_dim {v} must divide level channels {ch}")
            return ch // v
        return v


class UNetCondition2D(nn.Module):
    """Class/text-conditional UNet denoiser: ``pred = net(z_t, logSNR_t, context)``, NHWC.

    ``context_tokens`` and ``context_dim`` are the length and width of the
    cross-attention context (1 and ``encoder_hid_dim`` for the class
    embedder; S and D for a ``[C+1, S, D]`` T5 table).
    ``forward(x, noise_labels, encoder_hidden_states, deterministic=,
    mode=, prefix_state=)``: see the module docstring for the modes, remat
    and dropout.
    """

    def __init__(
        self, config: UNetConfig, dtype=torch.float32, *, context_tokens: int = 1,
        context_dim: Optional[int] = None,
    ):
        super().__init__()
        self.config, self.dtype = config, dtype
        cfg = config
        chans = tuple(cfg.block_out_channels)
        temb_dim = 4 * chans[0]
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim, dtype)
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, dtype, padding=1)
        if context_dim is None:
            context_dim = cfg.encoder_hid_dim or cfg.cross_attention_dim
        self.context_tokens, self.context_dim = context_tokens, context_dim
        if cfg.encoder_hid_dim_type == "text_proj":
            self.encoder_hid_proj = Dense(context_dim, cfg.cross_attention_dim, dtype)
            context_dim = cfg.cross_attention_dim

        def resnet(name, in_ch, out_ch):
            self.add_module(name, ResnetBlock2D(
                in_ch, out_ch, temb_dim, dropout=cfg.dropout, groups=cfg.norm_num_groups,
                eps=cfg.norm_eps, dtype=dtype,
            ))

        def attn(name, block_type, level):
            ch, heads = chans[level], cfg.heads_for(level)
            kw = dict(groups=cfg.norm_num_groups, dtype=dtype, attn_backend=cfg.attn_backend)
            if block_type.startswith("CrossAttn"):
                self.add_module(name, SpatialTransformer(
                    ch, heads, ch // heads, depth=cfg.transformer_layers_per_block,
                    context_dim=context_dim, context_tokens=context_tokens, **kw,
                ))
            elif block_type.startswith("Attn"):
                self.add_module(name, AttentionBlock2D(ch, heads, ch // heads, **kw))

        # the down path, recording each skip's channels for the up path
        skip_ch = [chans[0]]
        ch = chans[0]
        for i, block_type in enumerate(cfg.down_block_types):
            for j in range(cfg.layers_for(i)):
                resnet(f"down_{i}_res_{j}", ch, chans[i])
                ch = chans[i]
                attn(f"down_{i}_attn_{j}", block_type, i)
                skip_ch.append(ch)
            if i < len(chans) - 1:
                self.add_module(f"down_{i}_downsample", Downsample2D(ch, ch, dtype))
                skip_ch.append(ch)

        if cfg.mid_block_type is not None:
            resnet("mid_res_0", ch, ch)
            attn("mid_attn_0", "CrossAttn" if cfg.mid_block_type.endswith("CrossAttn") else "Attn",
                 len(chans) - 1)
            resnet("mid_res_1", ch, ch)

        for i, block_type in enumerate(cfg.up_block_types):
            level = len(chans) - 1 - i
            for j in range(cfg.layers_for(level) + 1):
                resnet(f"up_{i}_res_{j}", ch + skip_ch.pop(), chans[level])
                ch = chans[level]
                attn(f"up_{i}_attn_{j}", block_type, level)
            if i < len(chans) - 1:
                self.add_module(f"up_{i}_upsample", Upsample2D(ch, ch, dtype))

        self.conv_norm_out = GroupNorm(ch, cfg.norm_num_groups, cfg.norm_eps)
        self.conv_out = Conv2d(ch, cfg.out_channels, 3, dtype, padding=1)

    @property
    def prefix_split(self) -> int:
        """Down levels before the first cross-attention level: the condition-free prefix."""
        types = tuple(self.config.down_block_types)
        return types.index("CrossAttnDownBlock2D") if "CrossAttnDownBlock2D" in types else len(types)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with flax's defaults (lecun-normal kernels, zero biases, unit norms)."""
        reset_parameters(self, generator)

    def forward(
        self,
        x: Optional[torch.Tensor],
        noise_labels: Optional[torch.Tensor],
        encoder_hidden_states: Optional[torch.Tensor] = None,
        *,
        deterministic: bool = True,
        mode: str = "full",
        prefix_state=None,
    ):
        if mode not in ("full", "encode", "tail"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg = self.config
        chans = tuple(cfg.block_out_channels)
        split = self.prefix_split
        remat = cfg.remat and torch.is_grad_enabled()

        # one block call: the remat boundary, with the static flags closed over
        def run(block, *args, **kwargs):
            if remat:
                return checkpoint(block, *args, use_reentrant=False, **kwargs)
            return block(*args, **kwargs)

        def res(name, h, skip=None):
            return run(getattr(self, name), h, temb, skip, deterministic=deterministic)

        def attn(name, h, context):
            block = getattr(self, name, None)
            if isinstance(block, SpatialTransformer):
                return run(block, h, context)
            if isinstance(block, AttentionBlock2D):
                return run(block, h)
            return h

        def down_level(i, h, context):
            for j in range(cfg.layers_for(i)):
                h = attn(f"down_{i}_attn_{j}", res(f"down_{i}_res_{j}", h), context)
                skips.append(h)
            if i < len(chans) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)
            return h

        # --- prefix: time embedding, conv_in, the condition-free down levels ---
        if mode in ("full", "encode"):
            noise_labels = torch.as_tensor(noise_labels, device=x.device).reshape(-1)
            noise_labels = noise_labels.expand(x.shape[0])
            t_emb = sinusoidal_embedding(
                noise_labels, chans[0], flip_sin_to_cos=cfg.flip_sin_to_cos,
                freq_shift=cfg.freq_shift,
            ).to(self.dtype)
            temb = self.time_embedding(t_emb)
            h = self.conv_in(x)
            skips = [h]
            for i in range(split):
                h = down_level(i, h, None)
            if mode == "encode":
                return h, tuple(skips), temb
        else:
            if prefix_state is None:
                raise ValueError("mode='tail' needs prefix_state")
            h, skips, temb = prefix_state
            skips = list(skips)

        context = encoder_hidden_states
        if context is not None:
            context = context.to(self.dtype)
            if cfg.encoder_hid_dim_type == "text_proj":
                context = self.encoder_hid_proj(context)

        for i in range(split, len(chans)):
            h = down_level(i, h, context)

        if cfg.mid_block_type is not None:
            h = res("mid_res_1", attn("mid_attn_0", res("mid_res_0", h), context))

        for i in range(len(chans)):
            level = len(chans) - 1 - i
            for j in range(cfg.layers_for(level) + 1):
                h = attn(f"up_{i}_attn_{j}", res(f"up_{i}_res_{j}", h, skips.pop()), context)
            if i < len(chans) - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        if skips:
            raise RuntimeError("skip-connection bookkeeping mismatch")

        h = F.silu(self.conv_norm_out(h))
        return self.conv_out(h).to(torch.float32)


def UNet2D(
    sample_size: int = 32,
    in_channels: int = 3,
    out_channels: int = 3,
    block_out_channels: Sequence[int] = (224, 448, 672, 896),
    down_block_types: Sequence[str] = (
        "DownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D", "AttnDownBlock2D",
    ),
    up_block_types: Sequence[str] = (
        "AttnUpBlock2D", "AttnUpBlock2D", "AttnUpBlock2D", "UpBlock2D",
    ),
    layers_per_block: int = 2,
    attention_head_dim: int = 8,
    norm_num_groups: int = 32,
    dtype=torch.float32,
    **extra,
) -> UNetCondition2D:
    """Unconditional UNet (diffusers ``UNet2DModel`` defaults): self-attention blocks, no context.

    ``attention_head_dim`` is here the per-head dimension (heads =
    channels // attention_head_dim). Call it with ``encoder_hidden_states=None``.
    """
    return UNetCondition2D(
        UNetConfig(
            sample_size=sample_size,
            in_channels=in_channels,
            out_channels=out_channels,
            block_out_channels=tuple(block_out_channels),
            down_block_types=tuple(down_block_types),
            up_block_types=tuple(up_block_types),
            mid_block_type="UNetMidBlock2D",
            layers_per_block=layers_per_block,
            attention_head_dim=attention_head_dim,
            attention_head_dim_is_dim=True,
            norm_num_groups=norm_num_groups,
            **extra,
        ),
        dtype=dtype,
    )
