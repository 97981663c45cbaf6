"""DiT denoiser (patchify → AdaLN transformer blocks → unpatchify) — port of ``models/dit.py``.

Same structure and the same numerics conventions as the flax module:

- The conditioning vector (timestep MLP + label table, null label =
  ``num_classes``) is computed once; each block owns its six-way
  ``adaLN_modulation`` projection, split in the order shift/scale/gate for
  attention, then for the MLP.
- LayerNorm has no affine, eps 1e-5, and computes in float32 with flax's
  variance ``E[x²] − E[x]²`` (clipped at 0), then casts to the compute dtype;
  the AdaLN modulation ``h·(1 + scale) + shift`` follows in that dtype, in
  the same call (``ops/layer_norm.py::layer_norm``).
- In bf16 the residual stream and the position table stay bf16; the output
  is cast to float32.
- ``qkv`` is split into three contiguous thirds, each viewed as
  ``[B, S, H, D]`` without a copy — the flash kernel reads the strided views.
- Patchify is a reshape plus one ``Dense`` over ``(py, px, c)`` patches,
  which is the flax ``Conv(kernel=p, stride=p)`` with its HWIO kernel
  flattened; unpatchify runs in ``(b, gh, py, gw, px, c)`` order.
- The forward is differentiable end to end, the per-forward fp32 → bf16
  weight casts included (their gradients land on the fp32 parameters), and
  the attention's backward is the flash kernel's. ``remat`` recomputes each
  block in the backward (``torch.utils.checkpoint``, as ``nn.remat`` does
  per block in flax), so the forward kernel runs twice per block there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.layer_norm import layer_norm
from .layers import Dense, TimestepEmbedding, lecun_normal_, sinusoidal_embedding

__all__ = ["DiT", "DiTBlock", "DiTConfig", "get_2d_sincos_pos_embed"]


def get_2d_sincos_pos_embed(
    dim: int, grid_h: int, grid_w: Optional[int] = None
) -> np.ndarray:
    """Fixed 2D sin-cos positional embedding ``[grid_h*grid_w, dim]`` (DiT/MAE style), float64."""
    if dim % 4:
        raise ValueError(f"dim {dim} must be divisible by 4")
    grid_w = grid_h if grid_w is None else grid_w
    quarter = dim // 4
    omega = 1.0 / (10000 ** (np.arange(quarter, dtype=np.float64) / quarter))

    def emb_1d(grid):
        out = np.outer(np.arange(grid, dtype=np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)  # [g, dim/2]

    emb_h = np.repeat(emb_1d(grid_h)[:, None, :], grid_w, axis=1)
    emb_w = np.repeat(emb_1d(grid_w)[None, :, :], grid_h, axis=0)
    return np.concatenate([emb_h, emb_w], axis=-1).reshape(grid_h * grid_w, dim)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """The JAX ``DiTConfig`` knobs (diffusers ``DiTTransformer2DModel``)."""

    num_attention_heads: int = 16
    attention_head_dim: int = 72
    in_channels: int = 4
    out_channels: Optional[int] = None
    num_layers: int = 28
    sample_size: int = 32
    patch_size: int = 2
    num_classes: int = 1000  # label table has num_classes + 1 rows (null token)
    norm_eps: float = 1e-5
    mlp_ratio: int = 4
    attn_backend: str = "auto"
    remat: bool = False

    @property
    def hidden_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def out_ch(self) -> int:
        return self.out_channels if self.out_channels is not None else self.in_channels


class DiTBlock(nn.Module):
    """AdaLN transformer block: gated self-attention + gated tanh-GELU MLP."""

    def __init__(
        self,
        num_heads: int,
        head_dim: int,
        mlp_ratio: int = 4,
        dtype=torch.float32,
        attn_backend: str = "auto",
        norm_eps: float = 1e-5,
    ):
        super().__init__()
        dim = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.dtype, self.attn_backend, self.norm_eps = dtype, attn_backend, norm_eps
        self.adaLN_modulation = Dense(dim, 6 * dim, dtype)
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.mlp_fc1 = Dense(dim, mlp_ratio * dim, dtype)
        self.mlp_fc2 = Dense(mlp_ratio * dim, dim, dtype)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        b, s, dim = x.shape
        mods = self.adaLN_modulation(F.silu(cond))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods.chunk(
            6, dim=-1
        )

        h = layer_norm(x, self.norm_eps, shift=shift_msa, scale=scale_msa, dtype=self.dtype)
        q, k, v = (
            t.view(b, s, self.num_heads, self.head_dim)
            for t in self.qkv(h).split(dim, dim=-1)
        )
        o = attention(q, k, v, backend=self.attn_backend).reshape(b, s, dim)
        x = x + gate_msa[:, None, :] * self.proj(o)

        h = layer_norm(x, self.norm_eps, shift=shift_mlp, scale=scale_mlp, dtype=self.dtype)
        h = F.gelu(self.mlp_fc1(h), approximate="tanh")
        return x + gate_mlp[:, None, :] * self.mlp_fc2(h)


class DiT(nn.Module):
    """Class-conditional DiT; ``pred = net(z_t, logSNR_t, class_labels)`` over NHWC."""

    def __init__(self, config: DiTConfig, dtype=torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        d, p = config.hidden_dim, config.patch_size
        self.patch_embed = Dense(p * p * config.in_channels, d, dtype)
        self.time_embedding = TimestepEmbedding(256, d, dtype)
        self.class_embedding = nn.Embedding(config.num_classes + 1, d)
        self.blocks = nn.ModuleList(
            DiTBlock(
                config.num_attention_heads,
                config.attention_head_dim,
                config.mlp_ratio,
                dtype,
                config.attn_backend,
                config.norm_eps,
            )
            for _ in range(config.num_layers)
        )
        self.final_modulation = Dense(d, 2 * d, dtype)
        self.final_proj = Dense(d, p * p * config.out_ch, dtype)
        self._pos_cache: dict = {}

    def classify_row_bytes(self, image_shape: tuple) -> int:
        """Card bytes of one classify row at a block's peak, for an ``(h, w, c)`` image.

        With no graph a block holds, a token at its MLP: the residual stream,
        the normed input, the first MLP product and its GELU (``mlp_ratio``
        times the width each), in the compute dtype.
        """
        cfg = self.config
        tokens = (image_shape[0] // cfg.patch_size) * (image_shape[1] // cfg.patch_size)
        return (2 + 2 * cfg.mlp_ratio) * tokens * cfg.hidden_dim * self.dtype.itemsize

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with flax's defaults (lecun-normal kernels, zero biases)."""
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)
        emb = self.class_embedding.weight
        lecun_normal_(emb.data, emb.shape[1], generator)

    def _pos_embed(self, gh: int, gw: int, device) -> torch.Tensor:
        key = (gh, gw, str(device))
        if key not in self._pos_cache:
            table = get_2d_sincos_pos_embed(self.config.hidden_dim, gh, gw)
            self._pos_cache[key] = torch.from_numpy(table).to(device, self.dtype)
        return self._pos_cache[key]

    def forward(
        self,
        x: torch.Tensor,
        noise_labels: torch.Tensor,
        class_labels: Optional[torch.Tensor] = None,
        *,
        deterministic: bool = True,  # the flax module's flag; the DiT has no dropout
    ) -> torch.Tensor:
        cfg = self.config
        b, h, w, c = x.shape
        p = cfg.patch_size
        if h % p or w % p:
            raise ValueError(f"image size ({h}x{w}) must be divisible by patch size {p}")
        gh, gw = h // p, w // p

        # --- patchify + fixed pos embed (kept in the compute dtype) ---
        patches = (
            x.to(self.dtype)
            .reshape(b, gh, p, gw, p, c)
            .permute(0, 1, 3, 2, 4, 5)
            .reshape(b, gh * gw, p * p * c)
        )
        tokens = self.patch_embed(patches) + self._pos_embed(gh, gw, x.device)[None]

        # --- combined timestep + label conditioning (computed once) ---
        noise_labels = torch.as_tensor(noise_labels, device=x.device).reshape(-1)
        noise_labels = noise_labels.expand(b) if noise_labels.numel() == 1 else noise_labels
        # freq_shift=1: diffusers CombinedTimestepLabelEmbeddings' Timesteps
        t_emb = sinusoidal_embedding(noise_labels, 256, freq_shift=1.0).to(self.dtype)
        cond = self.time_embedding(t_emb)
        if class_labels is None:
            class_labels = torch.full((b,), cfg.num_classes, device=x.device)
        table = self.class_embedding.weight.to(self.dtype)
        cond = cond + F.embedding(class_labels.to(torch.long), table)

        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                tokens = checkpoint(block, tokens, cond, use_reentrant=False)
            else:
                tokens = block(tokens, cond)

        # --- AdaLN final layer + unpatchify ---
        shift, scale = self.final_modulation(F.silu(cond)).chunk(2, dim=-1)
        tokens = self.final_proj(layer_norm(tokens, cfg.norm_eps, shift=shift, scale=scale, dtype=self.dtype))
        out = tokens.reshape(b, gh, gw, p, p, cfg.out_ch)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, cfg.out_ch)
        return out.to(torch.float32)
