"""Class-conditional DiT (Peebles and Xie, arXiv 2212.09748), plain PyTorch, functional.

As the upstream experiment builds it (diffusers ``DiTTransformer2DModel``
with AdaLN conditioning): patches of ``p × p`` pixels (flattened in
``(py, px, c)`` order) embedded by one linear layer, plus the fixed 2-D
sin-cos position table; the condition is an MLP (SiLU) of the sinusoidal
embedding of λ (256 wide, cos half first, frequency shift 1) plus the class
table's row (the null class is the last row); each block computes its six
modulations from ``silu(cond)`` (shift, scale, gate of attention, then of
the MLP), LayerNorm without affine (eps 1e-5), multi-head self-attention
from one fused qkv projection, a tanh-GELU MLP of 4× width, gated residuals;
the final layer modulates (shift, scale) a LayerNorm and projects back to
patches. The parameters are a dict named as the port's state dict
(``backbone.…``); the model's sizes come from the configuration file's
``model`` block.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import Precision

__all__ = ["forward", "param_shapes", "sincos_table", "timestep_embedding"]


def timestep_embedding(lam: torch.Tensor, dim: int, freq_shift: float) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=lam.device) / (half - freq_shift))
    arg = lam.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def sincos_table(dim: int, gh: int, gw: int) -> np.ndarray:
    """``[gh·gw, dim]``: the first half encodes the row, the second the column (sin then cos each)."""
    quarter = dim // 4
    omega = 1.0 / 10000 ** (np.arange(quarter, dtype=np.float64) / quarter)

    def one(n):
        arg = np.outer(np.arange(n, dtype=np.float64), omega)
        return np.concatenate([np.sin(arg), np.cos(arg)], axis=1)

    rows = np.repeat(one(gh)[:, None], gw, axis=1)
    cols = np.repeat(one(gw)[None], gh, axis=0)
    return np.concatenate([rows, cols], axis=-1).reshape(gh * gw, dim)


def param_shapes(model: dict, classes: int) -> dict:
    """``{name: shape}`` of every parameter, named as the port's state dict."""
    d = model["num_attention_heads"] * model["attention_head_dim"]
    p, c = model["patch_size"], model["in_channels"]
    oc, hidden = model.get("out_channels", c), model.get("mlp_ratio", 4) * d
    shapes = {"backbone.class_embedding.weight": (classes + 1, d)}

    def lin(name, n_in, n_out):
        shapes[f"backbone.{name}.weight"] = (n_out, n_in)
        shapes[f"backbone.{name}.bias"] = (n_out,)

    lin("patch_embed", p * p * c, d)
    lin("time_embedding.linear_1", 256, d)
    lin("time_embedding.linear_2", d, d)
    for i in range(model["num_layers"]):
        lin(f"blocks.{i}.adaLN_modulation", d, 6 * d)
        lin(f"blocks.{i}.qkv", d, 3 * d)
        lin(f"blocks.{i}.proj", d, d)
        lin(f"blocks.{i}.mlp_fc1", d, hidden)
        lin(f"blocks.{i}.mlp_fc2", hidden, d)
    lin("final_modulation", d, 2 * d)
    lin("final_proj", d, p * p * oc)
    return shapes


def _layer_norm(x, eps):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def forward(P: dict, model: dict, z: torch.Tensor, lam: torch.Tensor, labels: torch.Tensor,
            prec: Precision = Precision()) -> torch.Tensor:
    """The prediction ``[N, H, W, C]`` for noised inputs ``z`` at logSNR ``lam`` under class ``labels``."""
    heads, hd, p = model["num_attention_heads"], model["attention_head_dim"], model["patch_size"]
    dim, eps = heads * hd, model.get("norm_eps", 1e-5)
    n, h, w, c = z.shape
    gh, gw = h // p, w // p
    s = gh * gw

    def lin(x, name):
        return prec.linear(x, P[f"backbone.{name}.weight"], P[f"backbone.{name}.bias"])

    patches = z.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(n, s, p * p * c)
    pos = torch.from_numpy(sincos_table(dim, gh, gw)).to(z.device, torch.float32)
    x = lin(patches, "patch_embed") + pos[None]
    temb = timestep_embedding(lam, 256, freq_shift=1.0)
    cond = lin(F.silu(lin(temb, "time_embedding.linear_1")), "time_embedding.linear_2")
    cond = cond + P["backbone.class_embedding.weight"][labels.long()]
    act = F.silu(cond)
    for i in range(model["num_layers"]):
        pre = f"blocks.{i}"
        mods = lin(act, f"{pre}.adaLN_modulation").chunk(6, dim=-1)
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = (m[:, None] for m in mods)
        y = _layer_norm(x, eps) * (1 + scale_a) + shift_a
        q, k, v = lin(y, f"{pre}.qkv").split(dim, dim=-1)
        q, k, v = (t.reshape(n, s, heads, hd).transpose(1, 2) for t in (q, k, v))
        att = torch.softmax(prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        o = prec.matmul(att, v).transpose(1, 2).reshape(n, s, dim)
        x = x + gate_a * lin(o, f"{pre}.proj")
        y = _layer_norm(x, eps) * (1 + scale_m) + shift_m
        y = lin(F.gelu(lin(y, f"{pre}.mlp_fc1"), approximate="tanh"), f"{pre}.mlp_fc2")
        x = x + gate_m * y
    shift, scale = lin(act, "final_modulation").chunk(2, dim=-1)
    x = _layer_norm(x, eps) * (1 + scale[:, None]) + shift[:, None]
    out_c = model.get("out_channels", c)
    x = lin(x, "final_proj").reshape(n, gh, gw, p, p, out_c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, out_c)
