"""Conditional 2-D UNet (diffusers ``UNet2DConditionModel``, as the upstream CIFAR-10 experiment builds it).

Plain PyTorch, functional, NHWC. The time embedding is an MLP (SiLU) of
the sinusoidal embedding of λ (``block_out_channels[0]`` wide, cos half
first, no frequency shift) to 4× that width. Each level has
``layers_per_block`` resnet blocks (GroupNorm, SiLU, 3×3 conv, plus the
projected time embedding, GroupNorm, SiLU, 3×3 conv; a linear shortcut on a
change of channels), each followed on a cross-attention level by a spatial
transformer (GroupNorm eps 1e-6, 1×1 conv in, one block of LayerNorm +
self-attention, cross-attention over the context, LayerNorm + GEGLU of 4×
width, 1×1 conv out, residual); a 3×3 stride-2 conv between levels. The mid
block is resnet, transformer, resnet. The up path takes one more block a
level, each on the concatenation with the matching skip, and a nearest 2×
upsample and 3×3 conv between levels; GroupNorm, SiLU and a 3×3 conv give
the output. A context of one token needs no query or key: softmax over one
key is 1, so the cross-attention is ``to_out(to_v(context))`` at every
position. The class context is the ``'nn'`` encoder's table row (null class
last), projected by ``encoder_hid_proj`` under ``text_proj``.

:func:`prefix` runs the layers before the first cross-attention level,
which do not see the class; :func:`tail` the rest. The parameters are a
dict named as the port's state dict (``backbone.…``, ``encoder.…``); the
sizes come from the configuration file's ``model`` block.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import Precision

__all__ = ["context", "forward", "param_shapes", "prefix", "prefix_levels", "tail"]


def _timestep_embedding(lam, dim):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=lam.device) / half)
    arg = lam.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def _group_norm(x, w, b, groups, eps):
    n, h, wd, c = x.shape
    g = x.reshape(n, h * wd, groups, c // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), unbiased=False, keepdim=True)
    return ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape) * w + b


def _layer_norm(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


class _Net:
    def __init__(self, P, model, prec):
        self.P, self.m, self.prec = P, model, prec
        self.groups = model.get("norm_num_groups", 32)
        self.eps = model.get("norm_eps", 1e-5)

    def w(self, name):
        return self.P[f"backbone.{name}"]

    def lin(self, x, name, bias=True):
        return self.prec.linear(x, self.w(f"{name}.weight"), self.w(f"{name}.bias") if bias else None)

    def conv(self, x, name, *, stride=1, padding=1):
        return self.prec.conv(x, self.w(f"{name}.weight"), self.w(f"{name}.bias"), stride=stride, padding=padding)

    def gn(self, x, name, eps=None):
        return _group_norm(x, self.w(f"{name}.weight"), self.w(f"{name}.bias"), self.groups, eps or self.eps)

    def resnet(self, name, x, temb, skip=None):
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        h = self.conv(F.silu(self.gn(x, f"{name}.norm1")), f"{name}.conv1")
        h = h + self.lin(F.silu(temb), f"{name}.time_emb")[:, None, None, :]
        h = self.conv(F.silu(self.gn(h, f"{name}.norm2")), f"{name}.conv2")
        if f"backbone.{name}.shortcut.weight" in self.P:
            x = self.lin(x, f"{name}.shortcut")
        return x + h

    def attention(self, name, x, ctx, heads):
        n, sq, _ = x.shape
        v = self.lin(ctx, f"{name}.to_v", bias=False)
        if f"backbone.{name}.to_q.weight" not in self.P:  # one key: the weights are all 1
            if ctx.shape[1] != 1:
                raise ValueError("a cross-attention without query and key takes a one-token context")
            return self.lin(v, f"{name}.to_out").expand(n, sq, -1)
        q = self.lin(x, f"{name}.to_q", bias=False)
        k = self.lin(ctx, f"{name}.to_k", bias=False)
        d = q.shape[-1] // heads
        q, k, v = (t.reshape(n, t.shape[1], heads, d).transpose(1, 2) for t in (q, k, v))
        p = torch.softmax(self.prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
        o = self.prec.matmul(p, v).transpose(1, 2).reshape(n, sq, heads * d)
        return self.lin(o, f"{name}.to_out")

    def transformer(self, name, x, ctx, heads):
        n, h, wd, c = x.shape
        t = self.conv(self.gn(x, f"{name}.norm", eps=1e-6), f"{name}.proj_in", padding=0)
        t = t.reshape(n, h * wd, c)
        b = f"{name}.blocks.0"
        y = _layer_norm(t, self.w(f"{b}.norm1.weight"), self.w(f"{b}.norm1.bias"))
        t = t + self.attention(f"{b}.attn1", y, y, heads)
        if f"backbone.{b}.norm2.weight" in self.P:
            y = _layer_norm(t, self.w(f"{b}.norm2.weight"), self.w(f"{b}.norm2.bias"))
        else:
            y = t
        t = t + self.attention(f"{b}.attn2", y, ctx, heads)
        y = _layer_norm(t, self.w(f"{b}.norm3.weight"), self.w(f"{b}.norm3.bias"))
        val, gate = self.lin(y, f"{b}.ff.proj_in").chunk(2, dim=-1)
        t = t + self.lin(val * F.gelu(gate, approximate="tanh"), f"{b}.ff.proj_out")
        return self.conv(t.reshape(n, h, wd, c), f"{name}.proj_out", padding=0) + x

    def down_level(self, i, h, temb, ctx, skips):
        m = self.m
        cross = m["down_block_types"][i].startswith("CrossAttn")
        for j in range(m["layers_per_block"]):
            h = self.resnet(f"down_{i}_res_{j}", h, temb)
            if cross:
                h = self.transformer(f"down_{i}_attn_{j}", h, ctx, m["attention_head_dim"])
            skips.append(h)
        if i < len(m["block_out_channels"]) - 1:
            h = self.conv(h, f"down_{i}_downsample.conv", stride=2)
            skips.append(h)
        return h


def param_shapes(model: dict, classes: int) -> dict:
    """``{name: shape}`` of every parameter, named as the port's state dict (a one-token class context)."""
    chans = list(model["block_out_channels"])
    c0, temb = chans[0], 4 * chans[0]
    hid, cross = model["encoder_hid_dim"], model["cross_attention_dim"]
    shapes = {"encoder.embedding.weight": (classes + 1, hid)}

    def put(name, shape, bias=True):
        shapes[f"backbone.{name}.weight"] = tuple(shape)
        if bias:
            shapes[f"backbone.{name}.bias"] = (shape[0],)

    def resnet(name, n_in, n_out):
        put(f"{name}.norm1", (n_in,))
        put(f"{name}.conv1", (n_out, n_in, 3, 3))
        put(f"{name}.time_emb", (n_out, temb))
        put(f"{name}.norm2", (n_out,))
        put(f"{name}.conv2", (n_out, n_out, 3, 3))
        if n_in != n_out:
            put(f"{name}.shortcut", (n_out, n_in))

    def transformer(name, ch):
        put(f"{name}.norm", (ch,))
        put(f"{name}.proj_in", (ch, ch, 1, 1))
        b = f"{name}.blocks.0"
        put(f"{b}.norm1", (ch,))
        for proj in ("to_q", "to_k", "to_v"):
            put(f"{b}.attn1.{proj}", (ch, ch), bias=False)
        put(f"{b}.attn1.to_out", (ch, ch))
        put(f"{b}.attn2.to_v", (ch, cross), bias=False)
        put(f"{b}.attn2.to_out", (ch, ch))
        put(f"{b}.norm3", (ch,))
        put(f"{b}.ff.proj_in", (8 * ch, ch))
        put(f"{b}.ff.proj_out", (ch, 4 * ch))
        put(f"{name}.proj_out", (ch, ch, 1, 1))

    put("time_embedding.linear_1", (temb, c0))
    put("time_embedding.linear_2", (temb, temb))
    put("conv_in", (c0, model["in_channels"], 3, 3))
    if model.get("encoder_hid_dim_type") == "text_proj":
        put("encoder_hid_proj", (cross, hid))
    skip, ch = [c0], c0
    for i, kind in enumerate(model["down_block_types"]):
        for j in range(model["layers_per_block"]):
            resnet(f"down_{i}_res_{j}", ch, chans[i])
            ch = chans[i]
            if kind.startswith("CrossAttn"):
                transformer(f"down_{i}_attn_{j}", ch)
            skip.append(ch)
        if i < len(chans) - 1:
            put(f"down_{i}_downsample.conv", (ch, ch, 3, 3))
            skip.append(ch)
    resnet("mid_res_0", ch, ch)
    transformer("mid_attn_0", ch)
    resnet("mid_res_1", ch, ch)
    for i, kind in enumerate(model["up_block_types"]):
        level = len(chans) - 1 - i
        for j in range(model["layers_per_block"] + 1):
            resnet(f"up_{i}_res_{j}", ch + skip.pop(), chans[level])
            ch = chans[level]
            if kind.startswith("CrossAttn"):
                transformer(f"up_{i}_attn_{j}", ch)
        if i < len(chans) - 1:
            put(f"up_{i}_upsample.conv", (ch, ch, 3, 3))
    put("conv_norm_out", (ch,))
    put("conv_out", (model["out_channels"], ch, 3, 3))
    return shapes


def prefix_levels(model: dict) -> int:
    """The levels before the first cross-attention level: they never see the class."""
    types = list(model["down_block_types"])
    return types.index("CrossAttnDownBlock2D") if "CrossAttnDownBlock2D" in types else len(types)


def context(P: dict, model: dict, labels: torch.Tensor, prec: Precision = Precision()) -> torch.Tensor:
    """The ``'nn'`` class context ``[N, 1, D]``, through ``encoder_hid_proj`` under ``text_proj``."""
    ctx = P["encoder.embedding.weight"][labels.long()][:, None, :]
    if model.get("encoder_hid_dim_type") == "text_proj":
        ctx = prec.linear(ctx, P["backbone.encoder_hid_proj.weight"], P["backbone.encoder_hid_proj.bias"])
    return ctx


def prefix(P: dict, model: dict, z: torch.Tensor, lam: torch.Tensor, prec: Precision = Precision()):
    """``(h, skips, temb)`` after the condition-free levels."""
    net = _Net(P, model, prec)
    temb = _timestep_embedding(lam, model["block_out_channels"][0])
    temb = net.lin(F.silu(net.lin(temb, "time_embedding.linear_1")), "time_embedding.linear_2")
    h = net.conv(z, "conv_in")
    skips = [h]
    for i in range(prefix_levels(model)):
        h = net.down_level(i, h, temb, None, skips)
    return h, skips, temb


def tail(P: dict, model: dict, state, ctx: torch.Tensor, prec: Precision = Precision()) -> torch.Tensor:
    """The prediction from a prefix state and the class context (rows aligned)."""
    net = _Net(P, model, prec)
    h, skips, temb = state
    skips = list(skips)
    m = model
    levels = len(m["block_out_channels"])
    heads = m["attention_head_dim"]
    for i in range(prefix_levels(m), levels):
        h = net.down_level(i, h, temb, ctx, skips)
    h = net.resnet("mid_res_0", h, temb)
    h = net.transformer("mid_attn_0", h, ctx, heads)
    h = net.resnet("mid_res_1", h, temb)
    for i in range(levels):
        cross = m["up_block_types"][i].startswith("CrossAttn")
        for j in range(m["layers_per_block"] + 1):
            h = net.resnet(f"up_{i}_res_{j}", h, temb, skips.pop())
            if cross:
                h = net.transformer(f"up_{i}_attn_{j}", h, ctx, heads)
        if i < levels - 1:
            n, hh, ww, c = h.shape
            h = h[:, :, None, :, None, :].expand(n, hh, 2, ww, 2, c).reshape(n, 2 * hh, 2 * ww, c)
            h = net.conv(h, f"up_{i}_upsample.conv")
    return net.conv(F.silu(net.gn(h, "conv_norm_out")), "conv_out")


def forward(P: dict, model: dict, z, lam, labels, prec: Precision = Precision()) -> torch.Tensor:
    return tail(P, model, prefix(P, model, z, lam, prec), context(P, model, labels, prec), prec)
