"""ResNet feature backbone for the discriminative baseline — port of ``models/resnet.py``.

NHWC, as the flax module: resnet18/34 (basic blocks) and resnet50
(bottlenecks), the first conv taking any number of input channels, no final
FC: ``[B, H, W, C] → [B, output_dim]`` features in fp32 (512 for 18/34, 2048
for 50). Stem: conv 7×7/2 pad 3, BatchNorm, ReLU, max-pool 3/2 pad 1 (the
padding is −inf); the stages; the global mean. Module names are the flax
tree's (``conv1``, ``bn1``, ``layer<s>_<i>`` with ``conv1..3``, ``bn1..3``,
``downsample``, ``bn_down``), so the weight bridge maps it leaf for leaf.

:class:`BatchNorm` is flax's ``nn.BatchNorm``, not ``torch.nn.BatchNorm2d``
with its defaults: the statistics are computed in fp32 (at least) over N, H
and W as ``E[x²] − E[x]²`` clipped at 0 (the biased variance), the batch
normalises with them, and the running averages (buffers ``running_mean``,
``running_var``) move as ``r ← 0.99·r + 0.01·stat``, the biased variance
included; ε is 1e-5. ``train=False`` normalises with the running averages.
The mode is the ``train`` argument of ``forward``, as in flax, not
``nn.Module.training``. Over several data ranks (``process_group``, set by
``parallel.sharding.shard_params``) the statistics are the global batch's,
as in the JAX package's jitted step over a sharded batch: the sums, the
sums of squares and the counts are all-reduced (differentiably) before
the division, so every rank normalises alike and keeps the same running
averages.

:func:`load_pretrained_resnet` reads a local ``.npz`` of a torchvision
``state_dict`` (the JAX module's format) into the port's names.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum
from .layers import Conv2d, reset_parameters

__all__ = ["BatchNorm", "RESNET_BLOCKS", "RESNET_VARIANTS", "ResNet2D", "load_pretrained_resnet"]

RESNET_VARIANTS = {
    # variant: (block type, stage sizes, output_dim)
    "resnet18": ("basic", (2, 2, 2, 2), 512),
    "resnet34": ("basic", (3, 4, 6, 3), 512),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 2048),
}


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-5, dtype=float32)`` over the last (channel) axis."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.process_group = None  # the data group: statistics over the global batch

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            axes = tuple(range(x.ndim - 1))
            if self.process_group is None:
                mean = xf.mean(dim=axes)
                sq_mean = torch.square(xf).mean(dim=axes)
            else:
                count = torch.full_like(xf[..., :1].sum(dim=axes), xf[..., 0].numel())
                sums = all_reduce_sum(torch.cat(
                    [xf.sum(dim=axes), torch.square(xf).sum(dim=axes), count]
                ), self.process_group)
                c = x.shape[-1]
                mean, sq_mean = sums[:c] / sums[2 * c], sums[c : 2 * c] / sums[2 * c]
            var = torch.clamp_min(sq_mean - torch.square(mean), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean) * mul + self.bias


class _BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, channels: int, stride: int, dtype):
        super().__init__()
        self.conv1 = Conv2d(in_ch, channels, 3, dtype, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(channels)
        self.conv2 = Conv2d(channels, channels, 3, dtype, padding=1, bias=False)
        self.bn2 = BatchNorm(channels)
        self.downsample = self.bn_down = None
        if in_ch != channels or stride != 1:
            self.downsample = Conv2d(in_ch, channels, 1, dtype, stride=stride, bias=False)
            self.bn_down = BatchNorm(channels)

    def forward(self, x, train: bool):
        h = F.relu(self.bn1(self.conv1(x), train))
        h = self.bn2(self.conv2(h), train)
        if self.downsample is not None:
            x = self.bn_down(self.downsample(x), train)
        return F.relu(x + h)


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, channels: int, stride: int, dtype):
        super().__init__()
        out_ch = channels * 4
        self.conv1 = Conv2d(in_ch, channels, 1, dtype, bias=False)
        self.bn1 = BatchNorm(channels)
        self.conv2 = Conv2d(channels, channels, 3, dtype, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(channels)
        self.conv3 = Conv2d(channels, out_ch, 1, dtype, bias=False)
        self.bn3 = BatchNorm(out_ch)
        self.downsample = self.bn_down = None
        if in_ch != out_ch or stride != 1:
            self.downsample = Conv2d(in_ch, out_ch, 1, dtype, stride=stride, bias=False)
            self.bn_down = BatchNorm(out_ch)

    def forward(self, x, train: bool):
        h = F.relu(self.bn1(self.conv1(x), train))
        h = F.relu(self.bn2(self.conv2(h), train))
        h = self.bn3(self.conv3(h), train)
        if self.downsample is not None:
            x = self.bn_down(self.downsample(x), train)
        return F.relu(x + h)


RESNET_BLOCKS = (_BasicBlock, _Bottleneck)


class ResNet2D(nn.Module):
    """Feature extractor: ``[B, H, W, C] → [B, output_dim]`` (fp32).

    ``pretrained`` with no ``pretrained_path`` warns at the first forward
    and trains from the random init, as the JAX module does; the load from
    ``pretrained_path`` is the engine's (``engine/classifier.py``).
    """

    def __init__(
        self,
        variant: str = "resnet18",
        pretrained: bool = False,
        pretrained_path: str = "",
        in_channels: int = 3,
        dtype=torch.float32,
    ):
        super().__init__()
        if variant not in RESNET_VARIANTS:
            raise ValueError(f"Unsupported ResNet variant: {variant}")
        self.variant, self.pretrained, self.pretrained_path = variant, pretrained, pretrained_path
        self.in_channels, self.dtype = in_channels, dtype
        block_type, stages, self.output_dim = RESNET_VARIANTS[variant]
        block = _BasicBlock if block_type == "basic" else _Bottleneck
        self.conv1 = Conv2d(in_channels, 64, 7, dtype, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.block_names = []
        in_ch = 64
        for stage, num_blocks in enumerate(stages):
            channels = 64 * 2**stage
            for i in range(num_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block(in_ch, channels, stride, dtype))
                self.block_names.append(name)
                in_ch = channels * block.expansion

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init: lecun-normal conv kernels, unit BatchNorm scales, zero biases and statistics."""
        reset_parameters(self, generator)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.pretrained and not self.pretrained_path:
            warnings.warn(
                "pretrained=True without pretrained_path: no ImageNet weights "
                "available offline; training from scratch. Provide a local "
                "torchvision state_dict .npz via config.pretrained_path "
                "(see load_pretrained_resnet)."
            )
        h = F.relu(self.bn1(self.conv1(x.to(self.dtype)), train))
        # NHWC viewed as NCHW for the pool: its padding is -inf
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
        for name in self.block_names:
            h = getattr(self, name)(h, train)
        return h.mean(dim=(1, 2)).to(torch.float32)


def _port_name(key: str) -> Optional[str]:
    """A torchvision resnet ``state_dict`` key → the port's name; None for what the extractor drops.

    ``fc.*`` (the classifier the feature extractor strips) and BatchNorm's
    ``num_batches_tracked`` map to nothing; ``layer<s>.<i>.downsample.0``
    (conv) and ``.1`` (BatchNorm) map to ``downsample`` and ``bn_down``.
    """
    parts = key.split(".")
    if parts[0] == "fc" or parts[-1] == "num_batches_tracked":
        return None
    if parts[0] in ("conv1", "bn1"):
        return key
    if not parts[0].startswith("layer"):
        raise ValueError(f"unrecognized torchvision resnet key: {key}")
    module, sub, rest = f"{parts[0]}_{parts[1]}", parts[2], parts[3:]
    if sub == "downsample":
        sub = "downsample" if rest[0] == "0" else "bn_down"
        rest = rest[1:]
    return ".".join([module, sub, *rest])


@torch.no_grad()
def load_pretrained_resnet(model: ResNet2D, npz_path: str, *, in_channels: int = 3) -> None:
    """Load a torchvision ``state_dict`` ``.npz`` into ``model`` in place.

    The names map by :func:`_port_name`; the layouts already agree (OIHW
    convs). When ``in_channels != 3`` the stem ``conv1`` keeps its random
    init, the reference's adaptation (a fresh first conv). Every array is
    shape-checked, and a key with no target, or a target with no key,
    raises: a bundle of another variant fails instead of part-loading.
    """
    bundle = np.load(npz_path)
    targets = model.state_dict()
    loaded = set()
    for key in bundle.files:
        name = _port_name(key)
        if name is None:
            continue
        if name == "conv1.weight" and in_channels != 3:
            continue
        if name not in targets:
            raise KeyError(f"{key}: no {name} in the model (wrong variant?)")
        arr = np.asarray(bundle[key])
        if tuple(arr.shape) != tuple(targets[name].shape):
            raise ValueError(
                f"{key}: shape {arr.shape} does not match {name} {tuple(targets[name].shape)}"
            )
        targets[name].copy_(torch.from_numpy(arr))
        loaded.add(name)
    expected = set(targets) - ({"conv1.weight"} if in_channels != 3 else set())
    missing = expected - loaded
    if missing:
        raise ValueError(
            f"pretrained bundle is missing {len(missing)} parameters, e.g. {sorted(missing)[:4]}"
        )
