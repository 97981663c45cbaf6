"""Everything a run makes from ``--seed``: weights, the image pool, the diffusion draws.

Each stream has a key of its own, a 63-bit integer hashed from the seed and
the stream's tags, so any seed (larger than 32 bits too) gives the same
inputs every time, and streams never overlap.

- :func:`make_weights`: every parameter of the denoiser from one normal draw
  on the device: weight matrices and convolution kernels LeCun-scaled and cut
  at 2σ (as the port's own init), embeddings likewise over their width, norm
  scales ``1 + 0.05·n``, biases ``0.02·n`` (so biases and norms are checked
  too). Both the program and the reference are given these tensors.
- :func:`make_pool`: the traffic, a pool of host batches of float32 images
  uniform in [-1, 1] and integer labels, cycled by the window.
- :class:`ClassifyDraws` / :class:`TrainDraws`: the program's draws providers
  (its ``Draws`` and ``TrainDraws`` protocols). Every group's ``t`` and ``ε``
  come from a generator seeded for that (call, stage, group) or (step,
  microbatch), so the reference draws the same values again; the classify
  provider logs the shapes it was asked for.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

__all__ = ["ClassifyDraws", "TrainDraws", "key", "make_pool", "make_weights"]


def key(seed: int, *tags) -> int:
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _generator(device, k: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(k)


@torch.no_grad()
def make_weights(shapes: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}`` for ``shapes = {name: shape}``, drawn in one call on ``device``."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=_generator(device, key(seed, "weights")), device=device)
    out = {}
    for name, part in zip(names, flat.split(sizes)):
        shape = tuple(shapes[name])
        if len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            w = part.clamp_(-2.0, 2.0).mul_(1.0 / math.sqrt(fan_in) / 0.87962566103423978)
        elif name.endswith("bias"):
            w = part.mul_(0.02)
        else:
            w = part.mul_(0.05).add_(1.0)
        out[name] = w.view(shape)
    return out


def make_pool(seed: int, batches: int, batch: int, size: int, channels: int, classes: int):
    """``batches`` host batches ``{"images": float32 [B, size, size, C] in [-1, 1], "prompt": int64 [B]}``."""
    rng = np.random.Generator(np.random.PCG64(key(seed, "pool")))
    pool = []
    for _ in range(batches):
        images = rng.uniform(-1.0, 1.0, (batch, size, size, channels)).astype(np.float32)
        pool.append({"images": images, "prompt": rng.integers(0, classes, batch, dtype=np.int64)})
    return pool


class ClassifyDraws:
    """The classifier's draws for call ``call``; ``log`` gets ``(stage, group, t_shape, eps_shape)`` per group."""

    def __init__(self, seed: int, call: int, device, log=None):
        self.seed, self.call, self.device, self.log = seed, call, device, log

    def noise(self, stage, n_stages, group_idx, n_groups, t_shape, eps_shape):
        if self.log is not None:
            self.log.append((stage, group_idx, tuple(t_shape), tuple(eps_shape)))
        return self.draw(stage, group_idx, t_shape, eps_shape)

    def draw(self, stage, group_idx, t_shape, eps_shape):
        g = _generator(self.device, key(self.seed, "noise", self.call, stage, group_idx))
        t = torch.rand(tuple(t_shape), generator=g, device=self.device)
        return t, torch.randn(tuple(eps_shape), generator=g, device=self.device)


class TrainDraws:
    """The train step's draws ``(u, t, ε)`` for optimizer step ``step``."""

    def __init__(self, seed: int, step: int, device):
        self.seed, self.step, self.device = seed, step, device

    def loss(self, micro, n_micro, batch, x_shape):
        g = _generator(self.device, key(self.seed, "train", self.step, micro))
        u = torch.rand((batch,), generator=g, device=self.device)
        t = torch.rand((batch,), generator=g, device=self.device)
        return u, t, torch.randn(tuple(x_shape), generator=g, device=self.device)
