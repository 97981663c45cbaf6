"""Ancestral DDPM sampler with classifier-free guidance — port of ``diffusion/sampler.py``.

The same trajectory as the JAX sampler:

- ``steps = linspace(from_t, 0, S + 1)`` (JAX's formula
  ``from_t·(1 − i/S)``, bit for bit) and its logSNRs in float32;
- S noisy posterior steps, the last one to t = 0 included, then one extra
  noiseless step on ``(logsnr[-2], logsnr[-1])`` whose clipped posterior
  mean is the sample;
- ``from_t < 1`` re-noises the input image to ``from_t`` instead of
  starting from N(0, I) (counterfactual explanation);
- the conditional and unconditional (null token) predictions of a step come
  from ONE forward on a 2B batch; with a prefix split (UNet), the prefix
  runs once on B and only the conditioned tail on 2B.

Under several data ranks (``data_rows=(index, count)``) ``x`` holds this
rank's rows; every draw is made at the global batch's shape and the rank
keeps its rows, so a seed samples the same images at any world size.

The JAX ``lax.scan`` is a Python loop here; the draws come from a
:class:`SampleDraws` provider — :class:`TorchSampleDraws` over a
``torch.Generator`` on the device, or, in the tests, one that replays the
JAX key tree.
"""

from __future__ import annotations

from typing import Callable, Protocol

import torch
from torch.utils._pytree import tree_map

from .process import clip_x, ddpm_sampler_step, diffuse
from .schedule import alpha_sigma

__all__ = ["SampleDraws", "TorchSampleDraws", "make_sampler"]


class SampleDraws(Protocol):
    """Source of the sampler's random draws."""

    def init(self, shape: tuple) -> torch.Tensor:
        """ε ~ N(0, 1) of ``shape``: the starting noise (or the re-noising's ε when ``from_t < 1``)."""

    def step(self, index: int, shape: tuple) -> torch.Tensor:
        """ε ~ N(0, 1) of ``shape`` for noisy step ``index``."""


class TorchSampleDraws:
    """Draws from one ``torch.Generator``, in call order, on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def init(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.generator.device)

    def step(self, index, shape):
        return torch.randn(shape, generator=self.generator, device=self.generator.device)


def make_sampler(
    apply_fn: Callable,
    schedule_fn: Callable,
    *,
    pred_param: str,
    cfg_w: float,
    null_token: int,
    sampling_steps: int,
    encode_fn: Callable = None,
    tail_fn: Callable = None,
    data_rows: tuple = (0, 1),
):
    """Build ``sample(x, labels, draws, from_t=1.0) -> x̂`` in ``[-1, 1]``.

    ``apply_fn(z, logsnr, labels)`` is the denoiser; with
    ``encode_fn(z, logsnr) -> state`` and ``tail_fn(state, labels)`` the CFG
    pair shares the prefix. ``x`` gives the shape and dtype and, when
    ``from_t < 1``, the image to re-noise.
    """
    prefix = encode_fn is not None and tail_fn is not None
    data_index, data_count = data_rows

    def local(noise: torch.Tensor, b: int) -> torch.Tensor:
        return noise if data_count == 1 else noise[data_index * b : (data_index + 1) * b]

    @torch.no_grad()
    def sample(x: torch.Tensor, labels: torch.Tensor, draws: SampleDraws, from_t: float = 1.0):
        b, dev = x.shape[0], x.device
        i = torch.arange(sampling_steps + 1, dtype=torch.float32, device=dev)
        steps = float(from_t) * (1.0 - i / sampling_steps)
        logsnrs = schedule_fn(steps)  # [S + 1] float32

        gshape = (b * data_count,) + tuple(x.shape[1:])
        eps = local(draws.init(gshape), b).to(dev, x.dtype)
        if from_t == 1.0:
            z = eps
        else:
            logsnr_f = schedule_fn(torch.full((b,), float(from_t), device=dev))
            z, _ = diffuse(x, *alpha_sigma(logsnr_f), eps=eps)

        labels = labels.to(dev)
        pair_labels = torch.cat([labels, torch.full_like(labels, null_token)])

        def model_pair(z_t, logsnr):
            if prefix:
                state = encode_fn(z_t, logsnr.expand(b))
                pred = tail_fn(tree_map(lambda a: torch.cat([a, a]), state), pair_labels)
            else:
                pred = apply_fn(torch.cat([z_t, z_t]), logsnr.expand(2 * b), pair_labels)
            return pred[:b], pred[b:]

        for s in range(sampling_steps):
            pred, u_pred = model_pair(z, logsnrs[s])
            mu, var = ddpm_sampler_step(
                z, pred, u_pred, logsnrs[s], logsnrs[s + 1], cfg_w=cfg_w, pred_param=pred_param
            )
            noise = local(draws.step(s, gshape), b).to(dev, mu.dtype)
            z = mu + noise * torch.sqrt(var)

        # the final step: the posterior mean of the last pair, no noise
        pred, u_pred = model_pair(z, logsnrs[-2])
        mu, _ = ddpm_sampler_step(
            z, pred, u_pred, logsnrs[-2], logsnrs[-1], cfg_w=cfg_w, pred_param=pred_param
        )
        return clip_x(mu)

    return sample
