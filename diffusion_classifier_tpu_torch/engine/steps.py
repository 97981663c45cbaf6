"""The training loss and step — port of ``engine/steps.py``.

One optimizer step: per microbatch, CFG label dropout → forward noising →
denoiser forward and backward (gradients summed over the microbatches, then
divided by their count) → global-norm clip → Adam → EMA. The JAX step is one
jitted program with the accumulation scanned inside; here it is a Python
loop over ``loss.backward()`` calls, the same arithmetic.

The random draws (dropout uniforms, t, ε) come from a :class:`TrainDraws`
provider, requested per microbatch in order: :class:`TorchTrainDraws` over a
``torch.Generator`` on the device, or, in the tests, one that replays the JAX
key tree (``split(rng, 3)`` per microbatch, ``split(rng, k)`` over them).
"""

from __future__ import annotations

from typing import Callable, Protocol

import torch

from ..diffusion.process import diffuse, weighted_mse_loss
from ..diffusion.schedule import alpha_sigma
from .state import EmaConfig, Optimizer, TrainState, ema_update

__all__ = [
    "CFG_DROP_P",
    "TorchTrainDraws",
    "TrainDraws",
    "make_loss_fn",
    "make_train_step",
]

CFG_DROP_P = 0.15


class TrainDraws(Protocol):
    """Source of the train step's random draws."""

    def loss(
        self, micro: int, n_micro: int, batch: int, x_shape: tuple
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(u ~ U[0,1) [batch], t ~ U[0,1) [batch], ε ~ N(0,1) of x_shape)`` for one microbatch."""


class TorchTrainDraws:
    """Draws from one ``torch.Generator``, in call order, on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def loss(self, micro, n_micro, batch, x_shape):
        g, dev = self.generator, self.generator.device
        u = torch.rand((batch,), generator=g, device=dev)
        t = torch.rand((batch,), generator=g, device=dev)
        return u, t, torch.randn(x_shape, generator=g, device=dev)


def make_loss_fn(
    apply_fn: Callable,
    schedule_fn: Callable,
    *,
    pred_param: str,
    null_token: int,
    cfg_dropout: float = CFG_DROP_P,
):
    """Build ``loss(x, labels, u, t, eps) -> scalar`` over the denoiser ``apply_fn(z, logsnr, labels)``.

    A label is dropped to ``null_token`` where ``u < cfg_dropout``.
    """

    def loss_fn(x, labels, u, t, eps):
        if cfg_dropout > 0.0:
            labels = torch.where(u < cfg_dropout, torch.full_like(labels, null_token), labels)
        logsnr_t = schedule_fn(t)
        alpha_t, sigma_t = alpha_sigma(logsnr_t)
        z_t, eps_t = diffuse(x, alpha_t, sigma_t, eps=eps.to(x.dtype))
        pred = apply_fn(z_t, logsnr_t, labels)
        return weighted_mse_loss(pred, z_t, eps_t, logsnr_t, pred_param)

    return loss_fn


def make_train_step(
    loss_fn: Callable,
    tx: Optimizer,
    ema_cfg: EmaConfig,
    *,
    grad_accum_steps: int = 1,
):
    """Build ``train_step(state, x, labels, draws) -> loss`` (a detached scalar; no host sync)."""
    k = grad_accum_steps

    def step(state: TrainState, x: torch.Tensor, labels: torch.Tensor, draws) -> torch.Tensor:
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by grad_accum_steps {k}")
        params = state.params()
        for p in params:
            p.grad = None
        total = None
        for i, (mx, ml) in enumerate(zip(x.split(b // k), labels.split(b // k))):
            u, t, eps = draws.loss(i, k, b // k, tuple(mx.shape))
            loss_i = loss_fn(mx, ml, u, t, eps)
            loss_i.backward()  # sums into .grad across microbatches
            total = loss_i.detach() if total is None else total + loss_i.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if k > 1:
            total = total / k
            torch._foreach_div_(grads, float(k))
        tx.update(grads, state.opt_state, params)
        ema_update(state.ema_params(), params, state.ema_counter, ema_cfg)
        for p in params:
            p.grad = None
        state.step += 1
        state.ema_counter += 1
        return total

    return step
