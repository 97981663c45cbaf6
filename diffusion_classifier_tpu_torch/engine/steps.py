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

``debug_nans`` is the port's ``jax_debug_nans``: the step checks that the
loss and every gradient are finite before it updates anything, and raises
``FloatingPointError`` if not. The check reads one flag from the device;
without ``debug_nans`` the step makes no host synchronisation.

Spans (``utils/profiling.py``): ``train.draws``, one
``train.forward_backward`` a microbatch (counter ``train.microbatches``),
``train.optimizer`` (Adam's update, the clip inside it) and ``train.ema``.
The backward's kernels, launched from autograd's own thread, fall by time
inside ``train.forward_backward``.
"""

from __future__ import annotations

from typing import Callable, Protocol

import torch

from ..diffusion.process import diffuse, weighted_mse_loss
from ..diffusion.schedule import alpha_sigma
from ..utils import profiling
from .state import EmaConfig, Optimizer, TrainState, ema_update

__all__ = [
    "CFG_DROP_P",
    "check_finite",
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


def check_finite(what: str, tensors) -> None:
    """Raise ``FloatingPointError`` unless every tensor of ``tensors`` is finite (one host sync)."""
    tensors = list(tensors)
    if tensors and not bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all()):
        raise FloatingPointError(f"debug_nans: non-finite values in {what}")


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
    debug_nans: bool = False,
):
    """Build ``train_step(state, x, labels, draws) -> loss`` (a detached scalar).

    No host sync, unless ``debug_nans``: then a non-finite loss or gradient
    raises ``FloatingPointError`` before the update.

    Under several data ranks (``state.placement``) ``x`` holds this rank's
    rows of the global batch. The draws stay global: each microbatch's are
    drawn at the global microbatch's shape, in the JAX order, and the rank
    takes its rows, so a seed gives the same draws at any world size. The
    returned loss is the global batch's mean; gradients reduce only with the
    last microbatch (DDP's ``no_sync``, FSDP's gradient sync switched off
    before it).
    """
    k = grad_accum_steps

    def step(state: TrainState, x: torch.Tensor, labels: torch.Tensor, draws) -> torch.Tensor:
        pl = state.placement
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by grad_accum_steps {k}")
        global_micro = b * pl.data_count // k
        shape = (global_micro,) + tuple(x.shape[1:])
        with profiling.span("train.draws"):
            parts = [draws.loss(i, k, global_micro, shape) for i in range(k)]
            u, t, eps = parts[0] if k == 1 else (torch.cat(d) for d in zip(*parts))
            if pl.data_count > 1:
                rows = slice(pl.data_index * b, (pl.data_index + 1) * b)
                u, t, eps = u[rows], t[rows], eps[rows]
        model_params = list(state.model.parameters())
        for p in model_params:
            p.grad = None
        total = None
        mb = b // k
        for i in range(k):
            sl = slice(i * mb, (i + 1) * mb)
            profiling.count("train.microbatches")
            with profiling.span("train.forward_backward"), pl.sync_context(last=i == k - 1):
                loss_i = loss_fn(x[sl], labels[sl], u[sl], t[sl], eps[sl])
                loss_i.backward()  # sums into .grad across microbatches
            total = loss_i.detach() if total is None else total + loss_i.detach()
        params = state.params()
        grads = [
            pl.local(p.grad) if p.grad is not None else torch.zeros_like(q)
            for p, q in zip(model_params, params)
        ]
        if k > 1:
            total = total / k
            torch._foreach_div_(grads, float(k))
        total = pl.mean_over_data(total)
        if debug_nans:
            check_finite("the loss and gradients", [total, *grads])
        with profiling.span("train.optimizer"):
            tx.update(grads, state.opt_state, params, global_norm=pl.grad_norm)
        with profiling.span("train.ema"):
            ema_update(state.ema_params(), params, state.ema_counter, ema_cfg)
        for p in model_params:
            p.grad = None
        state.step += 1
        state.ema_counter += 1
        return total

    return step
