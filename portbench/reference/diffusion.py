"""The diffusion arithmetic around the denoiser, plain and in float32.

From the definitions of Kingma et al. (variational diffusion models, v
prediction), Hoogeboom et al. (shifted cosine schedule, arXiv 2301.11093)
and Hang et al. (min-SNR weighting, arXiv 2303.09556), as the upstream
``diffusion/diffusion_classifier.py`` uses them:

- the one-level Haar transform of an NHWC image, coefficient k of input
  channel i at output channel ``4·i + k`` (cA, cH, cV, cD), halved into
  [-1, 1];
- the cosine logSNR schedule with its bounds shifted by
  ``log(noise_d / image_d)``, and the shifted schedule, 2·that shift above;
- ``z = α·x + σ·ε`` with ``α² = sigmoid(λ)``, ``σ² = sigmoid(−λ)``;
- ε from a v prediction, ``σ·z + α·v``;
- the per-class ε-error tournament: mean squared-error sums over the
  evaluations, the lowest mean wins, ties to the lower class id;
- the training loss (labels dropped to the null class where ``u < 0.15``,
  min-SNR weight ``1 / (1 + min(e^λ, 5))`` for v), Adam after a clip by
  global norm 1 and the cosine schedule with linear warmup;
- the EMA of the parameters as ``ema_pytorch`` keeps it: every
  ``update_every``-th update counted from 0, ``e ← d·e + (1 − d)·p`` with
  ``d = 0`` up to ``update_after_step`` and ``1 − (1 + n / inv_gamma)^−power``
  (at most β) after ``n`` more.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "CFG_DROP_P",
    "adam_step",
    "alpha_sigma",
    "ema_update",
    "eps_from_pred",
    "haar",
    "logsnr",
    "lr_at",
    "tournament",
    "weighted_loss",
]

CFG_DROP_P = 0.15


def haar(x: torch.Tensor) -> torch.Tensor:
    """``[N, H, W, C] → [N, H/2, W/2, 4C]``, the Haar coefficients halved (the range [-1, 1] kept)."""
    n, h, w, c = x.shape
    a, b = x[:, 0::2, 0::2], x[:, 0::2, 1::2]
    cc, d = x[:, 1::2, 0::2], x[:, 1::2, 1::2]
    coeffs = [(a + b + cc + d) / 2, (a + b - cc - d) / 2, (a - b + cc - d) / 2, (a - b - cc + d) / 2]
    return torch.stack(coeffs, dim=-1).reshape(n, h // 2, w // 2, 4 * c) / 2


def logsnr(t: torch.Tensor, schedule: str, noise_d: float, image_d: float) -> torch.Tensor:
    """λ(t) of the cosine or shifted cosine schedule, logSNR bounds ±15."""
    shift = math.log(noise_d / image_d)
    t_min = math.atan(math.exp(-0.5 * (15.0 + shift)))
    t_max = math.atan(math.exp(-0.5 * (-15.0 + shift)))
    lam = -2.0 * torch.log(torch.tan(t_min + t.float() * (t_max - t_min)).clamp(min=1e-20))
    if schedule == "shifted_cosine":
        return lam + 2.0 * shift
    if schedule == "cosine":
        return lam
    raise ValueError(f"unknown schedule {schedule!r}")


def alpha_sigma(lam: torch.Tensor):
    return torch.sigmoid(lam).sqrt(), torch.sigmoid(-lam).sqrt()


def _col(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def eps_from_pred(pred, z, lam, pred_param: str):
    """ε implied by the denoiser's output: v → ``σ·z + α·v``; ε as it is."""
    if pred_param == "eps":
        return pred
    if pred_param != "v":
        raise ValueError(f"unknown pred_param {pred_param!r}")
    a, s = alpha_sigma(lam)
    return _col(s, z.ndim) * z + _col(a, z.ndim) * pred


def tournament(err: torch.Tensor, evaluation_per_stage, n_keep_per_stage) -> torch.Tensor:
    """Predicted classes ``[B]`` from ε-error sums ``err [E, B, C]``, stage by stage.

    Stage s scores the survivors by their mean over the first
    ``evaluation_per_stage[s]`` evaluations and keeps the ``n_keep`` lowest,
    ties to the lower class id; the last stage keeps one.
    """
    e_total, b, c = err.shape
    alive = torch.ones((b, c), dtype=torch.bool, device=err.device)
    for evals, keep in zip(evaluation_per_stage, n_keep_per_stage):
        mean = err[:evals].sum(0) / evals
        mean = torch.where(alive, mean, torch.full_like(mean, math.inf))
        order = torch.sort(mean, dim=1, stable=True).indices[:, :keep]
        alive = torch.zeros_like(alive).scatter_(1, order, True)
    return order[:, 0]


def weighted_loss(pred, z, eps, lam, pred_param: str) -> torch.Tensor:
    """``mean(w(λ)·(ε̂ − ε)²)`` with the min-SNR weight."""
    snr = torch.exp(lam).clamp(max=5.0)
    w = 1.0 / (1.0 + snr) if pred_param == "v" else 1.0 / snr
    err = eps_from_pred(pred, z, lam, pred_param) - eps
    return torch.mean(_col(w, z.ndim) * err * err)


def lr_at(step: int, base: float, warmup: int, total: int) -> float:
    """The cosine schedule with linear warmup at the update count ``step`` (float32 as the optimizer reads it)."""
    f = np.float32
    step = f(step)
    if step < warmup:
        return float(f(base) * (step / max(f(1.0), f(warmup))))
    progress = (step - f(warmup)) / max(f(1.0), f(total - warmup))
    return float(f(base) * max(f(0.0), f(0.5) * (f(1.0) + np.cos(f(np.pi) * progress))))


@torch.no_grad()
def adam_step(params, grads, mu, nu, count: int, lr: float, *, max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8):
    """Clip ``grads`` to global norm ``max_norm``, then one Adam update of ``params`` in place.

    ``count`` is the number of updates before this one. Returns the clipped gradients.
    """
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    clipped = [g * factor for g in grads]
    n = count + 1
    bc1, bc2 = 1.0 - b1**n, 1.0 - b2**n
    for p, g, m, v in zip(params, clipped, mu, nu):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        p.add_(-lr * (m / bc1) / ((v / bc2).sqrt() + eps))
    return clipped


@torch.no_grad()
def ema_update(ema, params, counter: int, *, beta=0.9999, update_after_step=100, update_every=10,
               inv_gamma=1.0, power=2.0 / 3.0) -> None:
    """The EMA's update number ``counter`` (0-based, one a step) of ``ema`` towards ``params``, in place."""
    if counter % update_every:
        return
    n = max(counter - update_after_step, 0)
    d = 0.0 if n == 0 else min(max(1.0 - (1.0 + n / inv_gamma) ** -power, 0.0), beta)
    for e, p in zip(ema, params):
        e.mul_(d).add_(p, alpha=1.0 - d)
