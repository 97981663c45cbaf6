"""Forward noising and prediction conversions — port of ``diffusion/process.py``.

``bcast_right``, ``diffuse``, ``pred_to_x``, ``pred_to_eps``, ``clip_x``,
``cfg_combine``, the ancestral sampler step ``ddpm_sampler_step`` and
``weighted_mse_loss``. Images are NHWC, per-sample scalars broadcast over
the trailing axes.
"""

from __future__ import annotations

from typing import Optional

import torch

from .schedule import alpha_sigma, min_snr_weight

__all__ = [
    "bcast_right",
    "cfg_combine",
    "ddpm_sampler_step",
    "diffuse",
    "clip_x",
    "pred_to_x",
    "pred_to_eps",
    "weighted_mse_loss",
]


def bcast_right(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a per-sample vector ``[B]`` to ``[B, 1, ..., 1]`` with ``ndim`` axes."""
    return v.reshape(v.shape + (1,) * (ndim - v.ndim))


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    return bcast_right(torch.as_tensor(v, device=ref.device).to(ref.dtype), ref.ndim)


def diffuse(
    x: torch.Tensor,
    alpha_t: torch.Tensor,
    sigma_t: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward noising ``z_t = α_t·x + σ_t·ε``; returns ``(z_t, ε)`` in ``x.dtype``.

    ε is drawn from ``generator`` unless given (tests inject JAX's draws).
    """
    if eps is None:
        eps = torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype
        )
    return _like(alpha_t, x) * x + _like(sigma_t, x) * eps, eps


def clip_x(x: torch.Tensor) -> torch.Tensor:
    """Clip the predicted clean image to [-1, 1]."""
    return torch.clamp(x, -1.0, 1.0)


def cfg_combine(pred: torch.Tensor, u_pred: torch.Tensor, cfg_w: float) -> torch.Tensor:
    """Classifier-free guidance: ``(1 + w)·pred − w·u_pred``."""
    return (1.0 + cfg_w) * pred - cfg_w * u_pred


def pred_to_x(pred, z_t, alpha_t, sigma_t, pred_param: str) -> torch.Tensor:
    """Convert a model output (v̂ or ε̂) to the clean-image estimate x̂."""
    alpha_t, sigma_t = _like(alpha_t, z_t), _like(sigma_t, z_t)
    if pred_param == "v":
        return alpha_t * z_t - sigma_t * pred
    if pred_param == "eps":
        return (z_t - sigma_t * pred) / alpha_t
    raise ValueError(f"Invalid pred_param {pred_param!r}")


def pred_to_eps(pred, z_t, alpha_t, sigma_t, pred_param: str) -> torch.Tensor:
    """Convert a model output (v̂ or ε̂) to the noise estimate ε̂."""
    if pred_param == "eps":
        return pred
    if pred_param == "v":
        return _like(sigma_t, z_t) * z_t + _like(alpha_t, z_t) * pred
    raise ValueError(f"Invalid pred_param {pred_param!r}")


def ddpm_sampler_step(
    z_t: torch.Tensor,
    pred: torch.Tensor,
    u_pred: torch.Tensor,
    logsnr_t,
    logsnr_s,
    *,
    cfg_w: float,
    pred_param: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One ancestral DDPM posterior step from ``t`` to ``s < t``; returns ``(μ, var)``.

    ``logsnr_t``/``logsnr_s`` are scalars or ``[B]`` vectors (float32). The
    guided x̂ is clipped to [-1, 1] before the posterior mean; with
    ``c = −expm1(logsnr_t − logsnr_s)``, ``μ = α_s·(z_t·(1 − c)/α_t + c·x̂)``
    and ``var = σ_s²·c``, the coefficients cast to ``z_t.dtype``.
    """
    logsnr_t = torch.as_tensor(logsnr_t, device=z_t.device).to(torch.float32)
    logsnr_s = torch.as_tensor(logsnr_s, device=z_t.device).to(torch.float32)
    c = -torch.expm1(logsnr_t - logsnr_s)
    alpha_t, sigma_t = alpha_sigma(logsnr_t)
    alpha_s, sigma_s = alpha_sigma(logsnr_s)

    guided = cfg_combine(pred, u_pred, cfg_w)
    x_pred = clip_x(pred_to_x(guided, z_t, alpha_t, sigma_t, pred_param))

    c_b, alpha_t_b, alpha_s_b, sigma_s_b = (_like(v, z_t) for v in (c, alpha_t, alpha_s, sigma_s))
    mu = alpha_s_b * (z_t * (1.0 - c_b) / alpha_t_b + c_b * x_pred)
    return mu, torch.square(sigma_s_b) * c_b


def weighted_mse_loss(
    pred: torch.Tensor,
    z_t: torch.Tensor,
    eps_t: torch.Tensor,
    logsnr_t: torch.Tensor,
    pred_param: str,
) -> torch.Tensor:
    """Min-SNR-weighted MSE on the ε residual: ``mean(w(logSNR)·(ε̂ − ε)²)``.

    ε̂ comes from the model output by :func:`pred_to_eps`; ``w`` is
    :func:`~.schedule.min_snr_weight`. Accumulates in float32 even when the
    prediction is bfloat16.
    """
    alpha_t, sigma_t = alpha_sigma(logsnr_t)
    eps_pred = pred_to_eps(pred, z_t, alpha_t, sigma_t, pred_param)
    weight = bcast_right(min_snr_weight(logsnr_t, pred_param), z_t.ndim)
    error = (eps_pred - eps_t).to(torch.float32)
    return torch.mean(weight * torch.square(error))
