"""Train state, EMA stepping and the optimizer — port of ``engine/state.py``.

EMA: ``ema_pytorch.EMA(model, beta, update_after_step, update_every)``
semantics, as the JAX module reproduces them:

- the call counter is pre-increment, and only calls with
  ``counter % update_every == 0`` change anything;
- up to ``update_after_step`` the EMA is a straight copy of the parameters;
- after it the decay ramps ``d = min(β, 1 − (1 + e)^(−2/3))`` with
  ``e = counter − update_after_step``.

Optimizer: clip-by-global-norm 1.0, then Adam with the HF cosine-warmup
schedule, as optax's ``chain(clip_by_global_norm, adam(schedule))``. Written
by hand for parity: optax's clip has no epsilon (``torch.nn.utils.
clip_grad_norm_`` adds 1e-6), and optax evaluates the schedule at the
pre-increment count, so the first step's learning rate is 0 under warmup.
The updates run as ``torch._foreach_*`` ops on the parameters in place, with
no host synchronisation: the clip factor stays on the device.
:meth:`Optimizer.update` computes the step's learning rate and bias
corrections on the host (:meth:`Optimizer.hyper`) and hands them to
:meth:`Optimizer.apply` as Python floats; a captured CUDA graph hands
``apply`` the same float32 values as 0-dim device tensors, which it fills
before each replay. Both give the same bits: on a CUDA device
``torch._foreach_div`` by a Python float multiplies by the float's float32
reciprocal, so there the tensors hold the corrections' reciprocals
(``hyper(count, reciprocal=True)``) and ``apply`` multiplies by them.

Under several processes the optimizer and the EMA act on each rank's local
pieces (``parallel.sharding.Placement.local``): whole replicas under DDP,
shards under FSDP and tensor parallelism, where the moments and the EMA
copy are shards too. The clip's ‖g‖ is the whole gradient's:
``global_norm`` (``Placement.grad_norm``) sums the shards' squares over the
ranks.

``state_dtype=torch.bfloat16`` is the JAX package's ``compress_opt_state``:
Adam's ``mu`` and ``nu`` are stored in bf16; each update casts them up to
fp32, updates the moments and takes the step from the fp32 moments, then
rounds the new moments to bf16 for storage. The count, the parameters, the
gradients and the EMA stay as they are.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..parallel.sharding import Placement

__all__ = [
    "AdamState",
    "EmaConfig",
    "Optimizer",
    "TrainState",
    "cosine_warmup_schedule",
    "ema_decay",
    "ema_update",
    "init_train_state",
    "lr_at",
    "make_optimizer",
]


@dataclasses.dataclass(frozen=True)
class EmaConfig:
    beta: float = 0.9999
    update_after_step: int = 100
    update_every: int = 10
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0


def ema_decay(counter: int, cfg: EmaConfig) -> float:
    """Decay for the 0-based pre-increment call number ``counter`` (float32 arithmetic)."""
    epoch = max(np.float32(counter) - np.float32(cfg.update_after_step), np.float32(0.0))
    if epoch <= 0.0:
        return 0.0
    value = np.float32(1.0) - (np.float32(1.0) + epoch / np.float32(cfg.inv_gamma)) ** (
        -np.float32(cfg.power)
    )
    return float(np.clip(value, np.float32(0.0), np.float32(cfg.beta)))


@torch.no_grad()
def ema_update(ema_params, params, counter: int, cfg: EmaConfig) -> None:
    """One ``EMA.update()`` call in place: ``e ← d·e + (1 − d)·p`` when ``counter`` is due."""
    if counter % cfg.update_every != 0:
        return
    d = np.float32(ema_decay(counter, cfg))
    ema_params, params = list(ema_params), list(params)
    torch._foreach_mul_(ema_params, float(d))
    torch._foreach_add_(ema_params, params, alpha=float(np.float32(1.0) - d))


def lr_at(base_lr: float, warmup_steps: int, total_steps: int, step: int) -> float:
    """HF ``get_cosine_schedule_with_warmup`` (num_cycles 0.5) at ``step``, in float64."""
    step = float(step)
    if step < warmup_steps:
        return base_lr * step / max(1.0, float(warmup_steps))
    progress = (step - warmup_steps) / max(1.0, float(total_steps - warmup_steps))
    return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


def cosine_warmup_schedule(base_lr: float, warmup_steps: int, total_steps: int):
    """The schedule as the JAX module evaluates it, in float32: ``step -> lr``."""
    f = np.float32

    def schedule(step: int) -> float:
        step = f(step)
        if step < warmup_steps:
            return float(f(base_lr) * (step / max(f(1.0), f(warmup_steps))))
        progress = (step - f(warmup_steps)) / max(f(1.0), f(total_steps - warmup_steps))
        cos = max(f(0.0), f(0.5) * (f(1.0) + np.cos(f(np.pi) * progress)))
        return float(f(base_lr) * cos)

    return schedule


@dataclasses.dataclass
class AdamState:
    count: int  # updates taken; the schedule reads it before the increment
    mu: list
    nu: list

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, d: dict) -> None:
        if len(d["mu"]) != len(self.mu) or len(d["nu"]) != len(self.nu):
            raise ValueError(
                f"optimizer state holds {len(d['mu'])} moments, the model "
                f"{len(self.mu)} parameters"
            )
        self.count = int(d["count"])
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(d["mu"]) + list(d["nu"])):
                dst.copy_(src)


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(schedule))`` on a parameter list."""

    def __init__(
        self,
        schedule,
        *,
        max_grad_norm: float = 1.0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        state_dtype: torch.dtype = torch.float32,
    ):
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.state_dtype = state_dtype

    def init(self, params) -> AdamState:
        params = list(params)
        return AdamState(0, *(
            [torch.zeros_like(p, dtype=self.state_dtype) for p in params] for _ in range(2)
        ))

    def hyper(self, count: int, *, reciprocal: bool = False) -> tuple[float, float, float]:
        """``(lr, 1 − β₁ᵗ, 1 − β₂ᵗ)`` of the update taken at pre-increment ``count`` (t = count + 1), float32 values.

        ``reciprocal``: the corrections' float32 reciprocals instead, what a
        CUDA device multiplies by where :meth:`apply` divides by a float.
        """
        f = np.float32
        t = f(count + 1)
        bc1, bc2 = f(1.0) - f(self.b1) ** t, f(1.0) - f(self.b2) ** t
        if reciprocal:
            bc1, bc2 = f(1.0) / bc1, f(1.0) / bc2
        return self.schedule(count), float(bc1), float(bc2)

    @torch.no_grad()
    def update(self, grads, state: AdamState, params, *, global_norm: Optional[Callable] = None) -> None:
        """Clip ``grads``, step Adam and apply the update to ``params``, all in place; advances ``state.count``.

        ``global_norm(grads)`` gives ‖g‖ when ``grads`` are shards (None: they are whole).
        """
        lr, bc1, bc2 = self.hyper(state.count)
        state.count += 1
        self.apply(grads, state, params, lr, bc1, bc2, global_norm=global_norm)

    @torch.no_grad()
    def apply(self, grads, state: AdamState, params, lr, bc1, bc2, *,
              global_norm: Optional[Callable] = None) -> None:
        """The clip and Adam's step at learning rate ``lr`` and bias corrections ``bc1``, ``bc2``; leaves ``state.count``.

        The three are Python floats, or 0-dim float32 tensors on the
        parameters' device (what a captured graph reads at each replay); on
        a CUDA device the tensors ``bc1``, ``bc2`` are the corrections'
        reciprocals (``hyper(count, reciprocal=True)``).
        """
        grads, params = list(grads), list(params)
        # clip: g / ‖g‖ · max where ‖g‖ ≥ max, untouched below (no epsilon)
        norm = global_norm(grads) if global_norm is not None else None
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        below = norm < self.max_grad_norm
        torch._foreach_div_(grads, torch.where(below, torch.ones_like(norm), norm))
        torch._foreach_mul_(
            grads, torch.where(below, torch.ones_like(norm), torch.full_like(norm, self.max_grad_norm))
        )
        div, div_ = torch._foreach_div, torch._foreach_div_
        if isinstance(bc1, torch.Tensor) and bc1.is_cuda:  # a float's division there
            div, div_ = torch._foreach_mul, torch._foreach_mul_
        mu, nu = state.mu, state.nu
        compressed = self.state_dtype != torch.float32
        if compressed:  # the moments in fp32 for the update
            mu, nu = [m.float() for m in mu], [n.float() for n in nu]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        if compressed:
            # store the moments rounded to the state dtype, then take the
            # step in the fp32 copies' memory
            torch._foreach_copy_(state.mu, mu)
            torch._foreach_copy_(state.nu, nu)
            denom, step = nu, mu
            div_(denom, bc2)
            div_(step, bc1)
        else:
            denom, step = div(nu, bc2), div(mu, bc1)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(step, -lr)
        torch._foreach_add_(params, step)


def make_optimizer(
    learning_rate: float,
    warmup_steps: int,
    total_steps: int,
    *,
    max_grad_norm: float = 1.0,
    state_dtype: Optional[str] = None,
) -> Optimizer:
    """Clip-by-global-norm then Adam with the HF cosine warmup.

    ``state_dtype='bf16'`` stores Adam's moments in bfloat16 (the module
    docstring); None/'fp32' keeps them in float32.
    """
    if state_dtype in ("bf16", "bfloat16"):
        dtype = torch.bfloat16
    elif state_dtype in (None, "fp32", "float32", "no"):
        dtype = torch.float32
    else:
        raise ValueError(
            f"optimizer_state_dtype must be 'fp32' or 'bf16', got {state_dtype!r}"
        )
    return Optimizer(
        cosine_warmup_schedule(learning_rate, warmup_steps, total_steps),
        max_grad_norm=max_grad_norm,
        state_dtype=dtype,
    )


@dataclasses.dataclass
class TrainState:
    """What a train step advances: the trained model, its EMA copy, Adam's state, two counters.

    ``model`` holds the training parameters and ``ema_model`` the EMA copy
    (same structure, no gradients); ``opt_state`` is None until an optimizer
    is built (an evaluation-only engine has none). ``placement`` and
    ``ema_placement`` say where each lives (one process: nowhere special).
    """

    model: nn.Module
    ema_model: nn.Module
    opt_state: Optional[AdamState] = None
    step: int = 0  # optimizer steps taken
    ema_counter: int = 0  # ema_update() calls
    placement: Optional[Placement] = None
    ema_placement: Optional[Placement] = None

    def __post_init__(self):
        self.placement = self.placement or Placement(self.model)
        self.ema_placement = self.ema_placement or Placement(self.ema_model)

    def params(self) -> list:
        """This rank's pieces of the training parameters (the whole tensors on one process)."""
        return [Placement.local(p) for p in self.model.parameters()]

    def ema_params(self) -> list:
        return [Placement.local(p) for p in self.ema_model.parameters()]


def init_train_state(
    model: nn.Module,
    tx: Optional[Optimizer] = None,
    *,
    ema_model: Optional[nn.Module] = None,
    placement: Optional[Placement] = None,
    ema_placement: Optional[Placement] = None,
) -> TrainState:
    """A fresh state: the EMA starts as a copy of the parameters, counters at 0.

    ``ema_model`` (placed like ``model``) is reused, its values overwritten
    by the parameters'; without it the EMA is a new deep copy.
    """
    if ema_model is None:
        ema_model = copy.deepcopy(model).requires_grad_(False)
    else:
        with torch.no_grad():
            torch._foreach_copy_(
                [Placement.local(p) for p in ema_model.parameters()],
                [Placement.local(p) for p in model.parameters()],
            )
    opt_state = (
        tx.init(Placement.local(p) for p in model.parameters()) if tx is not None else None
    )
    return TrainState(model, ema_model, opt_state, placement=placement, ema_placement=ema_placement)
