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

One CUDA graph per optimizer step: where the batch is on a CUDA device, the
state is one whole copy on one data rank (no DDP, FSDP or tensor-parallel
split) and ``debug_nans`` is off, the step from the static inputs to the
parameters' update (label dropout, noising, the forwards and backwards, the
gradient list, the clip and Adam) is captured with ``torch.cuda.graph`` and
replayed. A batch shape takes its first :data:`WARMUP_STEPS` steps eagerly
(kernel builds, cuBLAS and cuDNN plans, lazy state), is captured on the
next and replayed at once, so that step is taken too; at most
:data:`MAX_GRAPHS` shapes are captured, and a further one runs eagerly.
The draws, the upload and the EMA stay outside the graph: the draws and the
batch are copied into the graph's static tensors, and Adam's learning rate
and bias corrections, computed on the host as the eager step computes them,
into a device tensor (one host-to-device copy, no synchronisation). The
graphs belong to the state's parameters and moment lists: a state whose
lists are other objects drops them and captures anew. Every other step runs
eagerly, as :meth:`TrainStep.eager`.

Spans (``utils/profiling.py``): ``train.draws``, one
``train.forward_backward`` a microbatch, ``train.optimizer`` (Adam's
update, the clip inside it) and ``train.ema``; ``train.graph`` around a
replay, inside which ``train.forward_backward`` and ``train.optimizer`` do
not fire (they fire on the eager steps and at the capture). The backward's kernels, launched
from autograd's own thread, fall by time inside ``train.forward_backward``.
Counters: ``train.microbatches``, ``train.eager`` (steps taken eagerly),
``train.graph.captures`` and ``train.graph.replays`` (a captured step is
replayed once at its capture, and counted there too).
"""

from __future__ import annotations

import operator
from typing import Callable, Optional, Protocol

import torch

from ..diffusion.process import diffuse, weighted_mse_loss
from ..diffusion.schedule import alpha_sigma
from ..utils import profiling
from .state import EmaConfig, Optimizer, TrainState, ema_update

__all__ = [
    "CFG_DROP_P",
    "check_finite",
    "MAX_GRAPHS",
    "TorchTrainDraws",
    "TrainDraws",
    "TrainStep",
    "WARMUP_STEPS",
    "graph_route",
    "make_loss_fn",
    "make_train_step",
]

CFG_DROP_P = 0.15
WARMUP_STEPS = 2  # eager steps of a batch shape before its capture
MAX_GRAPHS = 2  # batch shapes with a captured step; a further shape runs eagerly


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


def graph_route(state: TrainState, x: torch.Tensor, debug_nans: bool) -> bool:
    """True where the step may run from a CUDA graph: a CUDA batch, one whole copy on one data rank, no ``debug_nans``."""
    return x.is_cuda and state.placement.single and not debug_nans


class _Captured:
    """One batch shape's step as a CUDA graph: the static tensors it reads, its loss, its warm-up count."""

    def __init__(self):
        self.warm = 0  # eager steps taken at this shape
        self.graph = self.loss = None
        self.inputs = self.hyper = None


class TrainStep:
    """``step(state, x, labels, draws) -> loss`` (a detached scalar): one optimizer step, eager or replayed.

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

    def __init__(self, loss_fn: Callable, tx: Optimizer, ema_cfg: EmaConfig, *,
                 grad_accum_steps: int = 1, debug_nans: bool = False):
        self.loss_fn, self.tx, self.ema_cfg = loss_fn, tx, ema_cfg
        self.k, self.debug_nans = grad_accum_steps, debug_nans
        self.graphs: dict = {}  # batch shape -> _Captured
        self._owner: Optional[tuple] = None  # the state's objects the graphs were captured on

    def __call__(self, state: TrainState, x: torch.Tensor, labels: torch.Tensor, draws) -> torch.Tensor:
        if x.shape[0] % self.k:
            raise ValueError(f"batch {x.shape[0]} not divisible by grad_accum_steps {self.k}")
        entry = self._entry(state, x, labels) if graph_route(state, x, self.debug_nans) else None
        if entry is None or entry.warm < WARMUP_STEPS:
            if entry is not None:
                entry.warm += 1
            return self.eager(state, x, labels, draws)
        return self._replay(entry, state, x, labels, draws)

    # ------------------------------------------------------------ both routes
    def _draws(self, state: TrainState, x: torch.Tensor, draws):
        """This rank's ``(u, t, ε)`` for the whole batch, its microbatches in order."""
        pl, k, b = state.placement, self.k, x.shape[0]
        global_micro = b * pl.data_count // k
        shape = (global_micro,) + tuple(x.shape[1:])
        with profiling.span("train.draws"):
            parts = [draws.loss(i, k, global_micro, shape) for i in range(k)]
            u, t, eps = parts[0] if k == 1 else (torch.cat(d) for d in zip(*parts))
            if pl.data_count > 1:
                rows = slice(pl.data_index * b, (pl.data_index + 1) * b)
                u, t, eps = u[rows], t[rows], eps[rows]
        return u, t, eps

    def _forward_backward(self, state: TrainState, x, labels, u, t, eps):
        """The microbatches' forwards and backwards: ``(mean loss, gradients divided by k)``."""
        pl, k = state.placement, self.k
        model_params = list(state.model.parameters())
        for p in model_params:
            p.grad = None
        total = None
        mb = x.shape[0] // k
        for i in range(k):
            sl = slice(i * mb, (i + 1) * mb)
            with profiling.span("train.forward_backward"), pl.sync_context(last=i == k - 1):
                loss_i = self.loss_fn(x[sl], labels[sl], u[sl], t[sl], eps[sl])
                loss_i.backward()  # sums into .grad across microbatches
            total = loss_i.detach() if total is None else total + loss_i.detach()
        grads = [
            pl.local(p.grad) if p.grad is not None else torch.zeros_like(q)
            for p, q in zip(model_params, state.params())
        ]
        if k > 1:
            total = total / k
            torch._foreach_div_(grads, float(k))
        return pl.mean_over_data(total), grads

    def _finish(self, state: TrainState) -> None:
        """The EMA, the gradients let go, the counters: after the update on either route."""
        profiling.count("train.microbatches", self.k)
        with profiling.span("train.ema"):
            ema_update(state.ema_params(), state.params(), state.ema_counter, self.ema_cfg)
        for p in state.model.parameters():
            p.grad = None
        state.step += 1
        state.ema_counter += 1

    # ------------------------------------------------------------------ eager
    def eager(self, state: TrainState, x: torch.Tensor, labels: torch.Tensor, draws) -> torch.Tensor:
        """The step op by op, as every route outside the graph's takes it."""
        profiling.count("train.eager")
        total, grads = self._forward_backward(state, x, labels, *self._draws(state, x, draws))
        if self.debug_nans:
            check_finite("the loss and gradients", [total, *grads])
        with profiling.span("train.optimizer"):
            self.tx.update(grads, state.opt_state, state.params(), global_norm=state.placement.grad_norm)
        self._finish(state)
        return total

    # ------------------------------------------------------------------ graph
    def _entry(self, state: TrainState, x: torch.Tensor, labels: torch.Tensor) -> Optional[_Captured]:
        """The shape's graph record (a new one while fewer than :data:`MAX_GRAPHS` are held), or None."""
        opt = state.opt_state
        owner = (opt, opt.mu, opt.nu, *state.model.parameters())
        if self._owner is None or len(owner) != len(self._owner) or not all(map(operator.is_, owner, self._owner)):
            self.graphs.clear()  # captured on other tensors: never replay them
            self._owner = owner
        key = (x.shape, x.dtype, x.device, labels.shape, labels.dtype)
        entry = self.graphs.get(key)
        if entry is None and len(self.graphs) < MAX_GRAPHS:
            entry = self.graphs[key] = _Captured()
        return entry

    def _capture(self, entry: _Captured, state: TrainState, inputs) -> None:
        """Capture the step on new static copies of ``inputs`` (the graph is recorded, not run)."""
        entry.inputs = [torch.empty_like(v) for v in inputs]
        entry.hyper = torch.empty(3, dtype=torch.float32, device=inputs[0].device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            loss = self._update(state, entry.inputs, entry.hyper)
        for p in state.model.parameters():
            p.grad = None
        entry.graph, entry.loss = graph, loss
        profiling.count("train.graph.captures")

    def _update(self, state: TrainState, inputs, hyper: torch.Tensor) -> torch.Tensor:
        """What the graph holds: the forwards and backwards on ``inputs``, then the clip and Adam at ``hyper``; returns the loss.

        ``hyper`` is ``[lr, 1 − β₁ᵗ, 1 − β₂ᵗ]`` on the device, the two corrections'
        reciprocals on a CUDA device (``Optimizer.hyper``), filled before each replay.
        """
        total, grads = self._forward_backward(state, *inputs)
        with profiling.span("train.optimizer"):
            self.tx.apply(grads, state.opt_state, state.params(), *hyper.unbind(),
                          global_norm=state.placement.grad_norm)
        return total

    def _replay(self, entry: _Captured, state: TrainState, x, labels, draws) -> torch.Tensor:
        opt = state.opt_state
        hyper = torch.tensor(self.tx.hyper(opt.count, reciprocal=x.is_cuda), dtype=torch.float32)
        inputs = (x, labels, *self._draws(state, x, draws))
        if entry.graph is None:
            self._capture(entry, state, inputs)
        entry.hyper.copy_(hyper.pin_memory() if x.is_cuda else hyper, non_blocking=True)
        for dst, src in zip(entry.inputs, inputs):
            dst.copy_(src)
        with profiling.span("train.graph"):
            entry.graph.replay()
        profiling.count("train.graph.replays")
        opt.count += 1
        loss = entry.loss.clone()  # the graph's loss is overwritten at the next replay
        self._finish(state)
        return loss


make_train_step = TrainStep  # the name the engines and tests build the step by
