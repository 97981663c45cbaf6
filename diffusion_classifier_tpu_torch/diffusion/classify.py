"""Per-class ELBO classification — port of ``diffusion/classify.py``.

Same protocol as the JAX module, and on the CPU the same megabatch schedule:

- One shared ``(t, ε)`` per (evaluation, batch element): every candidate
  class sees identical noise, so their errors are comparable.
- The candidates of a group of ``G`` evaluations are scored in one denoiser
  forward on a ``[G·B·K]`` megabatch, or ``class_chunk`` classes at a time;
  errors land in a dense ``[G, B, C]`` table, so a class duplicated across
  chunks (fast mode) counts once per evaluation.
- A class that missed any evaluation so far has mean +inf, via the
  ``(err_sum, count)`` pair; each stage keeps the ``n_keep`` lowest means,
  ties going to the lower class id as with ``lax.top_k`` (a stable sort).
- Fast mode scores the true class plus ``n_fast_classes − 1`` incorrect
  classes drawn uniformly with replacement; candidate 0 is the true class.
- With ``encode_fn``/``tail_fn`` (the UNet's prefix split) the
  condition-free prefix runs once per evaluation group on ``[G·B]``; its
  state is repeated per class (``repeat_interleave`` on dim 0, matching the
  labels' ``(G, B, cc)`` order) and only the conditioned tail runs on the
  ``[G·B·cc]`` megabatch.

The group size ``G`` of an automatic schedule comes, on a CUDA device, from
the card's free memory (:func:`card_eval_group`); on the CPU, or with an
explicit ``megabatch_target``, it is the JAX package's
(:func:`auto_eval_group`).

Under several data ranks (``data_rows=(index, count)``) ``x`` holds this
rank's contiguous rows of the global batch. The draws are the global
batch's, as in the JAX program over a sharded batch: each rank draws the
global shapes and keeps its rows, so the same seed and the same ``G``
predict the same classes at any world size.

The JAX scans become Python loops, so ``scan_unroll`` (an XLA schedule knob)
is accepted and ignored. The random draws come from a :class:`Draws`
provider — :class:`TorchDraws` over a ``torch.Generator`` on the device, or,
in the tests, one that replays the JAX key tree — requested in the JAX
order: the fast-mode selection first, then per stage and per evaluation
group ``t [G, B]`` and ``ε [G, *x.shape]``.

Spans (``utils/profiling.py``): ``tournament.stage`` around each stage,
holding ``tournament.auto_group`` (the group size, with the card's free
memory), one ``tournament.group`` a group of evaluations (draws, noising,
the denoiser's forwards, the errors and the dense table) and
``tournament.select`` (the means, the sort, the kept classes); counters
``tournament.stages``, ``tournament.groups``, ``tournament.rows`` (the
(image, class, evaluation) rows sent to the denoiser) and
``tournament.pruned`` (the candidates a stage drops, over the images).

A backbone may give the bytes its classify row takes on the card
(``row_bytes``, e.g. :meth:`..models.dit.DiT.classify_row_bytes`): where
that exceeds ``ROW_BYTES_PER_ELEM`` a row, the card's group size counts it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Protocol, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from ..utils import profiling
from .process import bcast_right, pred_to_eps
from .schedule import alpha_sigma

__all__ = ["Draws", "TorchDraws", "auto_eval_group", "card_eval_group", "make_classifier"]


#: elements of one CIFAR image — the unit ``megabatch_target`` is calibrated in
_REF_IMG_ELEMS = 32 * 32 * 3
#: bytes of card memory a megabatch row (one image × candidate class ×
#: evaluation) takes in classify, per element of the image. Measured on an
#: H100 by ``chip_smoke.py`` (``row_bytes``, which fails if a denoiser needs
#: more): 355 for the CheXpert UNet, the largest of the repository's
#: denoisers (126 the IPMSA UNet, 94 the CIFAR UNet, 35 the DiT-b4);
#: rounded up to 512
ROW_BYTES_PER_ELEM = 512
#: the share of the card's free memory (``torch.cuda.mem_get_info``) that the
#: auto group size lets a classify megabatch fill
FREE_MEMORY_SHARE = 0.5


def _largest_group(n_evals: int, rows_per_eval: int, budget_rows: int) -> int:
    """Largest divisor G of ``n_evals`` with ``rows_per_eval · G ≤ budget_rows`` (at least 1)."""
    best = 1
    for g in range(1, n_evals + 1):
        if n_evals % g == 0 and rows_per_eval * g <= budget_rows:
            best = g
    return best


def auto_eval_group(
    n_evals: int,
    batch: int,
    k_classes: int,
    target: int = 512,
    img_elems: int = _REF_IMG_ELEMS,
) -> int:
    """The JAX package's group size: the largest divisor G of ``n_evals`` with ``B·K·G ≤ budget``.

    ``target`` is in CIFAR-equivalent images (32·32·3 elements), scaled
    down by the image's element count. The classifier takes it on the CPU
    and whenever ``megabatch_target`` is given, so those schedules, and the
    draws laid out by them, are the JAX package's.
    """
    budget = max(1, (target * _REF_IMG_ELEMS) // max(img_elems, 1))
    return _largest_group(n_evals, batch * k_classes, budget)


def card_eval_group(n_evals: int, batch: int, k_classes: int, img_elems: int, free_bytes: int,
                    row_bytes: int = 0) -> int:
    """The group size on the card: the largest divisor G of ``n_evals`` whose megabatch fits.

    A megabatch of ``B·K·G`` rows takes ``ROW_BYTES_PER_ELEM · img_elems``
    bytes a row, or ``row_bytes`` where the backbone counts more; it must
    fit in ``FREE_MEMORY_SHARE · free_bytes``.
    """
    row_bytes = max(ROW_BYTES_PER_ELEM * max(img_elems, 1), row_bytes)
    return _largest_group(n_evals, batch * k_classes, int(FREE_MEMORY_SHARE * free_bytes) // row_bytes)


class Draws(Protocol):
    """Source of the classifier's random draws."""

    def fast_select(self, shape: tuple, high: int) -> torch.Tensor:
        """Integers uniform in ``[0, high)`` (fast-mode incorrect classes)."""

    def noise(
        self,
        stage: int,
        n_stages: int,
        group_idx: int,
        n_groups: int,
        t_shape: tuple,
        eps_shape: tuple,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(t ~ U[0,1) of t_shape, ε ~ N(0,1) of eps_shape)`` for one evaluation group."""


class TorchDraws:
    """Draws from one ``torch.Generator``, in call order, on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def fast_select(self, shape, high):
        return torch.randint(
            0, high, shape, generator=self.generator, device=self.generator.device
        )

    def noise(self, stage, n_stages, group_idx, n_groups, t_shape, eps_shape):
        g, dev = self.generator, self.generator.device
        t = torch.rand(t_shape, generator=g, device=dev)
        return t, torch.randn(eps_shape, generator=g, device=dev)


def make_classifier(
    apply_fn: Callable,
    schedule_fn: Callable,
    *,
    pred_param: str,
    num_classes: int,
    n_stages: int,
    evaluation_per_stage: Sequence[int],
    n_keep_per_stage: Sequence[int],
    fast: bool = False,
    n_fast_classes: int = 2,
    eval_group: int = 0,
    class_chunk: int = 0,
    scan_unroll=1,
    megabatch_target: Optional[int] = None,
    encode_fn: Callable = None,
    tail_fn: Callable = None,
    trace: bool = False,
    data_rows: tuple = (0, 1),
    row_bytes: Optional[Callable] = None,
):
    """Build ``classify(x, labels, draws) -> predicted class ids [B]``.

    ``apply_fn(z, logsnr, labels)`` is the denoiser forward; with
    ``encode_fn(z, logsnr) -> state`` and ``tail_fn(state, labels) -> pred``
    the prefix is shared across the classes. ``labels`` is read only in
    fast mode. ``class_chunk`` changes the schedule, never the
    predictions (0 = all classes at once, -1 = 1 at batch ≥ 16). With
    ``trace=True`` it also returns, per stage, ``{"mean", "cand"}``.
    ``scan_unroll`` is ignored (see the module docstring). ``data_rows``
    is ``(index, count)`` on the data axis. ``row_bytes(image_shape)``,
    where given, is the backbone's own count of a row's card bytes.

    ``eval_group=0`` picks the group size ``G`` per stage: on a CUDA device
    from the card's free memory (:func:`card_eval_group`; several processes
    take their smallest), on the CPU or with ``megabatch_target`` as the
    JAX package does (:func:`auto_eval_group`). ``G`` is a schedule, but
    the draws are requested per group, so on the card the same seed gives
    the same predictions only where the same ``G`` results: give
    ``eval_group`` for a schedule that never depends on free memory.
    """
    del scan_unroll
    data_index, data_count = data_rows
    prefix = encode_fn is not None and tail_fn is not None
    ev = (0,) + tuple(evaluation_per_stage)
    keep = tuple(n_keep_per_stage)
    if len(ev) - 1 != n_stages or len(keep) != n_stages:
        raise ValueError("evaluation_per_stage and n_keep_per_stage need n_stages entries")
    if keep[-1] != 1:
        raise ValueError(
            "Only one class should be selected at the end of the classification process."
        )
    if fast and not 2 <= n_fast_classes <= num_classes:
        raise ValueError("n_fast_classes must be in [2, num_classes]")
    if eval_group:
        for i in range(n_stages):
            if (ev[i + 1] - ev[i]) % eval_group:
                raise ValueError(
                    f"eval_group={eval_group} does not divide stage {i}'s "
                    f"evaluation count {ev[i + 1] - ev[i]}; use 0 for auto grouping"
                )

    def _score_stage(x, cand, err_sum, count, draws, stage, n_evals, group, identity, rows):
        b, k = x.shape[0], cand.shape[1]
        gb = b * data_count
        n_groups = n_evals // group
        chunk = class_chunk if class_chunk >= 0 else (1 if b >= 16 else 0)
        cc = chunk if chunk and k % chunk == 0 else k
        n_cc = k // cc
        img_dims = tuple(range(1, x.ndim))
        g_idx = torch.arange(group, device=x.device)[:, None, None]
        b_idx = torch.arange(b, device=x.device)[None, :, None]

        for gi in range(n_groups):
            profiling.count("tournament.groups")
            with profiling.span("tournament.group"):
                t, eps = draws.noise(
                    stage, n_stages, gi, n_groups, (group, gb), (group, gb) + tuple(x.shape[1:])
                )
                if rows is not None:
                    t, eps = t[:, rows], eps[:, rows]
                t = t.to(x.device, torch.float32)
                eps = eps.to(x.device, x.dtype)
                logsnr_t = schedule_fn(t)  # [G, B]
                alpha_t, sigma_t = alpha_sigma(logsnr_t)
                a = bcast_right(alpha_t, eps.ndim).to(x.dtype)
                s = bcast_right(sigma_t, eps.ndim).to(x.dtype)
                z = a * x[None] + s * eps  # [G, B, ...]
                state = None
                if prefix:  # the condition-free prefix, once per (eval, image)
                    z_flat = z.reshape((group * b,) + tuple(x.shape[1:]))
                    state = encode_fn(z_flat, logsnr_t.reshape(group * b))

                def score_classes(cand_c):
                    """Errors ``[G, B, cc]`` for candidates ``cand_c [B, cc]``."""
                    ncc = cand_c.shape[1]
                    profiling.count("tournament.rows", group * b * ncc)
                    rows = (group * b * ncc,) + tuple(x.shape[1:])
                    lg = logsnr_t[:, :, None].expand(group, b, ncc).reshape(-1)
                    lab = cand_c[None].expand(group, b, ncc).reshape(-1)
                    zz = z[:, :, None].expand((group, b, ncc) + x.shape[1:]).reshape(rows)
                    if state is None:
                        pred = apply_fn(zz, lg, lab)
                    elif ncc == 1:  # one class a row: the state as it is, no copy
                        pred = tail_fn(state, lab)
                    else:
                        # row (g·B + b)·cc + c pairs image (g, b) with class c
                        rep = tree_map(lambda t: t.repeat_interleave(ncc, dim=0), state)
                        pred = tail_fn(rep, lab)
                    al, si = alpha_sigma(lg)
                    eps_pred = pred_to_eps(pred, zz, al, si, pred_param)
                    eps_rep = eps[:, :, None].expand((group, b, ncc) + x.shape[1:])
                    diff = (eps_pred - eps_rep.reshape(rows)).to(torch.float32)
                    return torch.sum(diff * diff, dim=img_dims).reshape(group, b, ncc)

                if identity and n_cc == 1:
                    # every row's candidates are arange(C): slots already aligned
                    err_sum = err_sum + score_classes(cand).sum(dim=0)
                    count = count + group
                    continue

                dense = torch.full(
                    (group, b, num_classes), math.inf, dtype=torch.float32, device=x.device
                )
                for j in range(n_cc):
                    cand_c = cand[:, j * cc : (j + 1) * cc]
                    # duplicates write the same value (shared (t, ε) ⇒ same error)
                    dense[g_idx, b_idx, cand_c[None]] = score_classes(cand_c)
                scored = torch.isfinite(dense)
                err_sum = err_sum + torch.where(scored, dense, 0.0).sum(dim=0)
                count = count + scored.sum(dim=0, dtype=torch.int32)
        return err_sum, count

    def _auto_group(n_evals, b, gb, k, x):
        img_elems = math.prod(x.shape[1:])
        if megabatch_target is not None or x.device.type != "cuda":
            return auto_eval_group(n_evals, gb, k, megabatch_target or 512, img_elems)
        free, _ = torch.cuda.mem_get_info(x.device)
        own = row_bytes(tuple(x.shape[1:])) if row_bytes is not None else 0
        group = card_eval_group(n_evals, b, k, img_elems, free, own)
        if dist.is_initialized() and dist.get_world_size() > 1:
            # every rank must draw the same global shapes: the smallest G
            on = x.device if dist.get_backend() == "nccl" else "cpu"
            g = torch.tensor([group], device=on)
            dist.all_reduce(g, op=dist.ReduceOp.MIN)
            group = int(g.item())
        return group

    @torch.no_grad()
    def classify(x: torch.Tensor, labels: torch.Tensor, draws: Draws):
        b, dev = x.shape[0], x.device
        gb = b * data_count
        rows = slice(data_index * b, (data_index + 1) * b) if data_count > 1 else None
        if fast:
            labels = labels.to(dev, torch.long)
            # incorrect classes of row b in ascending order: i + (i >= label)
            i = torch.arange(num_classes - 1, device=dev)[None, :]
            incorrect = i + (i >= labels[:, None]).long()
            sel = draws.fast_select((gb, n_fast_classes - 1), num_classes - 1)
            sel = (sel if rows is None else sel[rows]).to(dev, torch.long)
            cand = torch.cat(
                [labels[:, None], torch.gather(incorrect, 1, sel)], dim=1
            )
        else:
            cand = torch.arange(num_classes, device=dev)[None].expand(b, num_classes)

        err_sum = torch.zeros((b, num_classes), dtype=torch.float32, device=dev)
        count = torch.zeros((b, num_classes), dtype=torch.int32, device=dev)
        stages = []
        for i in range(n_stages):
            profiling.count("tournament.stages")
            with profiling.span("tournament.stage"):
                n_evals = ev[i + 1] - ev[i]
                group = eval_group
                if not group:
                    with profiling.span("tournament.auto_group"):
                        group = _auto_group(n_evals, b, gb, cand.shape[1], x)
                identity = (not fast) and i == 0 and cand.shape[1] == num_classes
                err_sum, count = _score_stage(
                    x, cand, err_sum, count, draws, i, n_evals, group, identity, rows
                )
                with profiling.span("tournament.select"):
                    mean = torch.where(count == ev[i + 1], err_sum / ev[i + 1], math.inf)
                    # lax.top_k(-mean) order: lowest mean first, ties to the lower id
                    profiling.count("tournament.pruned", b * (cand.shape[1] - keep[i]))
                    cand = torch.sort(mean, dim=1, stable=True).indices[:, : keep[i]]
            if trace:
                stages.append({"mean": mean, "cand": cand})
        if trace:
            return cand[:, 0], tuple(stages)
        return cand[:, 0]

    return classify
