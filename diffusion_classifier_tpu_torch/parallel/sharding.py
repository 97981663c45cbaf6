"""Parameter placement over the ``('data', 'model')`` mesh — port of ``parallel/sharding.py``.

``shard_params(module, mesh, mode)`` places a model and returns its
:class:`Placement`:

- ``'replicated'``, and ``'tp'`` on a model axis of 1: data parallel. The
  training model runs under ``DistributedDataParallel`` over the data
  group; the EMA copy is a plain replica.
- ``'tp'`` on a model axis > 1: Megatron placement by the JAX module's name
  rules (:func:`param_spec`): the Q/K/V projections, the GEGLU input and
  the time embedding's ``linear_1`` column-parallel (a row slice of the
  ``[out, in]`` weight and of the bias), the attention and GEGLU outputs
  and ``linear_2`` row-parallel (a column slice, the partial products summed
  over the model group, the bias added once). The slicing is by hand on the
  port's :class:`~..models.layers.Dense`, which torch's parallel styles do
  not take: each layer carries a :class:`TPSpec` and calls the collectives
  of :mod:`.collectives`. The GEGLU input is sliced half by half, so each
  rank holds matching value and gate columns; ``encoder_hid_proj`` (column
  in JAX, read whole by the cross-attention) gathers its output. The data
  axis is then DDP, or FSDP under ``'fsdp'``.
- ``'fsdp'``: ZeRO-3 through FSDP2 (``fully_shard`` on the data axis), the
  model and its EMA alike. FSDP2 shards every parameter it manages, so a
  small one cannot stay replicated as in JAX (``FSDP_MIN_PARAM``); instead
  the grouping keeps small parameters together. Each block (a resnet block,
  a transformer, an attention block, a resampler, a DiT block, a ResNet
  block) that holds at least ``FSDP_MIN_PARAM`` elements is one group and
  is gathered just before its forward; everything else (embeddings,
  biases, norms, the stem and the output layers, small blocks) is the
  root group, gathered in one collective. Blocks read their parameters
  only inside their own forward, which is what FSDP's hooks need.

Adam's moments and the EMA live on the parameters' placement: each rank
keeps the moments and the EMA of its own shard (:meth:`Placement.local`).
The global-norm clip sums the squared shards over the ranks that hold
distinct pieces (:meth:`Placement.grad_norm`). Checkpoints hold whole
tensors: :meth:`Placement.full` gathers a parameter or a moment, and
:meth:`Placement.load` re-places a whole-state checkpoint onto the live
placement (JAX's ``restore_placement`` and ``reshard_restored``), so a
checkpoint written under one world size and mode loads under any other.

Without a mesh (one process, no group) every mode places nothing: the
module runs as it is, as the JAX package replicates on a one-device mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models.dit import DiTBlock
from ..models.layers import (
    AttentionBlock2D,
    Dense,
    Downsample2D,
    GEGLUFeedForward,
    MultiHeadAttention,
    ResnetBlock2D,
    SpatialTransformer,
    TimestepEmbedding,
    Upsample2D,
)
from ..models.resnet import RESNET_BLOCKS, BatchNorm

__all__ = [
    "FSDP_MIN_PARAM",
    "Placement",
    "TPSpec",
    "param_spec",
    "shard_params",
]

# a block smaller than this stays in the root group under FSDP: gathering
# many small tensors one by one costs more latency than the bytes it saves
FSDP_MIN_PARAM = 2**16

# column-parallel (shard the output features) and row-parallel (shard the
# input features): the JAX module's substrings, matched on the name of the
# module that owns a 2-D weight
_COLUMN = ("to_q", "to_k", "to_v", "proj_in", "encoder_hid_proj", "linear_1")
_ROW = ("to_out", "proj_out", "linear_2")

# the units whose forwards read their parameters only inside themselves
_FSDP_BLOCKS = (
    ResnetBlock2D, SpatialTransformer, AttentionBlock2D, Downsample2D, Upsample2D,
    DiTBlock, *RESNET_BLOCKS,
)


def param_spec(name: str, shape) -> Optional[str]:
    """``'column'``, ``'row'`` or None (replicated) for one parameter under TP.

    Only 2-D weights shard, by the owning module's name (the JAX rule on
    the flax path's last two entries); convolutions, norms, embeddings and
    the DiT's ``qkv``/``proj``/``mlp_fc*`` stay whole.
    """
    if len(shape) != 2:
        return None
    parts = name.split(".")
    owner = parts[-2] if len(parts) > 1 else ""
    if any(k in owner for k in _COLUMN):
        return "column"
    if any(k in owner for k in _ROW):
        return "row"
    return None


@dataclasses.dataclass(frozen=True)
class TPSpec:
    """A :class:`Dense` under tensor parallelism over ``group``."""

    kind: str  # 'column' | 'row'
    group: object
    gather: bool = False  # all-gather a column output for a replicated reader
    paired: bool = False  # [value; gate] rows sliced half by half (GEGLU)

    @property
    def dim(self) -> int:
        """The sliced dimension of the ``[out, in]`` weight."""
        return 0 if self.kind == "column" else 1


def _slice(full: torch.Tensor, dim: int, paired: bool, rank: int, n: int) -> torch.Tensor:
    if paired:
        return torch.cat([h.chunk(n, dim)[rank] for h in full.chunk(2, dim)], dim)
    return full.chunk(n, dim)[rank]


def _gather(local: torch.Tensor, dim: int, paired: bool, group) -> torch.Tensor:
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    if paired:
        halves = [p.chunk(2, dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim)
    return torch.cat(parts, dim)


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def _units(module: nn.Module, tp: int):
    """``(Dense, kind, gather, paired)`` for the layers TP shards, unit by unit.

    A unit shards whole or not at all: an attention whose heads the model
    axis does not divide, or a layer whose sliced width it does not divide,
    stays replicated with its partner.
    """
    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            if m.num_heads % tp:
                continue
            cols = [d for d in (getattr(m, "to_q", None), getattr(m, "to_k", None), m.to_v) if d]
            yield from ((d, "column", False, False) for d in cols)
            yield m.to_out, "row", False, False
        elif isinstance(m, GEGLUFeedForward):
            if m.proj_out.weight.shape[1] % tp:
                continue
            yield m.proj_in, "column", False, True
            yield m.proj_out, "row", False, False
        elif isinstance(m, TimestepEmbedding):
            if m.linear_1.weight.shape[0] % tp:
                continue
            yield m.linear_1, "column", False, False
            yield m.linear_2, "row", False, False
    proj = getattr(module, "encoder_hid_proj", None)
    if proj is None:  # a Denoiser: the backbone holds it
        proj = getattr(getattr(module, "backbone", None), "encoder_hid_proj", None)
    if isinstance(proj, Dense) and proj.weight.shape[0] % tp == 0:
        yield proj, "column", True, False


@torch.no_grad()
def _apply_tp(module: nn.Module, group) -> dict:
    """Slice the TP units' weights in place; returns ``{parameter name: (dim, paired)}``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    names = {id(p): name for name, p in module.named_parameters()}
    sliced = {}
    for dense, kind, gather, paired in _units(module, n):
        wname = names[id(dense.weight)]
        if param_spec(wname, dense.weight.shape) != kind:
            raise AssertionError(f"{wname}: TP unit {kind} disagrees with the name rules")
        spec = TPSpec(kind, group, gather=gather, paired=paired)
        dense.weight = nn.Parameter(
            _slice(dense.weight, spec.dim, paired, r, n).clone(),
            requires_grad=dense.weight.requires_grad,
        )
        sliced[wname] = (spec.dim, paired)
        if dense.bias is not None and kind == "column":
            bname = names[id(dense.bias)]
            dense.bias = nn.Parameter(
                _slice(dense.bias, 0, paired, r, n).clone(), requires_grad=dense.bias.requires_grad
            )
            sliced[bname] = (0, paired)
        dense.tp = spec
    return sliced


def _apply_fsdp(module: nn.Module, data_mesh) -> None:
    from torch.distributed.fsdp import fully_shard

    for m in reversed(list(module.modules())):
        if m is not module and isinstance(m, _FSDP_BLOCKS):
            if sum(p.numel() for p in m.parameters()) >= FSDP_MIN_PARAM:
                fully_shard(m, mesh=data_mesh)
    fully_shard(module, mesh=data_mesh)


class Placement:
    """Where one module's parameters live, and the collectives that follow from it.

    ``forward_module`` is what the training forward calls (the DDP wrapper,
    else the module); ``module`` is the bare module, whose state-dict names
    are the checkpoint's. ``data_group`` carries the batch; ``model_group``
    the TP slices. A placement without a mesh is one process: every method
    is then the identity, and no collective runs.
    """

    def __init__(self, module: nn.Module, mesh=None, mode: str = "replicated", *,
                 tp_slices: Optional[dict] = None, fsdp: bool = False):
        self.module, self.mesh, self.mode = module, mesh, mode
        self.tp_slices = tp_slices or {}
        self.fsdp = fsdp
        self.forward_module = module
        self._ddp = None
        self.data_group = self.model_group = None
        self.data_index, self.data_count = 0, 1
        if mesh is not None:
            self.data_group = mesh["data"].get_group()
            self.model_group = mesh["model"].get_group()
            self.data_index, self.data_count = mesh["data"].get_local_rank(), mesh["data"].size()
        self._norm_weights = None
        if self.tp_slices or fsdp:
            # each rank adds its shards' squares divided by the number of
            # ranks holding the same piece; the sum over the world is ‖g‖²
            world = dist.get_world_size()
            model_n = mesh["model"].size()
            weights = []
            for name, p in module.named_parameters():
                distinct = (self.data_count if fsdp else 1) * (model_n if name in self.tp_slices else 1)
                weights.append(distinct / world)
            self._norm_weights = weights

    def wrap_for_training(self) -> None:
        """Wrap a data-parallel module in DDP over the data group (once; FSDP and one process need none)."""
        if self.mesh is None or self.fsdp or self._ddp is not None:
            return
        from torch.nn.parallel import DistributedDataParallel

        dev = next(self.module.parameters()).device
        self._ddp = self.forward_module = DistributedDataParallel(
            self.module,
            device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=self.data_group,
            broadcast_buffers=False,
        )

    @staticmethod
    def local(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's piece of a parameter or gradient (a DTensor's local shard, else ``t``)."""
        if t is not None and isinstance(t, _dtensor_type()):
            return t.to_local()
        return t

    def sync_context(self, last: bool):
        """The context of one microbatch's backward: gradients reduce only on the ``last``."""
        if self._ddp is not None and not last:
            return self._ddp.no_sync()
        if self.fsdp:
            self.module.set_requires_gradient_sync(last)
        return contextlib.nullcontext()

    def grad_norm(self, grads) -> Optional[torch.Tensor]:
        """‖g‖ over the whole gradient from this rank's local pieces, or None when every rank holds it whole."""
        if self._norm_weights is None:
            return None
        sq = torch.stack(torch._foreach_norm(grads)).square()
        w = torch.tensor(self._norm_weights, dtype=sq.dtype, device=sq.device)
        total = (sq * w).sum()
        dist.all_reduce(total)
        return total.sqrt()

    def mean_over_data(self, value: torch.Tensor) -> torch.Tensor:
        """The data group's mean of a per-rank scalar (the global batch's loss)."""
        if self.data_count == 1:
            return value
        value = value.clone()
        dist.all_reduce(value, group=self.data_group)
        return value / self.data_count

    # ------------------------------------------------------ whole tensors
    def full(self, name: str, t: torch.Tensor, like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The whole tensor of state-dict entry ``name`` from its local piece (a collective).

        ``like`` is the parameter a local moment or EMA piece belongs to,
        whose placement it shares.
        """
        DTensor = _dtensor_type() if self.fsdp else None
        if DTensor is not None:
            if not isinstance(t, DTensor) and isinstance(like, DTensor):
                t = DTensor.from_local(t, like.device_mesh, like.placements,
                                       shape=like.shape, stride=like.stride())
            if isinstance(t, DTensor):
                t = t.full_tensor()
        if name in self.tp_slices:
            dim, paired = self.tp_slices[name]
            t = _gather(t, dim, paired, self.model_group)
        return t.detach()

    def piece(self, name: str, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor ``full`` of entry ``name``, placed as ``like`` (dtype kept)."""
        full = full.to(self.local(like).device)
        if name in self.tp_slices:
            dim, paired = self.tp_slices[name]
            full = _slice(full, dim, paired, dist.get_rank(self.model_group),
                          dist.get_world_size(self.model_group))
        if self.fsdp and isinstance(like, _dtensor_type()):
            from torch.distributed.tensor import distribute_tensor

            full = distribute_tensor(full, like.device_mesh, like.placements,
                                     src_data_rank=None).to_local()
        return full

    def full_state_dict(self) -> dict:
        """Every state-dict entry of the module, whole (a collective: every rank calls it)."""
        return {name: self.full(name, t) for name, t in self.module.state_dict().items()}

    @torch.no_grad()
    def load(self, state_dict: dict) -> None:
        """Copy a whole-state dict into the live placement (every rank holds the whole of it)."""
        live = dict(self.module.named_parameters())
        live.update(self.module.named_buffers())
        expected = set(self.module.state_dict())
        missing, unexpected = expected - set(state_dict), set(state_dict) - expected
        if missing or unexpected:
            raise KeyError(
                f"checkpoint does not match the model: missing {sorted(missing)[:4]}, "
                f"unexpected {sorted(unexpected)[:4]}"
            )
        for name in expected:
            t = live[name]
            want = tuple(self.full_shape(name, t))
            if tuple(state_dict[name].shape) != want:
                raise ValueError(f"{name}: checkpoint shape {tuple(state_dict[name].shape)} != {want}")
            self.local(t).copy_(self.piece(name, state_dict[name], t))

    def full_shape(self, name: str, t: torch.Tensor) -> torch.Size:
        shape = list(t.shape)  # a DTensor's shape is already whole
        if name in self.tp_slices:
            dim, _ = self.tp_slices[name]
            shape[dim] *= dist.get_world_size(self.model_group)
        return torch.Size(shape)


def shard_params(module: nn.Module, mesh, mode: str = "tp") -> Placement:
    """Place ``module`` (already on its device) on ``mesh`` for ``mode``; returns its :class:`Placement`.

    A data-parallel module is wrapped in DDP when an optimizer is built
    (:meth:`Placement.wrap_for_training`; the EMA copy and an
    evaluation-only model are never wrapped). ``mesh=None`` places nothing.
    BatchNorm layers take their batch statistics over the data group.
    """
    if mode not in ("tp", "fsdp", "replicated"):
        raise ValueError(f"param_sharding must be 'tp', 'fsdp' or 'replicated', got {mode!r}")
    if mesh is None:
        return Placement(module)
    data_mesh, model_n = mesh["data"], mesh["model"].size()
    tp = model_n > 1 and mode != "replicated"
    tp_slices = _apply_tp(module, mesh["model"].get_group()) if tp else {}
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.process_group = data_mesh.get_group()
    fsdp = mode == "fsdp"
    if fsdp:
        _apply_fsdp(module, data_mesh)
    return Placement(module, mesh, mode, tp_slices=tp_slices, fsdp=fsdp)
