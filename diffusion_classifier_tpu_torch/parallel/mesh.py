"""Process groups and the ``('data', 'model')`` device mesh — port of ``parallel/mesh.py``.

One process drives one device. :func:`init_distributed` starts the
process group from what the launcher proves: torchrun's ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` (with ``MASTER_ADDR`` and ``MASTER_PORT``),
or, as the JAX module, a SLURM step (``SLURM_PROCID`` with ``SLURM_NTASKS``
> 1; ``SLURM_NTASKS`` alone is not proof: a bare ``python`` inside
``salloc -n 4`` inherits it) or an Open MPI launch
(``OMPI_COMM_WORLD_SIZE`` > 1). SLURM and Open MPI launches need
``MASTER_ADDR`` and ``MASTER_PORT`` in the environment. Without any of
these it does nothing: one process, no group.

:func:`make_mesh` lays the ranks out as ``[data, model]``, row-major, so
the ranks of one model group are neighbours. A rank's rows of a global
batch are its data index's contiguous slice (:func:`data_position`, which
the loaders read): the ranks of one model group hold the same rows.

The preemption agreement (:class:`PreemptionSync`) replaces the JAX
runtime's preemption sync manager: every rank must save at the same step,
since a rank one step ahead of its peer waits forever in the peer's
pending collective.
"""

from __future__ import annotations

import os
import signal
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "PreemptionSync",
    "data_position",
    "host_local_batch_size",
    "init_distributed",
    "is_main_process",
    "make_mesh",
]

# (data index, data count) of the last mesh made in this process
_DATA_POSITION: Optional[tuple[int, int]] = None


def _launch_env() -> Optional[tuple[int, int, int]]:
    """``(rank, world, local_rank)`` when the environment proves a multi-process launch."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:  # torchrun, any world size
        return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0))
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS") or 1) > 1:
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", 0)))
    if int(env.get("OMPI_COMM_WORLD_SIZE") or 1) > 1:
        return (int(env["OMPI_COMM_WORLD_RANK"]), int(env["OMPI_COMM_WORLD_SIZE"]),
                int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", 0)))
    return None


def init_distributed(device: Optional[str] = "cuda", backend: Optional[str] = None) -> torch.device:
    """Start the process group if the launcher asks for one; returns this rank's device.

    ``device`` ``"cuda"`` (no index) means ``cuda:LOCAL_RANK`` under a
    launch; an indexed device stays as given (two ranks sharing one card).
    The backend is NCCL for a CUDA device and gloo for the CPU unless
    ``backend`` names one. One process: returns ``device`` and starts
    nothing.
    """
    dev = torch.device(device or "cuda")
    launch = _launch_env()
    if launch is None or dist.is_initialized():
        return dev
    rank, world, local_rank = launch
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    for var in ("MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"a {world}-process launch needs {var} in the environment")
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method="env://", rank=rank, world_size=world,
    )
    return dev


def make_mesh(data: Optional[int] = None, model: int = 1, *, device_type: str = "cuda"):
    """A ``('data', 'model')`` ``DeviceMesh`` over the initialised group; None without one.

    ``data`` defaults to the world size over ``model``.
    """
    global _DATA_POSITION
    if not dist.is_initialized():
        if (data or 1) * model != 1:
            raise ValueError(f"a {data}x{model} mesh needs an initialised process group")
        return None
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if data is None:
        if world % model:
            raise ValueError(f"model axis {model} does not divide {world} ranks")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    mesh = init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
    _DATA_POSITION = (mesh["data"].get_local_rank(), data)
    return mesh


def data_position() -> tuple[int, int]:
    """``(index, count)`` of this rank on the data axis: the last mesh's, else the group's, else (0, 1)."""
    if _DATA_POSITION is not None and dist.is_initialized():
        return _DATA_POSITION
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_local_batch_size(global_batch: int) -> int:
    """This rank's rows of a global batch (an even split over the data axis)."""
    _, count = data_position()
    if global_batch % count:
        raise ValueError(f"global batch {global_batch} not divisible by {count} data ranks")
    return global_batch // count


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class PreemptionSync:
    """One step that every rank agrees to save at, after SIGTERM (or SIGINT) reaches any of them.

    The handler only sets a local flag. :meth:`should_save` is called once a
    step by every rank: it starts an all-reduce (MAX) of the flag without
    waiting, and reads the one it started the step before, so the host
    never waits on this step's work. All ranks read the same reduced value
    at the same step, and so save at the same step. The flag travels over a
    gloo group on host memory (the default group when it is gloo), so
    reading it never synchronises the card.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signum = 0  # this rank's signal; after the agreement, the reduced one
        self._pending = None
        self._group = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
        self._previous = {sig: signal.signal(sig, self._handle) for sig in signals}

    def _handle(self, signum, frame) -> None:
        self.signum = signum

    def should_save(self) -> bool:
        """True at the agreed step: every rank returns True at the same call."""
        agreed = 0
        if self._pending is not None:
            work, value = self._pending
            work.wait()
            agreed = int(value.item())
        value = torch.tensor([self.signum], dtype=torch.int32)
        self._pending = (dist.all_reduce(value, op=dist.ReduceOp.MAX, group=self._group,
                                         async_op=True), value)
        if agreed:
            self.signum = agreed
        return bool(agreed)

    def close(self) -> None:
        """Restore the previous handlers and finish the pending all-reduce."""
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)
        if self._pending is not None:
            self._pending[0].wait()
            self._pending = None
