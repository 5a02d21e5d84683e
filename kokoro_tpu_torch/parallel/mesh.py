"""The device mesh over processes: process start-up, the process groups of
each axis, and the batch's placement.

Port of ``kokoro_tpu/parallel/mesh.py``.  The semantics are the reference's
(``kokoro_tpu/parallel/__init__.py``): the global batch is the sum of the
per-rank batches, the loss is a masked mean over the GLOBAL batch, and EMA,
schedules and counters advance per optimizer step on global quantities.  The
mechanism differs: one process per device, each holding its rows of the
batch (``data``) and its slice of the attention heads and FFN width
(``model``, ``parallel/tp.py``), with explicit collectives in place of the
ones XLA's partitioner inserts.

* Layout: ranks fill the mesh in row-major order of ``mesh_shape``, the last
  axis fastest; on a ``('data', 'model')`` mesh rank = d * tp + m, as
  ``np.asarray(devices).reshape(shape)`` lays out the reference's mesh.
  Every axis has its process groups (the ranks that differ only in that
  axis).
* Collectives: ``all_reduce`` and ``broadcast`` only.  PyTorch's gloo
  backend implements no other collective on CUDA tensors, so the same code
  runs on NCCL across cards and on gloo with several ranks on one card.
  :class:`Mesh` counts the calls and bytes of each.
* Batch placement: each rank materialises only its contiguous row block of
  the global batch (:func:`process_local_rows`); the ranks of one ``model``
  group hold the same block.  :func:`batch_axis_index` finds the batch axis
  of a key under a leading microbatch axis.

Without a process group a mesh of one device has no groups, and every
collective is skipped: the single-process path is the plain one.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_AXIS_NAMES = ("data", "model")
SEQ_AXIS = "seq"
# a collective that waits longer than this raises on every rank
COLLECTIVE_TIMEOUT_S = 600

# trailing per-sample feature dims of each batch key: the batch axis of an
# array is ``ndim - 1 - trailing`` (a leading axis is the microbatch axis)
_TRAILING_DIMS: Dict[str, int] = {
    "mel_specs": 2,          # (..., B, T, n_mels)
    "phoneme_indices": 1,    # (..., B, L)
    "stress_indices": 1,
    "phoneme_durations": 1,
    "pitch_targets": 1,      # (..., B, T)
    "energy_targets": 1,
    "stop_token_targets": 1,
    "mel_lengths": 0,        # (..., B)
    "phoneme_lengths": 0,
}


def init_distributed(device: str | torch.device | None = None, backend: Optional[str] = None,
                     init_method: str = "env://", rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = COLLECTIVE_TIMEOUT_S) -> torch.device:
    """Start this process's process group and return its device.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``.  The device is the one named, ``cuda:LOCAL_RANK`` for
    ``"cuda"`` or ``None``; a card that does not exist raises (no wrap-around
    to another).  The backend is NCCL for a CUDA device and gloo for the CPU
    unless ``backend`` names one (gloo puts several ranks on one card).  A
    failed initialisation raises."""
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs {dev}, but this process sees "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


class Mesh:
    """A named mesh of ``world_size`` ranks and this rank's place in it.

    ``groups[axis]`` is the process group of this rank along ``axis`` (None
    without a process group).  ``stats`` counts this mesh's collectives:
    calls and bytes of ``all_reduce`` and ``broadcast``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None, world=None):
        self.shape: Dict[str, int] = dict(zip(axis_names, (int(s) for s in shape)))
        self.rank = int(rank)
        self.world_size = math.prod(self.shape.values())
        coords = np.unravel_index(self.rank, tuple(self.shape.values()))
        self.coords: Dict[str, int] = {a: int(c) for a, c in zip(self.shape, coords)}
        self.groups = groups or {}
        self.world = world
        self.stats = {"all_reduce": 0, "broadcast": 0, "bytes": 0}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    @property
    def dp(self) -> int:
        return self.size("data")

    @property
    def tp(self) -> int:
        return self.size("model")

    def _group(self, axes: str | Tuple[str, ...]):
        axes = (axes,) if isinstance(axes, str) else tuple(a for a in axes if a in self.shape)
        if len(axes) == 1:
            return self.groups.get(axes[0])
        return self.world if set(axes) == set(self.shape) else None

    def all_reduce(self, tensor: torch.Tensor, axes: str | Tuple[str, ...],
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In place over the ranks that differ only in ``axes`` (one axis, or
        every axis of the mesh); no-op without a group."""
        group = self._group(axes)
        if group is not None:
            self.stats["all_reduce"] += 1
            self.stats["bytes"] += tensor.numel() * tensor.element_size()
            dist.all_reduce(tensor, op=op, group=group)
        return tensor

    def broadcast(self, tensor: torch.Tensor) -> torch.Tensor:
        """In place from global rank 0 to every rank; no-op without a group."""
        if self.world is not None:
            self.stats["broadcast"] += 1
            self.stats["bytes"] += tensor.numel() * tensor.element_size()
            dist.broadcast(tensor, src=0, group=self.world)
        return tensor

    def barrier(self) -> None:
        """Wait for every rank (no-op without a group): before a rank exits,
        so that no rank leaves while another still writes or reduces."""
        if self.world is not None:
            dist.barrier(group=self.world)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def mesh_axes(config) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, names) of ``config``'s mesh: ``mesh_shape`` or one axis over
    every process; names beyond those given default to ('data', 'model')."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = tuple(config.mesh_shape) if config.mesh_shape is not None else (world,)
    names = tuple(config.mesh_axis_names)
    if len(names) < len(shape):
        names = names + DEFAULT_AXIS_NAMES[len(names): len(shape)]
    return shape, names[: len(shape)]


def create_mesh(config) -> Mesh:
    """The mesh of ``config`` over the process group (reference
    ``create_mesh``): its size must be the world size.  Creates the process
    groups of every axis, a collective call every rank makes.  Without a
    process group the mesh must hold one device and has no groups."""
    shape, names = mesh_axes(config)
    size = math.prod(shape)
    if not dist.is_initialized():
        if size != 1:
            raise ValueError(f"a mesh of {size} devices needs {size} processes: start them "
                             "with python -m torch.distributed.run --nproc-per-node "
                             f"{size} ... --distributed")
        return Mesh(shape, names)
    world, rank = dist.get_world_size(), dist.get_rank()
    if size != world:
        raise ValueError(f"mesh_shape {shape} holds {size} devices, the process group "
                         f"{world} ranks")
    grid = np.arange(world).reshape(shape)
    groups = {}
    for i, axis in enumerate(names):
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:  # every rank creates every group, in one order
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return Mesh(shape, names, rank, groups, dist.group.WORLD)


def mesh_size(mesh: Mesh) -> int:
    return mesh.world_size


def seq_size(mesh: Optional[Mesh]) -> int:
    """Size of the ``seq`` axis; 1 when absent."""
    return 1 if mesh is None else mesh.size(SEQ_AXIS)


def dp_size(mesh: Optional[Mesh]) -> int:
    """Size of the ``data`` axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.dp


def tp_size(mesh: Optional[Mesh]) -> int:
    """Size of the ``model`` axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.tp


def batch_axis_index(key: str, ndim: int) -> int:
    """Index of the batch axis of a batch entry of the given rank."""
    trailing = _TRAILING_DIMS.get(key, ndim - 1)
    return max(ndim - 1 - trailing, 0)


def process_local_rows(global_rows: int, count: int, index: int) -> slice:
    """Rank block ``index`` of ``count`` contiguous blocks of the global
    batch dimension."""
    if global_rows % count:
        raise ValueError(f"global batch rows ({global_rows}) not divisible by process "
                         f"count ({count})")
    local = global_rows // count
    return slice(index * local, (index + 1) * local)


def round_up_to_multiple(n: int, multiple: int) -> int:
    return -(-n // max(multiple, 1)) * max(multiple, 1)


def shard_batch(batch: Dict[str, object], mesh: Mesh) -> Dict[str, object]:
    """This rank's rows of a global batch (numpy arrays or tensors): the data
    rank's contiguous block on each key's batch axis."""
    out = {}
    for key, value in batch.items():
        axis = batch_axis_index(key, value.ndim)
        rows = process_local_rows(value.shape[axis], mesh.dp, mesh.index("data"))
        index = (slice(None),) * axis + (rows,)
        out[key] = value[index]
    return out


def reduce_max(values: Iterable[torch.Tensor], mesh: Optional[Mesh], axis: str = "data"
               ) -> list:
    """The maxima of scalar tensors over ``axis`` in one collective."""
    values = list(values)
    if mesh is None:
        return values
    stacked = mesh.all_reduce(torch.stack(values), axis, op=dist.ReduceOp.MAX)
    return list(stacked.unbind())
