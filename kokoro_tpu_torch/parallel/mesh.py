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
  axis fastest; on a ``('data', 'model')`` mesh rank = d * tp + m, on a
  ``('data', 'seq', 'model')`` mesh rank = (d * sp + s) * tp + m, as
  ``np.asarray(devices).reshape(shape)`` lays out the reference's mesh.
  Every axis, and every set of axes, has its process groups (the ranks that
  differ only in those axes); a ``stage`` axis also has the groups of two
  neighbouring stages of one data row (``parallel/pp.py``'s hand-offs).
* Collectives: ``all_reduce`` and ``broadcast`` only.  PyTorch's gloo
  backend implements no other collective on CUDA tensors, so the same code
  runs on NCCL across cards and on gloo with several ranks on one card.
  :class:`Mesh` counts the calls and bytes of each.
* Batch placement: each rank materialises only its contiguous row block of
  the global batch (:func:`process_local_rows`); the ranks of one ``model``
  group hold the same block.  :func:`batch_axis_index` finds the batch axis
  of a key under a leading microbatch axis.
* Sequence parallelism (the ``seq`` axis): the mel-frame axis of the
  frame-level keys (``_TIME_AXIS_OFFSET``) is split into ``sp`` contiguous
  windows, rank ``s`` holding frames ``[s T/sp, (s+1) T/sp)``; the phoneme
  arrays and the lengths stay whole (:func:`batch_pspec`, :func:`shard_batch`).
  :func:`gather_frames` puts the windows back together on every rank, and
  :func:`seq_gather` does so for activations with a gradient (the K/V of the
  decoder's self-attention, ``parallel/sp.py``).

Without a process group a mesh of one device has no groups, and every
collective is skipped: the single-process path is the plain one.
"""

from __future__ import annotations

import datetime
import itertools
import math
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_AXIS_NAMES = ("data", "model")
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"
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

# batch keys with a mel-frame axis, its offset from the batch axis: under a
# 'seq' axis these split over it (the reference's _TIME_AXIS_OFFSET; the
# phoneme arrays stay whole, the encoder over L <= 192 phonemes being cheap)
_TIME_AXIS_OFFSET: Dict[str, int] = {
    "mel_specs": 1,          # (..., B, T, n_mels): T is batch axis + 1
    "pitch_targets": 1,
    "energy_targets": 1,
    "stop_token_targets": 1,
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

    ``groups[axes]`` is the process group of this rank along ``axes`` (one
    axis name, or a tuple of several in mesh order; absent without a process
    group); ``links[s]`` the group of stages ``s`` and ``s + 1`` of this
    rank's data row.  ``stats`` counts this mesh's collectives: calls and
    bytes of ``all_reduce`` and ``broadcast``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], rank: int = 0,
                 groups: Optional[Dict[object, object]] = None, world=None,
                 links: Optional[Dict[int, object]] = None):
        self.shape: Dict[str, int] = dict(zip(axis_names, (int(s) for s in shape)))
        self.rank = int(rank)
        self.world_size = math.prod(self.shape.values())
        coords = np.unravel_index(self.rank, tuple(self.shape.values()))
        self.coords: Dict[str, int] = {a: int(c) for a, c in zip(self.shape, coords)}
        self.groups = groups or {}
        self.world = world
        self.links = links or {}
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

    @property
    def sp(self) -> int:
        return self.size(SEQ_AXIS)

    @property
    def pp(self) -> int:
        return self.size(STAGE_AXIS)

    def rank_at(self, **coords: int) -> int:
        """The global rank of this rank's place with ``coords`` changed."""
        where = {**self.coords, **coords}
        return int(np.ravel_multi_index(tuple(where[a] for a in self.shape),
                                        tuple(self.shape.values())))

    def _group(self, axes: str | Tuple[str, ...]):
        axes = (axes,) if isinstance(axes, str) else tuple(a for a in self.shape if a in axes)
        if not axes:
            return None
        if set(axes) == set(self.shape):
            return self.world
        return self.groups.get(axes[0] if len(axes) == 1 else axes)

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

    def broadcast(self, tensor: torch.Tensor, axes: str | Tuple[str, ...] | None = None,
                  src: int = 0) -> torch.Tensor:
        """In place from global rank ``src`` over the ranks that differ only
        in ``axes`` (default: every rank); no-op without a group."""
        return self._broadcast(tensor, self.world if axes is None else self._group(axes), src)

    def link_broadcast(self, tensor: torch.Tensor, stage: int, src: int) -> torch.Tensor:
        """In place from global rank ``src`` over stages ``stage`` and
        ``stage + 1`` of this rank's data row (a pipeline hand-off)."""
        return self._broadcast(tensor, self.links.get(stage), src)

    def _broadcast(self, tensor, group, src):
        if group is not None:
            self.stats["broadcast"] += 1
            self.stats["bytes"] += tensor.numel() * tensor.element_size()
            dist.broadcast(tensor, src=src, group=group)
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
    groups, links = {}, {}
    # every rank creates every group, in one order: each proper set of axes
    # (a single axis keyed by its name), then the stage links
    for n in range(1, len(names)):
        for idx in itertools.combinations(range(len(names)), n):
            rest = [i for i in range(len(names)) if i not in idx]
            lines = np.transpose(grid, rest + list(idx)).reshape(
                -1, math.prod(shape[i] for i in idx))
            key = names[idx[0]] if n == 1 else tuple(names[i] for i in idx)
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[key] = group
    if STAGE_AXIS in names and shape[names.index(STAGE_AXIS)] > 1:
        rows = np.moveaxis(grid, names.index(STAGE_AXIS), -1).reshape(
            -1, shape[names.index(STAGE_AXIS)])
        for row in rows:
            for s in range(len(row) - 1):
                group = dist.new_group([int(row[s]), int(row[s + 1])])
                if rank in row[s:s + 2]:
                    links[s] = group
    return Mesh(shape, names, rank, groups, dist.group.WORLD, links)


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


def batch_pspec(key: str, ndim: int, axis_name: str = "data",
                seq_axis: Optional[str] = None) -> Tuple[Optional[str], ...]:
    """The mesh axis each dimension of a batch entry splits over (the
    reference's ``PartitionSpec``, trailing whole dimensions left out): the
    batch axis over ``axis_name`` and, with ``seq_axis``, the frame axis of
    a frame-level key over it."""
    b = batch_axis_index(key, ndim)
    spec = [None] * b + [axis_name]
    t_off = _TIME_AXIS_OFFSET.get(key)
    if seq_axis is not None and t_off is not None and b + t_off < ndim:
        spec += [None] * (t_off - 1) + [seq_axis]
    return tuple(spec)


def _mesh_seq_axis(mesh: Optional[Mesh]) -> Optional[str]:
    """'seq' iff the mesh has a sequence-parallel axis larger than 1."""
    return SEQ_AXIS if seq_size(mesh) > 1 else None


def frame_window(mesh: Optional[Mesh], frames: int) -> Tuple[int, int]:
    """``(offset, length)`` of this rank's window of a frame axis ``frames``
    long (the seq rank's contiguous part); ``(0, frames)`` without a ``seq``
    axis."""
    rows = process_local_rows(frames, seq_size(mesh), 0 if mesh is None else mesh.index(SEQ_AXIS))
    return rows.start, rows.stop - rows.start


def shard_batch(batch: Dict[str, object], mesh: Mesh) -> Dict[str, object]:
    """This rank's part of a global batch (numpy arrays or tensors): the data
    rank's contiguous block on each key's batch axis and, under a ``seq``
    axis, the seq rank's window of each frame-level key's frame axis."""
    seq = _mesh_seq_axis(mesh)
    out = {}
    for key, value in batch.items():
        index = []
        for dim, axis in enumerate(batch_pspec(key, value.ndim, seq_axis=seq)):
            count = mesh.size(axis) if axis is not None else 1
            index.append(slice(None) if axis is None else
                         process_local_rows(value.shape[dim], count, mesh.index(axis)))
        out[key] = value[tuple(index)]
    return out


def seq_window(batch: Dict[str, object], mesh: Optional[Mesh]) -> Dict[str, object]:
    """The seq rank's window of each frame-level key of a batch of this data
    rank's rows (the trainer collates whole rows, then windows them)."""
    if _mesh_seq_axis(mesh) is None:
        return batch
    out = dict(batch)
    for key, value in batch.items():
        if key in _TIME_AXIS_OFFSET:
            dim = batch_axis_index(key, value.ndim) + _TIME_AXIS_OFFSET[key]
            frames = process_local_rows(value.shape[dim], mesh.sp, mesh.index(SEQ_AXIS))
            out[key] = value[(slice(None),) * dim + (frames,)]
    return out


def _place(local: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """A zero-filled full-length tensor holding ``local`` at this rank's
    window of ``dim``."""
    shape = list(local.shape)
    n = shape[dim]
    shape[dim] = n * mesh.sp
    full = local.new_zeros(shape)
    full.narrow(dim, mesh.index(SEQ_AXIS) * n, n).copy_(local)
    return full


@torch.no_grad()
def gather_frames(batch: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The whole frame axis of each frame-level key, on every rank of the
    ``seq`` group, from the ranks' windows: each rank writes its window into
    zero-filled full tensors and the group sums them, one collective per
    dtype.  The batch unchanged without a ``seq`` axis."""
    if _mesh_seq_axis(mesh) is None:
        return batch
    keys = [k for k in batch if k in _TIME_AXIS_OFFSET and batch[k] is not None]
    out = dict(batch)
    for dtype in sorted({batch[k].dtype for k in keys}, key=str):
        group = [k for k in keys if batch[k].dtype == dtype]
        fulls = [_place(batch[k], batch_axis_index(k, batch[k].ndim) + _TIME_AXIS_OFFSET[k],
                        mesh) for k in group]
        flat = mesh.all_reduce(torch.cat([f.reshape(-1) for f in fulls]), SEQ_AXIS)
        for k, piece, f in zip(group, flat.split([f.numel() for f in fulls]), fulls):
            out[k] = piece.view_as(f)
    return out


class _SeqGather(torch.autograd.Function):
    """The whole of a frame-sharded activation on every rank of the ``seq``
    group: forward, each rank's window in a zero-filled full tensor summed
    over the group; backward, the full gradient summed over the group and
    this rank's window of it (Megatron's gather / reduce-scatter pair, in
    ``all_reduce`` alone)."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.n = dim, mesh, x.shape[dim]
        return mesh.all_reduce(_place(x, dim, mesh), SEQ_AXIS)

    @staticmethod
    def backward(ctx, grad):
        full = ctx.mesh.all_reduce(grad.contiguous().clone(), SEQ_AXIS)
        window = full.narrow(ctx.dim, ctx.mesh.index(SEQ_AXIS) * ctx.n, ctx.n)
        return window.contiguous(), None, None


def seq_gather(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """:class:`_SeqGather`: the whole ``dim`` of ``x`` from every seq rank's
    window of it, with the gradient routed back to the window's owner."""
    return _SeqGather.apply(x, dim, mesh)


def reduce_max(values: Iterable[torch.Tensor], mesh: Optional[Mesh], axis: str = "data"
               ) -> list:
    """The maxima of scalar tensors over ``axis`` in one collective."""
    values = list(values)
    if mesh is None:
        return values
    stacked = mesh.all_reduce(torch.stack(values), axis, op=dist.ReduceOp.MAX)
    return list(stacked.unbind())
