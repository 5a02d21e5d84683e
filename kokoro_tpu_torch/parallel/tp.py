"""Tensor parallelism: Megatron's column/row pairing over the ``model`` axis.

Port of ``kokoro_tpu/parallel/tp.py``.  The rules are the reference's
``leaf_pspec`` on the port's parameter names (a torch ``weight`` is
``(out, in)``, a flax ``kernel`` ``(in, out)``):

* column-parallel, output features split: ``w_q``, ``w_k``, ``w_v`` (head
  parallelism: heads are contiguous slices of the projected features) and the
  GLU ``linear1`` with its bias; torch weight rows;
* row-parallel, input features split: ``w_o`` and ``linear2``; torch weight
  columns.  Their biases stay replicated and are added once, after the
  reduction;
* everything else is replicated.  A dimension that ``tp`` does not divide
  stays replicated (the shape guard); the port guards per block, so an
  attention block whose heads ``tp`` does not divide stays replicated whole.

Two deliberate differences from the reference, which reaches the same global
function through GSPMD:

* ``linear1`` is sharded INTERLEAVED: its output is ``[gate; linear]``, each
  ``ff`` wide, and ``GLUFeedForward`` splits it with ``chunk(2)``.  Rank r
  holds rows ``[r ff/tp, (r+1) ff/tp)`` of each half, so its local ``chunk``
  pairs matching gate and linear features (the reference's contiguous shard
  is resharded by GSPMD, ``kokoro_tpu/parallel/tp.py:39-44``);
* ``linear1``/``linear2`` are sharded inside the GLU (``.ff.``) only; the
  MLP of ``SimpleDurationAdaptor`` (``use_variance_predictor=False``) stays
  replicated.

The forward runs on the shards: :func:`copy_to_region` (identity forward,
``all_reduce`` backward) before each column-parallel projection and
:func:`reduce_from_region` (``all_reduce`` forward, identity backward) after
each row-parallel one.  The per-head RMSNorm scales (``q_norm``, ``k_norm``,
``v_norm``) are replicated but act on the rank's heads, so each rank holds
a part of their gradient (:attr:`Layout.partial`); the training step sums it.
AdamW moments and EMA share the parameters' names, so one rule shards all
three (:func:`shard_tree` / :func:`gather_tree`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from kokoro_tpu_torch.parallel.mesh import Mesh

TP_AXIS = "model"
COLUMN_PARALLEL = ("w_q", "w_k", "w_v", "linear1")
ROW_PARALLEL = ("w_o", "linear2")
HALVES = {"linear1": 2}  # [gate; linear], each half split alike
HEAD_NORMS = ("q_norm", "k_norm", "v_norm")


@dataclass(frozen=True)
class Split:
    """How a tensor is split over the ``model`` axis: along torch ``dim``,
    each of its ``halves`` equal parts split alike."""

    dim: int
    halves: int = 1


def param_split(name: str, shape: Sequence[int], tp: int) -> Optional[Split]:
    """The split of one parameter (or moment, or EMA tensor) by its name and
    shape, None when replicated: the reference's ``leaf_pspec`` on the
    port's names."""
    parts = name.split(".")
    if tp <= 1 or len(parts) < 3 or not shape:
        return None
    leaf, module, parent = parts[-1], parts[-2], parts[-3]
    if module in ("linear1", "linear2") and parent != "ff":
        return None
    halves = HALVES.get(module, 1)
    if leaf == "weight" and len(shape) == 2:
        if module in COLUMN_PARALLEL and shape[0] % (tp * halves) == 0:
            return Split(0, halves)
        if module in ROW_PARALLEL and shape[1] % tp == 0:
            return Split(1)
    if leaf == "bias" and len(shape) == 1 and module in COLUMN_PARALLEL:
        if shape[0] % (tp * halves) == 0:
            return Split(0, halves)
    return None


def _pieces(size: int, split: Split, tp: int, rank: int):
    """(start, length) along ``split.dim`` of rank ``rank``'s slices of a
    dimension of ``size``, one per half."""
    half = size // split.halves
    part = half // tp
    return [(h * half + rank * part, part) for h in range(split.halves)]


def shard_tensor(full: torch.Tensor, split: Split, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of a full tensor (contiguous)."""
    return torch.cat([full.narrow(split.dim, start, n)
                      for start, n in _pieces(full.shape[split.dim], split, tp, rank)],
                     dim=split.dim).contiguous()


@torch.no_grad()
def place_shard(local: torch.Tensor, split: Split, tp: int, rank: int,
                out: torch.Tensor) -> torch.Tensor:
    """Write a rank's slice into its place in ``out`` (the full shape)."""
    offset = 0
    for start, n in _pieces(out.shape[split.dim], split, tp, rank):
        out.narrow(split.dim, start, n).copy_(local.narrow(split.dim, offset, n))
        offset += n
    return out


# -- the two Megatron functions ----------------------------------------------
class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the gradient summed over the axis's ranks."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous().clone(), ctx.axis), None, None


class _ReduceFromRegion(torch.autograd.Function):
    """Sum over the axis's ranks forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to_region(x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS) -> torch.Tensor:
    """Megatron's "copy to the model region": before a column-parallel
    projection of a replicated activation."""
    return _CopyToRegion.apply(x, mesh, axis)


def reduce_from_region(x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS) -> torch.Tensor:
    """Megatron's "reduce from the model region": after a row-parallel
    projection (and, over ``data``, the global sums of the loss)."""
    return _ReduceFromRegion.apply(x, mesh, axis)


# -- where each parameter lives ----------------------------------------------
@dataclass
class Layout:
    """A model's parameters on a mesh: ``splits`` of the sharded ones,
    ``partial`` the replicated ones whose gradient each rank holds in part
    (summed over the whole mesh by the training step)."""

    mesh: Mesh
    splits: Dict[str, Split] = field(default_factory=dict)
    partial: Tuple[str, ...] = ()

    @property
    def tp(self) -> int:
        return self.mesh.tp

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        split = self.splits.get(name)
        if split is None:
            return full
        return shard_tensor(full, split, self.tp, self.mesh.index(TP_AXIS))


def norms(tensors: Sequence[torch.Tensor], names: Optional[Sequence[str]] = None,
          layout: Optional[Layout] = None) -> List[torch.Tensor]:
    """Per-tensor f32 L2 norms of the WHOLE tensors: under a ``layout`` a
    sharded tensor's squares are summed over the ``model`` group, in one
    collective (none when nothing is sharded).  CPU tensors sum their squares
    in f64: PyTorch's CPU f32 norm drifts with the element count (1.9e-4
    relative at 2560 x 2560), where the card's reduction, and the
    reference's, stay within f32's rounding."""
    wide = [t.double() if t.device.type == "cpu" else t.float() for t in tensors]
    out = [x.float() for x in torch._foreach_norm(wide)]
    idx = [] if layout is None else [i for i, n in enumerate(names) if n in layout.splits]
    if idx:
        sq = torch.stack([out[i] for i in idx]) ** 2
        total = layout.mesh.all_reduce(sq, TP_AXIS).sqrt()
        for j, i in enumerate(idx):
            out[i] = total[j]
    return out


def shard_tree(tree: Mapping[str, torch.Tensor], layout: Optional[Layout]
               ) -> Dict[str, torch.Tensor]:
    """This rank's slices of full tensors keyed by parameter name
    (parameters, AdamW moments or EMA)."""
    if layout is None:
        return dict(tree)
    return {name: layout.shard(name, value) for name, value in tree.items()}


def gather_tree(tree: Mapping[str, torch.Tensor], layout: Optional[Layout]
                ) -> Dict[str, torch.Tensor]:
    """Full tensors from every rank's slices, on every rank: each rank
    writes its slice into a zero-filled full tensor and the ``model`` group
    sums them, one collective per dtype.  A collective call."""
    out = dict(tree)
    if layout is None or not layout.splits or layout.tp <= 1:
        return out
    tp, rank = layout.tp, layout.mesh.index(TP_AXIS)
    names = [n for n in tree if n in layout.splits]
    for dtype in sorted({tree[n].dtype for n in names}, key=str):
        group = [n for n in names if tree[n].dtype == dtype]
        fulls = []
        for n in group:
            shape = list(tree[n].shape)
            split = layout.splits[n]
            shape[split.dim] *= tp
            fulls.append(place_shard(tree[n], split, tp, rank,
                                     tree[n].new_zeros(shape)))
        flat = layout.mesh.all_reduce(torch.cat([f.reshape(-1) for f in fulls]), TP_AXIS)
        for n, piece, f in zip(group, flat.split([f.numel() for f in fulls]), fulls):
            out[n] = piece.view_as(f)
    return out


def shard_model(model: torch.nn.Module, mesh: Mesh) -> Layout:
    """Shard ``model`` in place over ``mesh``'s ``model`` axis: every
    attention block whose heads ``tp`` divides and every GLU whose width it
    divides keeps its rank's slices of its parameters and runs on them.
    Returns the layout (no splits at tp = 1)."""
    from kokoro_tpu_torch.models.blocks import GLUFeedForward, MultiHeadAttention

    layout = Layout(mesh)
    tp, rank = mesh.tp, mesh.index(TP_AXIS)
    if tp <= 1:
        return layout
    partial = []
    for mod_name, module in model.named_modules():
        if isinstance(module, MultiHeadAttention):
            if module.num_heads % tp:
                continue
            module.shard_heads(mesh)
            partial += [f"{mod_name}.{n}.weight" for n in HEAD_NORMS if hasattr(module, n)]
        elif isinstance(module, GLUFeedForward):
            if module.linear2.weight.shape[1] % tp:
                continue
            module.tp_mesh = mesh
        else:
            continue
        for leaf, param in module.named_parameters():
            name = f"{mod_name}.{leaf}"
            split = param_split(name, param.shape, tp)
            if split is not None:
                layout.splits[name] = split
                param.data = shard_tensor(param.data, split, tp, rank)
    layout.partial = tuple(partial)
    return layout
