"""Pipeline parallelism: GPipe microbatch pipelining over a ``stage`` axis.

Port of ``kokoro_tpu/parallel/pp.py``.  Each of the S stages is one process
(per data row of a ``('data', 'stage')`` mesh) holding a contiguous group of
a homogeneous layer stack; M microbatches stream through the stages, and the
result equals the sequential schedule: the same layers applied microbatch by
microbatch (:func:`sequential_apply`).  The reference's contracts hold:

* the stacked layout: :func:`stack_layer_params` gives the layers' tensors a
  leading ``(S, layers_per_stage)`` pair, :func:`unstack_layer_params`
  undoes it, and stage s holds layers ``[s L/S, (s+1) L/S)``
  (:func:`stage_layers`);
* aux inputs (a decoder's cross-attention memory and its masks) are indexed
  per microbatch: a stage sees the aux of the microbatch it is processing;
* bubbles cost nothing and contribute exactly zero gradient: a stage runs
  its layers only on the microbatches that reach it (there is no tick on
  which it applies them to a placeholder), so a layer whose jacobian is not
  finite on degenerate input cannot reach a gradient.

The mechanism differs from the reference's ``shard_map`` + ``ppermute``
ring.  In eager PyTorch a stage hand-off is an autograd Function on the
group of the two neighbouring stages (``Mesh.link_broadcast``): forward, a
``broadcast`` of the activation from stage s; backward, a ``broadcast`` of
its gradient from stage s + 1.  ``broadcast`` is the only point-to-point
primitive gloo offers on CUDA tensors, so one card can hold several stages.
Blocking collectives cannot deadlock because every stage walks its
microbatches in one fixed order on each group: 0 .. M-1 forward and, in the
backward, M-1 .. 0, an order the hand-offs enforce by chaining a scalar
token from one microbatch's hand-off to the next (autograd runs a node only
after every node that consumed its outputs).  The last stage returns the
outputs; every other stage returns ``None`` and an ``anchor``, a zero scalar
whose backward drives its part of the pipeline's backward: add it to the
stage's loss.  The token chains start at a leaf, ``chain``: pass it to
``torch.autograd.grad`` beside the parameters, since autograd skips the
nodes that lead to no requested input, and a stage's receiving hand-offs
lead to no parameter (:func:`pipeline_apply`).
"""

from __future__ import annotations

import types
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from kokoro_tpu_torch.parallel.mesh import STAGE_AXIS, Mesh, create_mesh


def stage_size(mesh: Optional[Mesh]) -> int:
    """Size of the ``stage`` (pipeline-parallel) axis; 1 when absent."""
    return 1 if mesh is None else mesh.size(STAGE_AXIS)


def stage_layers(n_layers: int, n_stages: int, stage: int) -> range:
    """The layers stage ``stage`` holds: the port's counterpart of the
    reference's ``stage_params_sharding`` (the leading axis of the stacked
    layout on the ``stage`` axis)."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not divide into {n_stages} stages")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def stack_layer_params(layer_params: Sequence[Mapping[str, torch.Tensor]],
                       n_stages: int) -> Dict[str, torch.Tensor]:
    """L per-layer parameter dicts (one structure) as one dict whose tensors
    lead with ``(n_stages, L // n_stages)``."""
    n_layers = len(layer_params)
    per = len(stage_layers(n_layers, n_stages, 0))
    return {name: torch.stack([p[name] for p in layer_params]).reshape(
        (n_stages, per) + tuple(layer_params[0][name].shape)) for name in layer_params[0]}


def unstack_layer_params(stacked: Mapping[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Inverse of :func:`stack_layer_params`: the L per-layer dicts."""
    first = next(iter(stacked.values()))
    n = first.shape[0] * first.shape[1]
    flat = {name: v.reshape((n,) + tuple(v.shape[2:])) for name, v in stacked.items()}
    return [{name: v[i] for name, v in flat.items()} for i in range(n)]


def _stages(stacked_params) -> List[Sequence[Any]]:
    """Per stage, the sequence of its layers' parameters: a stacked dict is
    split along its leading stage axis; a sequence is one entry per stage
    already (e.g. the layer indices of a model's stack)."""
    if isinstance(stacked_params, Mapping):
        first = next(iter(stacked_params.values()))
        S, per = first.shape[0], first.shape[1]
        layers = unstack_layer_params(stacked_params)
        return [layers[s * per:(s + 1) * per] for s in range(S)]
    return [list(layers) for layers in stacked_params]


def create_pp_mesh(n_stages: int, n_data: int = 1) -> Mesh:
    """A ``(data, stage)`` mesh over the process group (or pure PP with
    ``n_data=1``): a collective call every rank makes."""
    return create_mesh(types.SimpleNamespace(mesh_shape=(n_data, n_stages),
                                             mesh_axis_names=("data", STAGE_AXIS)))


# -- the stage hand-off --------------------------------------------------------
class _Send(torch.autograd.Function):
    """Stage ``link``'s side of the hand-off on the group of stages
    ``link`` and ``link + 1``: forward broadcasts the activation, backward
    receives its gradient from ``link + 1``.  Returns the next token of
    this stage's send chain."""

    @staticmethod
    def forward(ctx, x, token, mesh, link):
        ctx.mesh, ctx.link = mesh, link
        ctx.meta = (x.shape, x.dtype, x.device)
        mesh.link_broadcast(x.detach().contiguous(), link, src=mesh.rank)
        return token.new_zeros(())

    @staticmethod
    def backward(ctx, grad_token):
        shape, dtype, device = ctx.meta
        grad = torch.empty(shape, dtype=dtype, device=device)
        ctx.mesh.link_broadcast(grad, ctx.link, src=ctx.mesh.rank_at(stage=ctx.link + 1))
        return grad, torch.zeros_like(grad_token), None, None


class _Recv(torch.autograd.Function):
    """Stage ``link + 1``'s side: forward receives the activation from stage
    ``link``, backward sends its gradient back.  Returns the activation and
    the next token of this stage's receive chain."""

    @staticmethod
    def forward(ctx, token, mesh, link, shape, dtype):
        ctx.mesh, ctx.link = mesh, link
        x = torch.empty(shape, dtype=dtype, device=token.device)
        mesh.link_broadcast(x, link, src=mesh.rank_at(stage=link))
        return x, token.new_zeros(())

    @staticmethod
    def backward(ctx, grad_x, grad_token):
        ctx.mesh.link_broadcast(grad_x.contiguous(), ctx.link, src=ctx.mesh.rank)
        return torch.zeros_like(grad_token), None, None, None, None


def _pick(tree, m: int):
    """Microbatch ``m`` of an aux tree (a tensor or a dict of tensors, each
    leading with the microbatch axis)."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _pick(v, m) for k, v in tree.items()}
    return tree[m]


class Pipelined(NamedTuple):
    """What :func:`pipeline_apply` gives a stage."""

    outputs: Optional[torch.Tensor]  # (M, B, ...) on the last stage, else None
    anchor: torch.Tensor             # zero scalar: add it to the stage's loss
    chain: torch.Tensor              # leaf: request its gradient beside the parameters'


def pipeline_apply(layer_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor],
                   stacked_params, microbatches, mesh: Optional[Mesh], *,
                   aux=None):
    """Run a homogeneous layer stack over M microbatches, GPipe-pipelined over
    the mesh's ``stage`` axis.

    ``layer_fn(one_layer_params, activation, aux_m) -> activation`` is one
    layer's forward (shape-preserving).  ``stacked_params`` is a dict from
    :func:`stack_layer_params` (every rank may pass the whole of it) or a
    sequence of S per-stage sequences of layer parameters.
    ``microbatches`` leads with M (a tensor or a list): what enters layer 0,
    read on stage 0 only (other stages take its shape and dtype for their
    receive buffers).  ``aux``: a per-microbatch side-input tree leading
    with M, visible to every layer.  Under ``data`` each rank passes its
    rows.

    Returns :class:`Pipelined`: on the last stage the (M, B, ...) outputs of
    the stack, identical to :func:`sequential_apply`, elsewhere ``None``;
    ``anchor``, a zero scalar to add to this rank's loss so that its
    backward runs this stage's part of the pipeline's (a constant on the
    last stage); ``chain``, the leaf whose gradient the backward must
    request (``torch.autograd.grad(loss, params + [chain])``) so that the
    receiving hand-offs send their gradients back."""
    S = stage_size(mesh)
    stages = _stages(stacked_params)
    if len(stages) != S:
        raise ValueError(f"stacked params lead with {len(stages)} stages but the mesh "
                         f"'{STAGE_AXIS}' axis has size {S}")
    s = 0 if mesh is None else mesh.index(STAGE_AXIS)
    layers, last = stages[s], s == S - 1
    device = microbatches[0].device
    chain = torch.zeros((), device=device, requires_grad=torch.is_grad_enabled())
    recv_token, send_token, outputs = chain, chain, []
    for m in range(len(microbatches)):
        x = microbatches[m]
        if s > 0:
            x, recv_token = _Recv.apply(recv_token, mesh, s - 1, tuple(x.shape), x.dtype)
        aux_m = _pick(aux, m)
        for layer_params in layers:
            x = layer_fn(layer_params, x, aux_m)
        if last:
            outputs.append(x)
        else:
            send_token = _Send.apply(x, send_token, mesh, s)
    if last:
        return Pipelined(torch.stack(outputs), torch.zeros((), device=device), chain)
    return Pipelined(None, send_token, chain)


def sequential_apply(layer_fn, stacked_params, microbatches, aux=None) -> torch.Tensor:
    """The reference schedule: the whole layer stack applied microbatch by
    microbatch in one process; the numbers :func:`pipeline_apply` must
    match."""
    layers = [p for stage in _stages(stacked_params) for p in stage]
    outs = []
    for m in range(len(microbatches)):
        x, aux_m = microbatches[m], _pick(aux, m)
        for layer_params in layers:
            x = layer_fn(layer_params, x, aux_m)
        outs.append(x)
    return torch.stack(outs)


def _leaves(tree, path=""):
    if isinstance(tree, Mapping):  # in sorted key order, as a JAX tree flattens
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path or "/", tree


def assert_grads_match(grads, ref_grads, rel: float = 1e-5, atol: float = 1e-6) -> None:
    """Gradient parity of two trees (dicts, lists, tensors or arrays) with
    the reference's magnitude-relative L2 rule: per leaf,
    ``||g - g_ref||_2 <= rel * ||g_ref||_2 + atol``.  The pipelined and
    sequential schedules reduce in different orders, so elementwise gates
    are ill-conditioned on large gradients; this one is not."""
    flat, flat_ref = list(_leaves(grads)), list(_leaves(ref_grads))
    if len(flat) != len(flat_ref):
        raise AssertionError(f"gradient trees differ: {len(flat)} vs {len(flat_ref)} leaves")
    for (path, a), (_, b) in zip(flat, flat_ref):
        a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float64)
        b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b, np.float64)
        if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
            raise AssertionError(f"non-finite gradient at {path}")
        diff = float(np.linalg.norm(a - b))
        bound = rel * float(np.linalg.norm(b)) + atol
        if not diff <= bound:
            raise AssertionError(f"gradient mismatch at {path}: ||diff||={diff:.3e} > "
                                 f"bound={bound:.3e} (rel={rel}, ||ref||="
                                 f"{np.linalg.norm(b):.3e})")
