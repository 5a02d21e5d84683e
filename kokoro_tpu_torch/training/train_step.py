"""The training step: forward + loss -> gradients -> stability machinery ->
fused AdamW -> EMA.

Port of ``kokoro_tpu/training/train_step.py``:

* adaptive stabilization: loss scale and clip norm from the batch's risk
  ratios (max TRUE mel length / ``stabilization_soft_frames``, max duration /
  ``stabilization_max_duration``);
* gradient accumulation over a leading microbatch axis (``mel_specs`` 4-D):
  gradients and losses summed and divided by A, the clip the minimum over the
  microbatches;
* the explosion detector (EMA of global norms against a decaying floor; a
  trigger drops the clip to ``emergency_clip_norm``), per-tensor pre-clips,
  then the global clip;
* the non-finite skip: a step whose gradient norm or loss is not finite
  leaves parameters, both moments, the optimizer count, EMA and the
  explosion EMA untouched and counts one ``skipped_steps``;
* the FFN weight-norm projection and the EMA (every ``ema_update_every``
  successful steps).

What differs, on purpose: the reference keeps every decision on the device
(``jnp.where`` merges of whole pytrees); here one small host read per step
(the norms, the losses and the clip) decides them, and a skipped step does
no update at all instead of computing one and discarding it.  The state is
updated in place.  Every random draw of a step comes from the
``torch.Generator`` it is given: one :class:`~kokoro_tpu_torch.models.rng.Rng`
per microbatch, drawn before its forward.  No ``make_multi_step`` (a TPU
dispatch device), no null-step tail padding; pipeline parallelism has its
own step (``parallel/pp_step.py``) around the same update.

Data and tensor parallelism (a state made with a ``mesh``, whose
``layout`` says where each parameter lives, ``parallel/tp.py``): every rank
holds its rows of the batch and its shards of the parameters, moments and
EMA.  The losses are masked means over the global batch
(``training/losses.py``); the stabilization takes the global maxima; after
the microbatch loop the gradients are summed over the ``data`` group in
flat buckets, the per-head norm scales' partial gradients over the whole
mesh (:func:`sync_gradients`; DDP's reducer hooks ``AccumulateGrad``, which
``torch.autograd.grad`` never runs, so this is the port's DDP); the norms
are those of the global parameters.  The step's host read is broadcast from
rank 0, so every rank takes the same decisions.  The step seed folds in the
``data`` rank (ranks draw their own rows' masks; nothing is folded for an
axis of size 1).

Sequence parallelism (a ``seq`` axis; the model runs
``KokoroModel.shard_sequence``): each rank holds the seq rank's window of
the frame-level keys of its rows.  The step gathers their whole frame axis
over the ``seq`` group (``parallel/mesh.py::gather_frames``), runs the
encoder side on it and the decoder on the window, and evaluates the
frame-level losses on the window (``training/losses.py``).  The rule that
makes this exact: **each parameter's gradient is the sum, over the mesh, of
what each rank's own backward gives it, and no loss term is counted on two
ranks.**  So the gradients are summed over ``('data', 'seq')`` in the same
buckets, and the q/k/v norm scales' partial gradients over the whole mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.func import functional_call

from kokoro_tpu_torch.config import TrainingConfig
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.models.rng import Rng
from kokoro_tpu_torch.parallel.mesh import Mesh, frame_window, gather_frames, reduce_max
from kokoro_tpu_torch.parallel.tp import Layout, norms, shard_model
from kokoro_tpu_torch.training.losses import (
    calculate_training_losses, f0_rmse, frame_mask, mel_cepstral_distortion,
    spectral_convergence,
)
from kokoro_tpu_torch.training.optimizer import (
    FusedAdamW, apply_preclips, apply_weight_norm_constraints, ema_update,
    grad_explosion_threshold, update_grad_explosion_ema,
)
from kokoro_tpu_torch.utils.profiling import span

LOSS_KEYS = ("total", "mel", "duration", "stop", "pitch", "energy")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRAD_BUCKET_BYTES = 32 << 20  # gradient all_reduce buckets
GRAD_SUM_AXES = ("data", "seq")  # the axes a step's gradients are summed over


@dataclass
class TrainState:
    """Model (its f32 parameters), optimizer (moments and count), EMA
    parameters and the step counters."""

    model: KokoroModel
    optimizer: FusedAdamW
    ema: Dict[str, torch.Tensor]
    opt_step: int = 0          # successful optimizer steps
    ema_updates: int = 0
    grad_ema: float = 0.0      # explosion-detector EMA of global norms
    grad_ema_steps: int = 0
    skipped_steps: int = 0     # non-finite skips
    layout: Optional[Layout] = None  # the mesh and the parameters' shards

    @property
    def names(self) -> List[str]:
        """Parameter names, in the optimizer's order."""
        return self.optimizer.names

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def create_train_state(model: KokoroModel, config: TrainingConfig,
                       total_steps: int, mesh: Optional[Mesh] = None) -> TrainState:
    """A fresh state; the model computes in ``config.compute_dtype`` from now
    on (its parameters keep ``config.param_dtype``).  With ``mesh`` the
    model is sharded over its ``model`` axis first (``tp.shard_model``), so
    moments and EMA are the rank's shards too, and its decoder runs on the
    seq rank's frames under a ``seq`` axis (``shard_sequence``)."""
    model.to(DTYPES[config.param_dtype]).set_compute_dtype(DTYPES[config.compute_dtype])
    layout = None if mesh is None else shard_model(model, mesh)
    if mesh is not None and mesh.sp > 1:
        model.shard_sequence(mesh)
    params = dict(model.named_parameters())
    return TrainState(
        model=model, optimizer=FusedAdamW(params, config, total_steps),
        ema={n: p.detach().clone() for n, p in params.items()}, layout=layout,
    )


def batch_masks(batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    L = batch["phoneme_indices"].shape[-1]
    T = batch["mel_specs"].shape[-2]
    device = batch["mel_specs"].device
    text_pad = torch.arange(L, device=device)[None, :] >= batch["phoneme_lengths"][:, None]
    mel_pad = torch.arange(T, device=device)[None, :] >= batch["mel_lengths"][:, None]
    return text_pad, mel_pad


def adaptive_stabilization(batch: Dict[str, torch.Tensor], config: TrainingConfig,
                           mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_scale, clip_norm) as f32 device scalars from the batch's risk:
    risk > 1 scales the loss by max(0.25, 1/risk) and clips at
    max(0.05, 0.5/sqrt(risk)).  With ``mesh`` the maxima are the global
    batch's, so every rank scales and clips alike."""
    mel_len, max_dur = reduce_max([batch["mel_lengths"].max().float(),
                                   batch["phoneme_durations"].max().float()], mesh)
    risk = torch.maximum(mel_len / float(config.stabilization_soft_frames),
                         max_dur / float(config.stabilization_max_duration))
    one = torch.ones((), device=risk.device)
    loss_scale = torch.where(risk > 1.0, torch.clamp(1.0 / risk, min=0.25), one)
    clip = torch.where(risk > 1.0, torch.clamp(0.5 / torch.sqrt(risk), min=0.05),
                       one * config.max_grad_norm)
    return loss_scale, clip


def global_norm(tensors, names=None, layout: Optional[Layout] = None) -> torch.Tensor:
    """L2 norm over all ``tensors``; under a ``layout`` that of the global
    parameters (sharded tensors whole, replicated ones counted once)."""
    return torch.linalg.vector_norm(torch.stack(norms(tensors, names, layout)))


def _buckets(tensors: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    out, size = [[]], 0
    for t in tensors:
        if out[-1] and (size + t.numel() * t.element_size() > GRAD_BUCKET_BYTES
                        or t.dtype != out[-1][0].dtype):
            out.append([])
            size = 0
        out[-1].append(t)
        size += t.numel() * t.element_size()
    return [b for b in out if b]


def sync_gradients(grads: List[torch.Tensor], names: List[str],
                   layout: Optional[Layout], axes: Tuple[str, ...] = GRAD_SUM_AXES) -> None:
    """In place: gradients summed over ``axes`` (those of the mesh's axes:
    ``data`` and ``seq``, or ``data`` and ``stage`` for the pipelined step),
    those of ``layout.partial`` (replicated scales acting on sharded heads)
    over the whole mesh; each bucket of up to ``GRAD_BUCKET_BYTES`` is one
    ``all_reduce``.  No-op without a process group."""
    if layout is None or layout.mesh.world is None:
        return
    partial = set(layout.partial)
    every = tuple(layout.mesh.shape)
    for axes, members in ((axes, [g for g, n in zip(grads, names) if n not in partial]),
                          (every, [g for g, n in zip(grads, names) if n in partial])):
        for bucket in _buckets(members):
            flat = layout.mesh.all_reduce(torch.cat([g.reshape(-1) for g in bucket]), axes)
            for g, piece in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(piece.view_as(g))


def step_rng(generator: torch.Generator, mesh: Optional[Mesh] = None) -> Rng:
    """A microbatch's seed tree: one draw from the step's generator (the
    same on every rank), the ``data`` rank folded in when that axis is
    larger than one."""
    rng = Rng.from_generator(generator)
    if mesh is not None and mesh.dp > 1:
        rng = rng.fold(f"data_rank_{mesh.index('data')}")
    return rng


def _model_outputs(model: KokoroModel, batch, rng, spec_augment, segments, params=None):
    """The forward on this rank's part of the batch: ``(outputs, mel mask
    of its frames, offset of its first frame)``.  Under a ``seq`` axis the
    whole frame axis is gathered first (a collective call)."""
    whole = gather_frames(batch, model.sp_mesh)
    text_pad, mel_pad = batch_masks(whole)
    kwargs = dict(
        phoneme_indices=whole["phoneme_indices"], mel_specs=whole["mel_specs"],
        phoneme_durations=whole["phoneme_durations"],
        stress_indices=whole.get("stress_indices"), text_padding_mask=text_pad,
        mel_padding_mask=mel_pad, pitch_targets=whole.get("pitch_targets"),
        energy_targets=whole.get("energy_targets"), rng=rng,
        spec_augment=spec_augment, checkpoint_segments=segments,
    )
    out = model(**kwargs) if params is None else functional_call(model, params, (), kwargs)
    offset, n = frame_window(model.sp_mesh, mel_pad.shape[1])
    return out, frame_mask(batch["mel_lengths"], n, offset), offset


def _losses(out, batch, config: TrainingConfig, mesh: Optional[Mesh] = None,
            frame_offset: int = 0):
    with span("loss"):
        return calculate_training_losses(
            predicted_mel=out["predicted_mel"],
            predicted_log_durations=out["predicted_log_durations"],
            predicted_stop_logits=out["predicted_stop_logits"],
            mel_specs=batch["mel_specs"], phoneme_durations=batch["phoneme_durations"],
            stop_token_targets=batch["stop_token_targets"], mel_lengths=batch["mel_lengths"],
            phoneme_lengths=batch["phoneme_lengths"], predicted_pitch=out["predicted_pitch"],
            predicted_energy=out["predicted_energy"], pitch_targets=batch.get("pitch_targets"),
            energy_targets=batch.get("energy_targets"),
            duration_loss_weight=config.duration_loss_weight,
            stop_token_loss_weight=config.stop_token_loss_weight,
            pitch_loss_weight=config.pitch_loss_weight,
            energy_loss_weight=config.energy_loss_weight,
            stop_token_pos_weight=config.stop_token_pos_weight,
            duration_huber_delta=config.duration_huber_delta,
            pitch_huber_delta=config.pitch_huber_delta,
            energy_huber_delta=config.energy_huber_delta, mesh=mesh, frame_offset=frame_offset,
        )


def make_loss_fn(model: KokoroModel, config: TrainingConfig, spec_augment: bool = True,
                 mesh: Optional[Mesh] = None):
    """``loss_fn(batch, rng, deterministic=False) -> (total, losses)``.
    ``spec_augment=False`` skips SpecAugment (the reference's epochs before
    ``spec_augment_start_epoch``); ``deterministic=True`` is the eval-mode
    forward and draws nothing.  With ``mesh`` the losses are the global
    batch's."""
    segments = max(1, config.checkpoint_segments) if config.gradient_checkpointing else 0
    sa_args = config.spec_augment_args() if (spec_augment and config.use_spec_augment) else None

    def loss_fn(batch, rng: Optional[Rng] = None, deterministic: bool = False):
        model.train(not deterministic)
        out, _, offset = _model_outputs(model, batch, None if deterministic else rng,
                                        None if deterministic else sa_args,
                                        0 if deterministic else segments)
        losses = _losses(out, batch, config, mesh, offset)
        return losses["total"], losses

    return loss_fn


def apply_gradient_update(state: TrainState, grads: List[torch.Tensor],
                          losses: Dict[str, torch.Tensor], clip_norm: torch.Tensor,
                          loss_scale: torch.Tensor, *, config: TrainingConfig,
                          preclip_norms: Optional[Dict[str, float]] = None,
                          ema_decay: float = 0.999) -> Dict[str, float]:
    """Everything after the gradients (in place on ``state`` and ``grads``);
    returns the step's metrics as floats, ``loss_scale`` (the
    stabilization's smallest loss scale of the step) among them."""
    layout, names = state.layout, state.names
    ordinal = state.opt_step + state.skipped_steps
    with span("optimizer", ordinal):
        with span("clip", ordinal):
            raw_norm = global_norm(grads, names, layout)
            if preclip_norms is not None:
                apply_preclips(grads, [preclip_norms[n] for n in names], names, layout)
            clipped_norm = global_norm(grads, names, layout)
        # the step's one host read, rank 0's on every rank: everything below is
        # decided from these
        with span("host_read", ordinal):
            values = torch.stack([raw_norm, clipped_norm, clip_norm.float(), loss_scale.float()]
                                 + [losses[k].float() for k in LOSS_KEYS])
            if layout is not None:
                layout.mesh.broadcast(values)
            values = values.tolist()
        raw, clipped, clip, scale = values[:4]
        metrics = dict(zip(LOSS_KEYS, values[4:]), loss_scale=scale)
        threshold = grad_explosion_threshold(state.grad_ema, state.grad_ema_steps,
                                             state.opt_step, config)
        exploded = raw > threshold
        if exploded:
            clip = config.emergency_clip_norm
        finite = math.isfinite(raw) and math.isfinite(metrics["total"])
        if finite:
            with span("update", ordinal):
                torch._foreach_mul_(grads, min(1.0, clip / (clipped + 1e-6)))
                state.optimizer.step(grads)
                params = state.params
                apply_weight_norm_constraints(params, config, layout)
                every = max(int(config.ema_update_every), 1)
                if every == 1 or (state.opt_step + 1) % every == 0:
                    with span("ema", ordinal):
                        ema_update([state.ema[n] for n in state.names],
                                   [params[n].detach() for n in state.names], ema_decay)
                    state.ema_updates += 1
                state.grad_ema = update_grad_explosion_ema(state.grad_ema, state.grad_ema_steps,
                                                           raw, config.grad_explosion_ema_decay)
                state.grad_ema_steps += 1
                state.opt_step += 1
        else:
            state.skipped_steps += 1
    metrics.update(grad_norm=raw, grad_norm_clipped=min(clipped, clip), clip_norm=clip,
                   exploded=float(exploded), stepped=float(finite))
    return metrics


def step_gradients(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator, config: TrainingConfig,
                   spec_augment: bool = True):
    """The gradients of one optimizer step, ``(grads, losses, clip,
    loss_scale)``: each microbatch (a leading axis of ``batch``) draws its
    seed, scales its loss and adds its gradients; the sums are divided by
    the microbatch count and, on a mesh, synchronised
    (:func:`sync_gradients`)."""
    mesh = None if state.layout is None else state.layout.mesh
    loss_fn = make_loss_fn(state.model, config, spec_augment, mesh)
    params = [p for _, p in state.model.named_parameters()]
    if batch["mel_specs"].dim() == 4:
        A = batch["mel_specs"].shape[0]
        micro = [{k: v[a] for k, v in batch.items()} for a in range(A)]
    else:
        A, micro = 1, [batch]
    grads, losses, clip, scale = None, None, None, None
    ordinal = state.opt_step + state.skipped_steps
    for mb in micro:
        rng = step_rng(generator, mesh)
        loss_scale, mb_clip = adaptive_stabilization(mb, config, mesh)
        scale = loss_scale if scale is None else torch.minimum(scale, loss_scale)
        with span("forward", ordinal):
            total, mb_losses = loss_fn(mb, rng)
        with span("backward", ordinal):
            mb_grads = torch.autograd.grad(total, params, allow_unused=True)
        mb_grads = [torch.zeros_like(p) if g is None else g
                    for g, p in zip(mb_grads, params)]
        torch._foreach_mul_(mb_grads, loss_scale)
        if grads is None:
            grads, losses, clip = mb_grads, dict(mb_losses), mb_clip
        else:
            torch._foreach_add_(grads, mb_grads)
            losses = {k: losses[k] + mb_losses[k] for k in LOSS_KEYS}
            clip = torch.minimum(clip, mb_clip)
    if A > 1:
        torch._foreach_div_(grads, float(A))
        losses = {k: v / A for k, v in losses.items()}
        clip = torch.minimum(clip, torch.full_like(clip, config.max_grad_norm))
    sync_gradients(grads, state.names, state.layout)
    return grads, losses, clip, scale


def make_train_step(config: TrainingConfig, preclip_norms: Optional[Dict[str, float]] = None,
                    ema_decay: float = 0.999, spec_augment: bool = True
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor], torch.Generator],
                                  Dict[str, float]]:
    """``train_step(state, batch, generator) -> metrics``.  ``batch`` values
    may carry a leading microbatch axis (gradient accumulation);
    ``generator`` is a CPU ``torch.Generator``, from which each microbatch
    draws the one seed of its forward.  A state on a mesh takes its rank's
    rows of the global batch."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, float]:
        with span("train_step", state.opt_step + state.skipped_steps):
            grads, losses, clip, scale = step_gradients(state, batch, generator, config,
                                                        spec_augment)
            return apply_gradient_update(state, grads, losses, clip, scale, config=config,
                                         preclip_norms=preclip_norms, ema_decay=ema_decay)

    return train_step


def make_diagnostic_step(model: KokoroModel, config: TrainingConfig,
                         layout: Optional[Layout] = None):
    """``diag(batch) -> (outputs, losses + spectral_convergence, grads)``:
    one deterministic forward and backward of one microbatch on the model's
    parameters (port of the reference's ``make_diagnostic_step``).  The
    trainer's step consumes its gradients inside the fused AdamW, so the
    gradient histograms and train spectrograms re-derive them here.  It
    draws nothing from any generator, leaves no ``.grad`` on a parameter,
    touches no optimizer or step counter and puts the model back in the mode
    it found it in.  ``grads`` maps every parameter name to its gradient
    (zeros where the loss does not reach it).  Under a ``layout`` every rank
    calls it on its rows: the losses and gradients are the global batch's
    (the rank's shards of them), a collective call."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    mesh = None if layout is None else layout.mesh

    def diag(batch: Dict[str, torch.Tensor]):
        was_training = model.training
        model.eval()
        try:
            out, mel_mask, offset = _model_outputs(model, batch, None, None, 0)
            losses = _losses(out, batch, config, mesh, offset)
            grads = torch.autograd.grad(losses["total"], params, allow_unused=True)
        finally:
            model.train(was_training)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        sync_gradients(grads, names, layout)
        losses = {k: v.detach() for k, v in losses.items()}
        losses["spectral_convergence"] = spectral_convergence(
            out["predicted_mel"].detach().float(), batch["mel_specs"].float(), mel_mask, mesh)
        outputs = {k: (v.detach() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
        return outputs, losses, dict(zip(names, grads))

    return diag


def make_eval_step(model: KokoroModel, config: TrainingConfig, mesh: Optional[Mesh] = None):
    """``eval_step(batch, params=None) -> metrics``: one deterministic
    forward (on ``params``, e.g. the EMA, when given) for the losses,
    spectral convergence, MCD and, with pitch targets, F0 RMSE.
    ``with_outputs=True`` returns ``(metrics, model outputs)``.  With
    ``mesh`` each rank passes its rows and every metric is the global
    batch's (a collective call)."""

    @torch.no_grad()
    def eval_step(batch, params: Optional[Dict[str, torch.Tensor]] = None,
                  with_outputs: bool = False):
        model.eval()
        out, mel_mask, offset = _model_outputs(model, batch, None, None, 0, params)
        metrics = _losses(out, batch, config, mesh, offset)
        pred = out["predicted_mel"].float()
        target = batch["mel_specs"].float()
        metrics["spectral_convergence"] = spectral_convergence(pred, target, mel_mask, mesh)
        metrics["mcd"] = mel_cepstral_distortion(pred, target, mel_mask, mesh=mesh)
        if batch.get("pitch_targets") is not None and out["predicted_pitch"] is not None:
            metrics["f0_rmse"] = f0_rmse(out["predicted_pitch"].float(),
                                         batch["pitch_targets"][:, :mel_mask.shape[1]].float(),
                                         mel_mask, mesh)
        metrics = {k: float(v) for k, v in metrics.items()}
        return (metrics, out) if with_outputs else metrics

    return eval_step

