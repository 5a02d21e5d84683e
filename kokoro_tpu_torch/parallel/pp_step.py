"""The pipeline-parallel training step: ``KokoroModel`` trained with its
decoder stack GPipe-pipelined over a ``stage`` axis.

Port of ``kokoro_tpu/parallel/pp_step.py``.  One optimizer step on a
``('data', 'stage')`` mesh, each rank holding its data rank's rows:

1. every stage runs the encoder, the variance adaptor and SpecAugment
   (``forward_memory``) and ``prepare_decoder_input`` on each of the A
   accumulation microbatches, with the same draws on every stage;
2. the decoder stack runs through :func:`~kokoro_tpu_torch.parallel.pp.
   pipeline_apply`: the A microbatches are the GPipe microbatches, each
   stage applies its ``n_decoder_layers / S`` layers, and the memory, its
   mask and the mel mask ride as per-microbatch aux inputs;
3. the last stage alone runs ``finish_decoding`` and the losses (their sums
   over the ``data`` group of the last stage); the step's losses are the
   mean over the microbatches, broadcast from the last stage so that every
   rank takes the same host-side skip and clip decisions;
4. the gradients are summed over ``('data', 'stage')``: every parameter has
   its gradient from exactly the ranks whose backward touched it (a decoder
   layer from its stage, the heads from the last, the encoder from every
   stage, since the memory feeds each stage's cross-attention), then the
   shared update (``training.train_step.apply_gradient_update``).

The parameters, moments and EMA stay whole on every rank, as the
reference's state is replicated under ``stage``.  The reference's deltas
from the standard step hold: one ``(loss_scale, clip)`` from the whole
step's batch; losses the mean over microbatches; decoder dropout keyed per
(microbatch, layer) with the data rank folded in (here the standard step's
own per-microbatch seeds, so the masks are the accumulation step's);
``use_stochastic_depth=False`` and ``n_decoder_layers % S == 0``; the layer
function rematerialised when ``gradient_checkpointing`` is on.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from kokoro_tpu_torch.config import TrainingConfig
from kokoro_tpu_torch.models.kokoro import KokoroModel, _remat
from kokoro_tpu_torch.models.rng import Rng, fold
from kokoro_tpu_torch.parallel.mesh import STAGE_AXIS, Mesh
from kokoro_tpu_torch.parallel.pp import pipeline_apply, stage_layers, stage_size
from kokoro_tpu_torch.training.train_step import (
    LOSS_KEYS, TrainState, _losses, adaptive_stabilization, apply_gradient_update,
    batch_masks, step_rng, sync_gradients,
)

PP_SUM_AXES = ("data", STAGE_AXIS)


def make_pp_loss_fn(model: KokoroModel, config: TrainingConfig, mesh: Mesh,
                    spec_augment: bool = True):
    """``loss_fn(batch, rngs, deterministic=False) -> (total, losses,
    chain)``: ``batch`` leads with the microbatch axis ``(A, B, ...)``,
    ``rngs`` holds one :class:`Rng` per microbatch.  ``total`` is this
    rank's part of the backward (the losses plus the pipeline's anchor on
    the last stage, the anchor elsewhere), ``chain`` the leaf whose
    gradient the backward requests beside the parameters'
    (``pp.Pipelined``); ``losses`` are the step's on every rank (a
    collective call)."""
    S = stage_size(mesh)
    n_layers = len(model.decoder_layers)
    if n_layers % S:
        raise ValueError(f"n_decoder_layers={n_layers} not divisible by stage axis {S}")
    if model.config.use_stochastic_depth and model.config.stochastic_depth_rate > 0:
        raise ValueError("pipeline parallelism requires use_stochastic_depth=False "
                         "(stages share one DecoderBlock module)")
    stages = [list(stage_layers(n_layers, S, s)) for s in range(S)]
    last = mesh.index(STAGE_AXIS) == S - 1
    segments = max(1, config.checkpoint_segments) if config.gradient_checkpointing else 0
    sa_args = config.spec_augment_args() if (spec_augment and config.use_spec_augment) else None

    def layer_fn(i, x, aux):
        args = (x, aux["memory"], aux["memory_padding_mask"], aux["mel_padding_mask"], None,
                None, fold(aux["rng"], f"decoder_layer_{i}"))
        layer = model.decoder_layers[i]
        y, _ = _remat(layer, *args) if segments else layer(*args)
        return y

    def loss_fn(batch: Dict[str, torch.Tensor], rngs: List[Optional[Rng]],
                deterministic: bool = False):
        model.train(not deterministic)
        A = batch["mel_specs"].shape[0]
        micro = [{k: v[a] for k, v in batch.items()} for a in range(A)]
        aux, heads, x0 = [], [], []
        for mb, rng in zip(micro, rngs):
            rng = None if deterministic else rng
            text_pad, mel_pad = batch_masks(mb)
            memory, dur, pitch, energy, frame_mask = model.forward_memory(
                mb["phoneme_indices"], mb.get("stress_indices"), text_pad,
                mb["mel_specs"].shape[1], pitch_targets=mb.get("pitch_targets"),
                energy_targets=mb.get("energy_targets"),
                phoneme_durations=mb["phoneme_durations"], rng=rng,
                spec_augment=None if deterministic else sa_args,
                checkpoint_segments=0 if deterministic else segments)
            aux.append({"memory": memory, "memory_padding_mask": frame_mask,
                        "mel_padding_mask": mel_pad, "rng": rng})
            heads.append((dur, pitch, energy))
            x0.append(model.prepare_decoder_input(mb["mel_specs"], rng))
        y, anchor, chain = pipeline_apply(layer_fn, stages, x0, mesh,
                                          aux={k: [a[k] for a in aux] for k in aux[0]})
        if last:
            per_mb = []
            for y_m, mb, (dur, pitch, energy) in zip(y, micro, heads):
                mel_pred, stop_logits = model.finish_decoding(y_m)
                per_mb.append(_losses({"predicted_mel": mel_pred,
                                       "predicted_log_durations": dur,
                                       "predicted_stop_logits": stop_logits,
                                       "predicted_pitch": pitch, "predicted_energy": energy},
                                      mb, config, mesh))
            losses = {k: torch.stack([m[k] for m in per_mb]).mean() for k in LOSS_KEYS}
            total = losses["total"] + anchor
        else:
            losses = {k: torch.zeros((), device=anchor.device) for k in LOSS_KEYS}
            total = anchor
        values = torch.stack([losses[k].detach().float() for k in LOSS_KEYS])
        mesh.broadcast(values, STAGE_AXIS, src=mesh.rank_at(**{STAGE_AXIS: S - 1}))
        return total, dict(zip(LOSS_KEYS, values.unbind())), chain

    return loss_fn


def pp_step_gradients(state: TrainState, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator, config: TrainingConfig,
                      spec_augment: bool = True):
    """The gradients of one pipelined optimizer step, ``(grads, losses,
    clip, loss_scale)``, summed over ``('data', 'stage')``."""
    mesh = state.layout.mesh
    if batch["mel_specs"].dim() == 3:  # one microbatch through the pipeline
        batch = {k: v[None] for k, v in batch.items()}
    loss_fn = make_pp_loss_fn(state.model, config, mesh, spec_augment)
    loss_scale, clip = adaptive_stabilization(batch, config, mesh)
    rngs = [step_rng(generator, mesh) for _ in range(batch["mel_specs"].shape[0])]
    total, losses, chain = loss_fn(batch, rngs)
    params = [p for _, p in state.model.named_parameters()]
    grads = torch.autograd.grad(total, params + [chain], allow_unused=True)[:-1]
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    torch._foreach_mul_(grads, loss_scale)
    sync_gradients(grads, state.names, state.layout, PP_SUM_AXES)
    return grads, losses, clip, loss_scale


def make_pp_train_step(config: TrainingConfig, preclip_norms: Optional[Dict[str, float]] = None,
                       ema_decay: float = 0.999, spec_augment: bool = True
                       ) -> Callable[[TrainState, Dict[str, torch.Tensor], torch.Generator],
                                     Dict[str, float]]:
    """Pipeline-parallel ``train_step(state, batch, generator) -> metrics``,
    a drop-in for ``make_train_step`` under a mesh with a ``stage`` axis
    (the state made with that mesh).  A batch without a leading
    accumulation axis is one microbatch."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, float]:
        grads, losses, clip, scale = pp_step_gradients(state, batch, generator, config,
                                                       spec_augment)
        return apply_gradient_update(state, grads, losses, clip, scale, config=config,
                                     preclip_norms=preclip_norms, ema_decay=ema_decay)

    return train_step
