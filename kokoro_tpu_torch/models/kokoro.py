"""The Kokoro acoustic model: text encoder + variance adaptor + autoregressive
mel decoder with a stop-token head.

Port of ``kokoro_tpu/models/kokoro.py``: text embedding scaled by
sqrt(hidden), additive 3-way stress embedding whose index 0 contributes
nothing, sinusoidal PE, a pre-norm encoder with a final LayerNorm, the
variance adaptor, a teacher-forced causal decoder over mel frames shifted
right by one, and mel + stop heads, the stop head on detached features.

Training (``model.train()``): every random draw comes from ``rng``
(``models/rng.py``), one named child per module as flax's ``make_rng``;
SpecAugment masks the expanded memory when ``spec_augment`` (its knobs) is
given; ``checkpoint_segments > 0`` turns on remat with
``torch.utils.checkpoint`` (non-reentrant): the decoder per layer, the encoder
in that many segments, as ``nn.remat`` does in the reference.  The seeds are
fixed before the forward, so a recompute applies the same masks.
:meth:`KokoroModel.set_compute_dtype` sets the dtype every Dense/Conv/Embed
computes in while the parameters stay f32 (flax ``dtype`` / ``param_dtype``).

Sequence parallelism (:meth:`KokoroModel.shard_sequence`, a ``seq`` axis):
the teacher-forced forward takes the whole batch on every rank of the
``seq`` group and runs the encoder, the variance adaptor and SpecAugment on
it alike on each (their frame-level convolutions and GroupNorm would need
halos and cross-rank statistics; the encoder is cheap).  The decoder input
is shifted right and given its positions on the whole frame axis, then cut
to the seq rank's window, so the window's first frame is the frame before
it, not zero; the decoder blocks, ``finish_decoding`` and the stop head run
on the window (``models/blocks.py``), and every frame-level output (mel,
stop logits, pitch, energy) is the window's.

Parameter names follow the flax tree (``convert.kokoro_state_dict_from_flax``
maps one onto the other): ``encoder_layer_i`` is ``encoder_layers.i``, the
adaptor is ``variance_adaptor`` or, with ``use_variance_predictor=False``,
``duration_adaptor``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kokoro_tpu_torch.config import KokoroConfig
from kokoro_tpu_torch.models.blocks import (
    DecoderBlock, Embedding, EncoderBlock, LayerNorm, Linear,
)
from kokoro_tpu_torch.models.positional import add_positional_encoding
from kokoro_tpu_torch.models.rng import Rng, dropout, fold
from kokoro_tpu_torch.models.variance import SimpleDurationAdaptor, VarianceAdaptor
from kokoro_tpu_torch.parallel.mesh import frame_window
from kokoro_tpu_torch.ops.specaugment import apply_spec_augment
from kokoro_tpu_torch.utils.profiling import span


def _remat(fn, *args):
    # the seeds travel in args, so the recompute needs no saved RNG state
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


class KokoroModel(nn.Module):
    def __init__(self, config: KokoroConfig):
        super().__init__()
        c = self.config = config
        d = c.hidden_dim
        self.text_embedding = Embedding(c.vocab_size, d)
        if c.use_stress_embedding:
            self.stress_embedding = Embedding(3, d)

        def rates(n):
            return [
                (i / max(n - 1, 1)) * c.stochastic_depth_rate if c.use_stochastic_depth else 0.0
                for i in range(n)
            ]

        common = dict(qk_norm=c.qk_norm, ffn_output_norm=c.ffn_output_norm,
                      attention_weight_dropout=c.attention_weight_dropout,
                      use_flash=c.use_flash_attention, rel_pos_type=c.rel_pos_type)
        self.encoder_layers = nn.ModuleList(
            EncoderBlock(d, c.n_heads, c.encoder_ff_dim, c.encoder_dropout,
                         drop_path_rate=r, **common)
            for r in rates(c.n_encoder_layers)
        )
        self.encoder_norm = LayerNorm(d)
        if c.use_variance_predictor:
            self.adaptor_name = "variance_adaptor"
            adaptor = VarianceAdaptor(
                hidden_dim=d, filter_size=c.variance_filter_size,
                kernel_size=c.variance_kernel_size, dropout=c.variance_dropout,
                n_bins=c.n_variance_bins,
                length_regulator_stop_gradient=c.length_regulator_stop_gradient,
            )
        else:
            self.adaptor_name = "duration_adaptor"
            adaptor = SimpleDurationAdaptor(hidden_dim=d, dropout=c.encoder_dropout)
        self.add_module(self.adaptor_name, adaptor)
        self.mel_projection_in = Linear(c.n_mels, d)
        self.decoder_layers = nn.ModuleList(
            DecoderBlock(d, c.n_heads, c.decoder_ff_dim, c.decoder_dropout,
                         drop_path_rate=r, **common)
            for r in rates(c.n_decoder_layers)
        )
        self.decoder_norm = LayerNorm(d)
        self.mel_projection_out = Linear(d, c.n_mels)
        self.stop_token_predictor = Linear(d, 1)
        self.sp_mesh = None

    def shard_sequence(self, mesh) -> "KokoroModel":
        """Run the decoder on the seq rank's window of frames of ``mesh``
        (module docstring).  The attention kernels stay off: the reference's
        trainer turns ``use_flash_attention`` off under ``seq``."""
        if self.config.use_flash_attention:
            raise ValueError("a frame-sharded decoder runs the plain attention route: build "
                             "the model with use_flash_attention=False")
        self.sp_mesh = mesh
        for layer in self.decoder_layers:
            layer.shard_sequence(mesh)
        return self

    @property
    def adaptor(self) -> nn.Module:
        return getattr(self, self.adaptor_name)

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> "KokoroModel":
        """Every Dense/Conv/Embed computes in ``dtype`` (None: its weight's
        dtype); parameters keep their own dtype and receive the gradients."""
        for m in self.modules():
            if hasattr(type(m), "compute_dtype"):
                m.compute_dtype = dtype
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "KokoroModel":
        """Seeded weights drawn like the flax initializers: xavier-uniform
        attention/FFN/predictor kernels (gain 0.5 for the FFN output),
        lecun-normal projections, embeddings N(0, 1/sqrt(d)) (flax's
        ``nn.Embed`` default: the text, pitch and energy embeddings) but the
        stress embedding's N(0, 0.02), zero biases except the duration
        head's log1p(5)."""
        def xavier(w, gain=1.0):
            fan_out, fan_in = w.shape[0], w[0].numel()
            rf = w[0, 0].numel() if w.dim() > 2 else 1
            bound = gain * math.sqrt(6.0 / (fan_in + fan_out * rf))
            w.uniform_(-bound, bound, generator=generator)

        def lecun(w):
            w.normal_(0.0, 1.0 / math.sqrt(w.shape[1]), generator=generator)

        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
        for m in self.modules():
            if isinstance(m, nn.Conv1d):
                xavier(m.weight)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[1]), generator=generator)
        for name, m in self.named_modules():
            if not isinstance(m, nn.Linear):
                continue
            if name.endswith("ff.linear2"):
                xavier(m.weight, gain=0.5)
            elif any(k in name for k in ("w_q", "w_k", "w_v", "w_o", "linear")):
                xavier(m.weight)
            else:
                lecun(m.weight)
        if self.config.use_stress_embedding:
            self.stress_embedding.weight.normal_(0.0, 0.02, generator=generator)
        if self.config.use_variance_predictor:
            self.adaptor.duration_predictor.linear.bias.fill_(math.log1p(5.0))
        return self

    # -- encoder ---------------------------------------------------------
    def encode_text(self, phoneme_indices, stress_indices, padding_mask,
                    rng: Optional[Rng] = None, checkpoint_segments: int = 0):
        with span("encoder"):
            c = self.config
            d = c.hidden_dim
            x = self.text_embedding(phoneme_indices) * math.sqrt(d)
            if c.use_stress_embedding and stress_indices is not None:
                stress = self.stress_embedding(stress_indices)
                x = x + stress * (stress_indices != 0)[..., None].to(stress.dtype)
            x = dropout(add_positional_encoding(x, 0), c.encoder_dropout, fold(rng, "pe_dropout"),
                        self.training)
            n = len(self.encoder_layers)
            rngs = [fold(rng, f"encoder_layer_{i}") for i in range(n)]
            if checkpoint_segments > 0 and n:
                per = -(-n // max(1, min(checkpoint_segments, n)))
                for lo in range(0, n, per):
                    hi = min(lo + per, n)

                    def run_segment(h, mask, lo=lo, hi=hi):
                        for i in range(lo, hi):
                            h = self.encoder_layers[i](h, mask, rngs[i])
                        return h

                    x = _remat(run_segment, x, padding_mask)
            else:
                for layer, layer_rng in zip(self.encoder_layers, rngs):
                    x = layer(x, padding_mask, layer_rng)
            x = self.encoder_norm(x)
            zero = torch.zeros((), dtype=x.dtype, device=x.device)
            return torch.where(padding_mask[:, :, None], zero, x)

    def encode_and_expand(self, phoneme_indices, stress_indices, padding_mask,
                          max_frames: int, pitch_targets=None, energy_targets=None,
                          phoneme_durations=None, rng: Optional[Rng] = None,
                          checkpoint_segments: int = 0, spec_augment: Optional[dict] = None):
        """The encoder, then the variance adaptor and, in training with
        ``spec_augment`` (``TrainingConfig.spec_augment_args()``),
        SpecAugment on the expanded memory.  Returns (memory, dur_pred,
        pitch_pred, energy_pred, frame_mask)."""
        text_encoded = self.encode_text(phoneme_indices, stress_indices, padding_mask, rng,
                                        checkpoint_segments)
        with span("variance"):
            memory, *predictions = self.adaptor(
                text_encoded, max_frames, mask=padding_mask, pitch_target=pitch_targets,
                energy_target=energy_targets, duration_target=phoneme_durations,
                rng=fold(rng, self.adaptor_name),
            )
            if self.training and spec_augment is not None:
                if rng is None:
                    raise ValueError("SpecAugment in a training forward needs an Rng")
                gen = rng.fold("specaugment").generator(memory.device)
                memory = apply_spec_augment(memory, gen, **spec_augment)
        return (memory, *predictions)

    # -- teacher-forced decoder ------------------------------------------
    def prepare_decoder_input(self, mel_specs: torch.Tensor,
                              rng: Optional[Rng] = None) -> torch.Tensor:
        """Mel shifted right by one (zero first frame), input projection,
        input dropout, PE."""
        decoder_input = F.pad(mel_specs[:, :-1, :], (0, 0, 1, 0))
        x = dropout(self.mel_projection_in(decoder_input), self.config.decoder_input_dropout,
                    fold(rng, "input_dropout"), self.training)
        return add_positional_encoding(x, 0)

    def finish_decoding(self, x: torch.Tensor):
        x = self.decoder_norm(x)
        return self.mel_projection_out(x), self.stop_token_predictor(x.detach())[..., 0]

    def decode_training(self, memory, memory_padding_mask, mel_specs, mel_padding_mask=None,
                        rng: Optional[Rng] = None, remat: bool = False):
        with span("decoder"):
            x = self.prepare_decoder_input(mel_specs, rng)
            offset, n = frame_window(self.sp_mesh, x.shape[1])
            x = x[:, offset:offset + n]
            for i, layer in enumerate(self.decoder_layers):
                args = (x, memory, memory_padding_mask, mel_padding_mask, None, None,
                        fold(rng, f"decoder_layer_{i}"))
                x, _ = _remat(layer, *args) if remat else layer(*args)
            return self.finish_decoding(x)

    def forward_memory(self, phoneme_indices, stress_indices, text_padding_mask,
                       max_frames: int, pitch_targets=None, energy_targets=None,
                       phoneme_durations=None, rng: Optional[Rng] = None,
                       spec_augment: Optional[dict] = None, checkpoint_segments: int = 0):
        """Everything before the decoder stack: :meth:`encode_and_expand`
        with an all-valid text mask when none is given."""
        if text_padding_mask is None:
            text_padding_mask = torch.zeros(phoneme_indices.shape, dtype=torch.bool,
                                            device=phoneme_indices.device)
        return self.encode_and_expand(
            phoneme_indices, stress_indices, text_padding_mask, max_frames,
            pitch_targets=pitch_targets, energy_targets=energy_targets,
            phoneme_durations=phoneme_durations, rng=rng,
            checkpoint_segments=checkpoint_segments, spec_augment=spec_augment,
        )

    def forward(self, phoneme_indices, mel_specs, phoneme_durations, stress_indices=None,
                text_padding_mask=None, mel_padding_mask=None, pitch_targets=None,
                energy_targets=None, rng: Optional[Rng] = None,
                spec_augment: Optional[dict] = None,
                checkpoint_segments: int = 0) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward (``model.eval()`` for the deterministic
        validation forward; ``model.train()`` with ``rng`` for the training
        forward).  Returns predicted_mel (B,T,M), predicted_log_durations
        (B,L), predicted_stop_logits (B,T), predicted_pitch (B,T),
        predicted_energy (B,T), frame_padding_mask (B,T).  Under
        :meth:`shard_sequence` the inputs are whole and the frame-level
        outputs but the mask are the rank's window of T."""
        T = mel_specs.shape[1]
        memory, dur_pred, pitch_pred, energy_pred, frame_mask = self.forward_memory(
            phoneme_indices, stress_indices, text_padding_mask, T,
            pitch_targets=pitch_targets, energy_targets=energy_targets,
            phoneme_durations=phoneme_durations, rng=rng, spec_augment=spec_augment,
            checkpoint_segments=checkpoint_segments,
        )
        predicted_mel, stop_logits = self.decode_training(
            memory, frame_mask, mel_specs, mel_padding_mask, rng,
            remat=checkpoint_segments > 0,
        )
        offset, n = frame_window(self.sp_mesh, T)
        if pitch_pred is not None:  # the window's frames, as every frame-level output
            pitch_pred = pitch_pred[:, offset:offset + n]
            energy_pred = energy_pred[:, offset:offset + n]
        return {
            "predicted_mel": predicted_mel,
            "predicted_log_durations": dur_pred,
            "predicted_stop_logits": stop_logits,
            "predicted_pitch": pitch_pred,
            "predicted_energy": energy_pred,
            "frame_padding_mask": frame_mask,
        }

    # -- inference helpers (the AR generator) ------------------------------
    def encode_for_inference(self, phoneme_indices, stress_indices, text_padding_mask,
                             max_frames: int):
        """Encode + expand with predicted durations.  Returns (memory,
        frame_padding_mask, expected_length (B,) int32)."""
        memory, dur_pred, _, _, frame_mask = self.encode_and_expand(
            phoneme_indices, stress_indices, text_padding_mask, max_frames
        )
        durations = torch.clamp(torch.round(torch.expm1(dur_pred)), min=0)
        durations = torch.where(text_padding_mask, torch.zeros((), dtype=durations.dtype, device=durations.device), durations)
        expected = durations.sum(dim=1).to(torch.int32)
        return memory, frame_mask, expected

    def project_memory_kv(self, memory: torch.Tensor) -> List[tuple]:
        return [layer.project_cross_kv(memory) for layer in self.decoder_layers]

    def decode_step(self, mel_frame, t: int, self_kv_caches: List[dict],
                    cross_kvs: List[tuple], memory_padding_mask: Optional[torch.Tensor]):
        """One AR step: (mel (B,1,M), stop_logit (B,1), new_self_kv_caches).
        The caches are updated in place."""
        x = add_positional_encoding(
            self.mel_projection_in(mel_frame), t, max_len=self.config.max_decoder_seq_len
        )
        new_caches = []
        for layer, cache, ckv in zip(self.decoder_layers, self_kv_caches, cross_kvs):
            x, new_cache = layer(x, None, memory_padding_mask, None, cache, ckv)
            new_caches.append(new_cache)
        x = self.decoder_norm(x)
        return self.mel_projection_out(x), self.stop_token_predictor(x)[..., 0], new_caches
