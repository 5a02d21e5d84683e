"""Configuration of the port.

:class:`KokoroConfig` holds the model and audio fields of
``kokoro_tpu/config.py::TrainingConfig``, :class:`TrainingConfig` the fields
the training step, the data pipeline and the trainer read, both with the
reference's names and defaults.  The mesh and TPU dispatch fields have no
counterpart (ROADMAP.md lists them).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple


@dataclass
class KokoroConfig:
    # --- model architecture ---
    vocab_size: int = 59
    n_mels: int = 80
    hidden_dim: int = 512
    n_encoder_layers: int = 6
    n_decoder_layers: int = 6
    n_heads: int = 8
    encoder_ff_dim: int = 1536
    decoder_ff_dim: int = 1536
    encoder_dropout: float = 0.15
    decoder_dropout: float = 0.20
    decoder_input_dropout: float = 0.15
    max_decoder_seq_len: int = 4000
    qk_norm: bool = True
    rel_pos_type: str = "rope"  # 'rope' | 'alibi'
    use_stochastic_depth: bool = True
    stochastic_depth_rate: float = 0.1
    ffn_output_norm: bool = True
    use_stress_embedding: bool = True
    use_variance_predictor: bool = True
    variance_filter_size: int = 256
    variance_kernel_size: int = 3
    variance_dropout: float = 0.1
    n_variance_bins: int = 256
    length_regulator_stop_gradient: bool = True
    attention_weight_dropout: bool = True
    # full-sequence decoder attention through the packed kernel
    # (ops/fused_attention.py); the encoder and the cached decode step stay
    # on plain matmul/softmax either way
    use_flash_attention: bool = False

    # --- audio ---
    sample_rate: int = 22050
    hop_length: int = 256

    @classmethod
    def from_metadata(cls, meta: Dict[str, Any], **overrides) -> "KokoroConfig":
        """Config from a checkpoint's ``model_metadata`` (the keys of
        ``kokoro_tpu/training/checkpoint.py::build_model_metadata``); keys
        the metadata lacks keep their defaults."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in meta.items() if k in names}
        kw.update(overrides)
        return cls(**kw)


@dataclass
class TrainingConfig:
    """The fields of ``kokoro_tpu/config.py::TrainingConfig`` that the
    training step, the data pipeline (``data/``) and the trainer
    (``training/trainer.py``) read, with the same names and defaults (the
    model's own fields are :class:`KokoroConfig`'s).  The training step takes
    gradient accumulation from the batch (a leading microbatch axis); the
    trainer stacks ``gradient_accumulation_steps`` batches into one."""

    data_dir: str = "data/processed_data"
    output_dir: str = "output_models"
    num_epochs: int = 30
    batch_size: int = 16
    learning_rate: float = 5.0e-5
    gradient_accumulation_steps: int = 2
    seed: int = 42

    # LR schedule: linear warmup -> OneCycle cosine, or per-epoch warm restarts
    use_onecycle_lr: bool = True
    max_lr_multiplier: float = 1.0
    pct_start: float = 0.20
    use_warmup: bool = True
    warmup_steps: int = 1200          # optimizer steps, not batches
    warmup_start_lr_ratio: float = 0.01
    lr_T_0: int = 20
    lr_T_mult: int = 2
    lr_eta_min: float = 1.0e-6

    # per-group LR multipliers (the ten groups of training/optimizer.py)
    encoder_lr_multiplier: float = 0.65
    stop_head_lr_multiplier: float = 0.1
    decoder_ffn_lr_multiplier: float = 0.30
    decoder_attn_lr_multiplier: float = 0.15
    variance_embedding_lr_multiplier: float = 0.15

    # EMA: an update every N successful steps; decay None -> from the
    # half-life in epochs (optimizer.recommended_ema_decay)
    ema_decay: Optional[float] = None
    ema_half_life_epochs: float = 1.0
    ema_update_every: int = 1

    # loss weights
    duration_loss_weight: float = 0.35
    stop_token_loss_weight: float = 0.010
    pitch_loss_weight: float = 1.0
    energy_loss_weight: float = 1.0
    pitch_huber_delta: float = 0.05
    energy_huber_delta: float = 0.05
    duration_huber_delta: float = 1.0
    stop_token_pos_weight: float = 17.0
    stop_token_smooth_tail: int = 6
    stop_token_smooth_decay: float = 0.5

    # SpecAugment on the expanded encoder memory
    use_spec_augment: bool = True
    spec_augment_time_mask_max: int = 5
    spec_augment_freq_mask_max: int = 3
    spec_augment_num_time_masks: int = 1
    spec_augment_num_freq_masks: int = 2
    spec_augment_start_epoch: int = 1

    # gradient clipping and stability
    max_grad_norm: float = 1.5
    projection_spike_clip_norm: float = 20.0
    attention_spike_clip_norm: float = 4.0
    ffn_spike_clip_norm: float = 3.0
    encoder_ffn_spike_clip_norm: float = 8.0
    stop_head_spike_clip_norm: float = 0.5
    dec_ffn_max_weight_norm: float = 95.0
    grad_explosion_warmup_steps: int = 400
    grad_explosion_warmup_floor: float = 8000.0
    grad_explosion_min_ema_steps: int = 100
    grad_explosion_ema_decay: float = 0.95
    grad_explosion_ema_multiplier: float = 3.0
    grad_explosion_final_floor: float = 1000.0
    emergency_clip_norm: float = 0.3
    stabilization_soft_frames: int = 1400
    stabilization_max_duration: int = 150

    # remat (torch.utils.checkpoint): decoder per layer, encoder in segments
    gradient_checkpointing: bool = True
    checkpoint_segments: int = 2

    # optimizer
    weight_decay: float = 0.04
    ffn_weight_decay: float = 0.1
    decoder_ffn_weight_decay: float = 0.35
    adam_eps: float = 1e-8
    adam_b1: float = 0.9
    adam_b2: float = 0.999

    # dtype policy: parameters and optimizer in param_dtype, every
    # Dense/Conv/Embed computes in compute_dtype (flax dtype/param_dtype)
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # features (the model's sample_rate, hop_length and n_mels are
    # KokoroConfig's)
    max_seq_length: int = 1800
    win_length: int = 1024
    n_fft: int = 1024
    f_min: float = 0.0
    f_max: float = 8000.0
    pitch_extract_fmin: float = 50.0
    pitch_extract_fmax: float = 800.0

    # speed perturbation (training items only)
    use_speed_perturbation: bool = True
    speed_perturb_range: float = 0.1
    speed_perturb_prob: float = 0.5

    # feature cache: per-utterance .npz files plus an in-RAM LRU; the
    # default directory is <data_dir>/.feature_cache_torch, apart from the
    # JAX package's
    use_feature_cache: bool = True
    feature_cache_dir: str = ""
    use_memory_cache: bool = True

    # MFA durations (data/mfa.py): one TextGrid per stem under
    # mfa_alignment_dir; without that directory the trainer warns and trains
    # on the fallback durations
    use_mfa: bool = True
    mfa_alignment_dir: str = "./mfa_output/alignments"
    mfa_acoustic_model: str = "russian_mfa"
    mfa_dictionary: str = "russian_mfa"
    # fill the feature cache (cli/precompute.py) before training starts
    precompute_features: bool = False

    # batching: frame budget + static length buckets (data/batching.py)
    use_dynamic_batching: bool = True
    max_frames_per_batch: int = 15000
    min_batch_size: int = 4
    max_batch_size: int = 8
    mel_bucket_sizes: Tuple[int, ...] = (256, 512, 768, 1024, 1280, 1536, 1800)
    phoneme_bucket_sizes: Tuple[int, ...] = (32, 64, 96, 128, 192, 256)
    max_sequence_dim_cap: int = 2000
    batch_order: str = "spread"
    carry_tail: bool = False
    pack_mode: str = "quantile"
    batch_size_multiple: Optional[int] = None

    # checkpoints (training/checkpoint.py)
    save_every: int = 5
    resume_checkpoint: str = "auto"
    keep_checkpoints: int = 5

    # validation and early stopping
    validation_split: float = 0.1
    validation_interval: int = 1
    early_stopping_patience: int = 15
    early_stopping_min_delta: float = 0.001

    # logging
    log_every_steps: int = 10

    def __post_init__(self) -> None:
        if not self.feature_cache_dir:
            self.feature_cache_dir = str(Path(self.data_dir) / ".feature_cache_torch")
        if self.win_length > self.n_fft:
            raise ValueError(f"win_length ({self.win_length}) cannot exceed n_fft ({self.n_fft})")
        if self.pack_mode not in ("quantile", "bucket"):
            raise ValueError(f"pack_mode must be 'quantile' or 'bucket', got {self.pack_mode!r}")
        if self.batch_order not in ("spread", "shape_major"):
            raise ValueError(f"batch_order must be 'spread' or 'shape_major', "
                             f"got {self.batch_order!r}")
        self.mel_bucket_sizes = tuple(sorted(self.mel_bucket_sizes))
        self.phoneme_bucket_sizes = tuple(sorted(self.phoneme_bucket_sizes))
        if self.mel_bucket_sizes and self.mel_bucket_sizes[-1] < self.max_seq_length:
            self.mel_bucket_sizes = self.mel_bucket_sizes + (self.max_seq_length,)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def spec_augment_args(self) -> Dict[str, int]:
        """The SpecAugment knobs as ``ops/specaugment.apply_spec_augment``
        takes them."""
        return dict(time_mask_max=self.spec_augment_time_mask_max,
                    freq_mask_max=self.spec_augment_freq_mask_max,
                    num_time_masks=self.spec_augment_num_time_masks,
                    num_freq_masks=self.spec_augment_num_freq_masks)


def _split(model: Dict[str, Any], train: Dict[str, Any], overrides: Dict[str, Any]
           ) -> Tuple[KokoroConfig, TrainingConfig]:
    model_fields = {f.name for f in dataclasses.fields(KokoroConfig)}
    train_fields = {f.name for f in dataclasses.fields(TrainingConfig)}
    for key, value in overrides.items():
        if key in model_fields:
            model[key] = value
        elif key in train_fields:
            train[key] = value
        else:
            raise TypeError(f"no config field named {key!r}")
    return KokoroConfig(**model), TrainingConfig(**train)


def get_default_config(**overrides) -> Tuple[KokoroConfig, TrainingConfig]:
    """The reference's defaults (``get_default_config``) as ``(model config,
    training config)``; ``overrides`` go to whichever of the two has the
    field."""
    return _split({}, {}, overrides)


def get_high_performance_config(**overrides) -> Tuple[KokoroConfig, TrainingConfig]:
    """The reference's throughput preset (``get_high_performance_config``):
    bf16 compute on f32 parameters, no remat, B=32 (no accumulation: the
    batch carries no microbatch axis), and the
    decoder's attention through the packed kernels with attention-weight
    dropout.  Returns ``(model config, training config)``; ``overrides`` go
    to whichever of the two has the field."""
    return _split(dict(use_flash_attention=True, attention_weight_dropout=True),
                  dict(batch_size=32, gradient_checkpointing=False), overrides)
