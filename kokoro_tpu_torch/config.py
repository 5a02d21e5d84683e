"""Model and audio configuration of the port.

The model fields of ``kokoro_tpu/config.py::TrainingConfig`` with the same
names and defaults (the training, data and mesh fields come with the
training slice).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict


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
