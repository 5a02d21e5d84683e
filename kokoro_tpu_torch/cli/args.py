"""argparse -> ``(KokoroConfig, TrainingConfig)`` for ``kokoro-train``.

Port of ``kokoro_tpu/cli/args.py`` for the fields the port reads, the MFA
and precompute arguments included.  ``--no-ema`` sets a field that no code
of the reference reads and the port's config does not have; the
dtype-profiling, compile-cache and mesh arguments have no counterpart
(ROADMAP.md).
"""

from __future__ import annotations

import argparse
from typing import Tuple

from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig, get_default_config

# argument -> config field, for the arguments that carry a value
VALUE_ARGS = {
    "epochs": "num_epochs", "batch_size": "batch_size", "learning_rate": "learning_rate",
    "gradient_accumulation": "gradient_accumulation_steps", "resume": "resume_checkpoint",
    "seed": "seed", "mfa_alignment_dir": "mfa_alignment_dir",
    "validation_split": "validation_split",
    "validation_interval": "validation_interval",
    "max_frames_per_batch": "max_frames_per_batch", "min_batch_size": "min_batch_size",
    "max_batch_size": "max_batch_size", "compute_dtype": "compute_dtype",
    "save_every": "save_every", "early_stopping_patience": "early_stopping_patience",
}
# store_true argument -> (config field, value)
FLAG_ARGS = {
    "no_mfa": ("use_mfa", False),
    "precompute_features": ("precompute_features", True),
    "no_dynamic_batching": ("use_dynamic_batching", False),
    "no_memory_cache": ("use_memory_cache", False),
    "no_spec_augment": ("use_spec_augment", False),
    "no_speed_perturbation": ("use_speed_perturbation", False),
    "no_gradient_checkpointing": ("gradient_checkpointing", False),
    "flash_attention": ("use_flash_attention", True),
    "no_attention_weight_dropout": ("attention_weight_dropout", False),
}


def add_training_arguments(parser: argparse.ArgumentParser) -> None:
    g = parser.add_argument_group("training")
    g.add_argument("--data-dir", default="data/processed_data")
    g.add_argument("--output-dir", default="output_models")
    g.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    g.add_argument("--epochs", type=int, default=None)
    g.add_argument("--batch-size", type=int, default=None)
    g.add_argument("--learning-rate", type=float, default=None)
    g.add_argument("--gradient-accumulation", type=int, default=None)
    g.add_argument("--resume", default=None, help="'auto', a checkpoint path, or '' to disable")
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("--no-mfa", action="store_true",
                   help="train on the fallback durations, not the MFA alignments")
    g.add_argument("--mfa-alignment-dir", default=None,
                   help="directory of <stem>.TextGrid alignments (cli.preprocess)")
    g.add_argument("--validation-split", type=float, default=None)
    g.add_argument("--validation-interval", type=int, default=None,
                   help="validate every N epochs")
    g.add_argument("--no-validation", action="store_true", help="disable validation entirely")
    g.add_argument("--no-dynamic-batching", action="store_true")
    g.add_argument("--max-frames-per-batch", type=int, default=None)
    g.add_argument("--min-batch-size", type=int, default=None)
    g.add_argument("--max-batch-size", type=int, default=None)
    g.add_argument("--no-memory-cache", action="store_true",
                   help="disable the in-RAM feature-cache tier; on-disk only")
    g.add_argument("--no-spec-augment", action="store_true")
    g.add_argument("--no-speed-perturbation", action="store_true")
    g.add_argument("--no-gradient-checkpointing", action="store_true")
    g.add_argument("--precompute-features", action="store_true",
                   help="fill the feature cache before training (cli.precompute)")
    g.add_argument("--flash-attention", action="store_true",
                   help="decoder attention through the hand-written kernels")
    g.add_argument("--no-attention-weight-dropout", action="store_true")
    g.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default=None)
    g.add_argument("--save-every", type=int, default=None)
    g.add_argument("--early-stopping-patience", type=int, default=None)
    g.add_argument("--verbose", action="store_true")


def create_config_from_args(args: argparse.Namespace) -> Tuple[KokoroConfig, TrainingConfig]:
    overrides = {"data_dir": args.data_dir, "output_dir": args.output_dir}
    for arg_name, field in VALUE_ARGS.items():
        value = getattr(args, arg_name)
        if value is not None:
            overrides[field] = value
    for arg_name, (field, value) in FLAG_ARGS.items():
        if getattr(args, arg_name):
            overrides[field] = value
    if args.no_validation:
        overrides["validation_interval"] = 10**9
    return get_default_config(**overrides)
