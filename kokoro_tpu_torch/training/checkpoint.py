"""Checkpoints and resume: ``torch.save`` of the training state plus a JSON
metadata document.

Port of ``kokoro_tpu/training/checkpoint.py``:

* a checkpoint directory holds ``state.pt`` (model state dict, AdamW moments
  and count, EMA parameters, the step counters and the trainer's generator
  state) and ``metadata.json`` (``model_metadata`` from
  :func:`build_model_metadata`, both configs, the trainer's counters); the
  JSON is written last, so a directory without it is an unfinished save and
  ``find_latest_checkpoint`` skips it;
* a strict restore: the architecture keys must match (``validate_metadata``);
  schedule drift is only warned about;
* ``checkpoint_epoch_{N}`` with keep-N pruning, ``best_model``,
  ``kokoro_russian_final``, ``resume_checkpoint="auto"`` (the highest epoch)
  or an explicit path;
* the phoneme processor as its ``to_dict()`` JSON beside the checkpoints.

Orbax and the cross-topology restore have no counterpart; the port reads no
JAX checkpoint.  :func:`load_inference_weights` gives the serving loader the
run directory's weights (final > best > latest epoch; EMA when it was
updated), as the JAX package's ``KokoroTTS`` loads its trainer's run
directory.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig

logger = logging.getLogger(__name__)

CHECKPOINT_PREFIX = "checkpoint_epoch_"
FINAL_NAME = "kokoro_russian_final"
BEST_NAME = "best_model"
PROCESSOR_NAME = "phoneme_processor.json"
STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"

# architecture keys that must match exactly at load (reference :309-358)
STRICT_KEYS = (
    "vocab_size", "n_mels", "hidden_dim", "n_encoder_layers",
    "n_decoder_layers", "n_heads", "encoder_ff_dim", "decoder_ff_dim",
)


def build_model_metadata(model_config: KokoroConfig, config: TrainingConfig,
                         vocab_size: int) -> Dict[str, Any]:
    """Architecture + inference-control snapshot, the reference's keys."""
    m = model_config
    return {
        "vocab_size": vocab_size, "n_mels": m.n_mels, "hidden_dim": m.hidden_dim,
        "n_encoder_layers": m.n_encoder_layers, "n_decoder_layers": m.n_decoder_layers,
        "n_heads": m.n_heads, "encoder_ff_dim": m.encoder_ff_dim,
        "decoder_ff_dim": m.decoder_ff_dim, "qk_norm": m.qk_norm,
        "rel_pos_type": m.rel_pos_type, "ffn_output_norm": m.ffn_output_norm,
        "use_stress_embedding": m.use_stress_embedding,
        "use_variance_predictor": m.use_variance_predictor,
        "variance_filter_size": m.variance_filter_size, "n_variance_bins": m.n_variance_bins,
        "max_decoder_seq_len": m.max_decoder_seq_len, "sample_rate": m.sample_rate,
        "hop_length": m.hop_length,
        "inference_controls": {
            "max_seq_length": config.max_seq_length,
            "stop_token_threshold": 0.5,
            "post_expected_stop_threshold": 0.2,
        },
        "schedule_snapshot": {
            "learning_rate": config.learning_rate, "warmup_steps": config.warmup_steps,
            "pct_start": config.pct_start, "max_lr_multiplier": config.max_lr_multiplier,
        },
        "split_semantics": "length-sorted-v2",
    }


def training_state_dict(state, generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Everything of a ``TrainState`` (and the trainer's generator) that
    ``torch.save`` writes."""
    opt = state.optimizer
    names = opt.names
    return {
        "model": state.model.state_dict(),
        "mu": dict(zip(names, opt.mu)), "nu": dict(zip(names, opt.nu)), "count": opt.count,
        "ema": dict(state.ema),
        "counters": {"opt_step": state.opt_step, "ema_updates": state.ema_updates,
                     "grad_ema": state.grad_ema, "grad_ema_steps": state.grad_ema_steps,
                     "skipped_steps": state.skipped_steps},
        "generator": None if generator is None else generator.get_state(),
    }


@torch.no_grad()
def restore_training_state(state, saved: Dict[str, Any],
                           generator: Optional[torch.Generator] = None) -> None:
    """Copy a saved training state into ``state`` (and ``generator``) in
    place."""
    state.model.load_state_dict(saved["model"], strict=True)
    opt = state.optimizer
    for i, name in enumerate(opt.names):
        opt.mu[i].copy_(saved["mu"][name])
        opt.nu[i].copy_(saved["nu"][name])
        state.ema[name].copy_(saved["ema"][name])
    opt.count = int(saved["count"])
    c = saved["counters"]
    state.opt_step, state.ema_updates = int(c["opt_step"]), int(c["ema_updates"])
    state.grad_ema, state.grad_ema_steps = float(c["grad_ema"]), int(c["grad_ema_steps"])
    state.skipped_steps = int(c["skipped_steps"])
    if generator is not None and saved.get("generator") is not None:
        # the state is a CPU byte tensor, whatever device the load mapped to
        generator.set_state(saved["generator"].cpu())


class CheckpointManager:
    def __init__(self, output_dir: str | Path, keep: int = 5):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save_checkpoint(
        self, name: str, state, model_config: KokoroConfig, config: TrainingConfig,
        metadata: Dict[str, Any], counters: Optional[Dict[str, Any]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Path:
        """Write ``output_dir/name``: ``state.pt``, then ``metadata.json``."""
        path = self.output_dir / name
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save(training_state_dict(state, generator), path / STATE_FILE)
        doc = {"model_metadata": metadata, "model_config": dataclasses.asdict(model_config),
               "config": config.to_dict(), "counters": counters or {}}
        (path / METADATA_FILE).write_text(json.dumps(doc, indent=2))
        return path

    def save_epoch_checkpoint(self, epoch: int, *args, **kwargs) -> Path:
        path = self.save_checkpoint(f"{CHECKPOINT_PREFIX}{epoch}", *args, **kwargs)
        self._prune_old()
        return path

    def save_best(self, *args, **kwargs) -> Path:
        return self.save_checkpoint(BEST_NAME, *args, **kwargs)

    def save_final_model(self, *args, **kwargs) -> Path:
        return self.save_checkpoint(FINAL_NAME, *args, **kwargs)

    def _prune_old(self) -> None:
        cks = sorted(self.output_dir.glob(f"{CHECKPOINT_PREFIX}*"),
                     key=lambda p: int(p.name[len(CHECKPOINT_PREFIX):]))
        for old in cks[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    def find_latest_checkpoint(self) -> Optional[Path]:
        """The highest-epoch checkpoint whose metadata.json exists."""
        return _latest_epoch_checkpoint(self.output_dir)

    @staticmethod
    def load_metadata(path: str | Path) -> Dict[str, Any]:
        return json.loads((Path(path) / METADATA_FILE).read_text())

    @staticmethod
    def validate_metadata(saved: Dict[str, Any], expected: Dict[str, Any]) -> None:
        """Every strict architecture key must match."""
        mismatches = [(k, saved.get(k), expected.get(k)) for k in STRICT_KEYS
                      if saved.get(k) != expected.get(k)]
        if mismatches:
            detail = ", ".join(f"{k}: saved={s} != expected={e}" for k, s, e in mismatches)
            raise ValueError(f"Checkpoint architecture mismatch: {detail}")

    def load_checkpoint(self, path: str | Path, state,
                        expected_metadata: Optional[Dict[str, Any]] = None,
                        generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Restore ``path`` into ``state`` in place; returns its metadata
        document."""
        path = Path(path)
        doc = self.load_metadata(path)
        if expected_metadata is not None:
            self.validate_metadata(doc["model_metadata"], expected_metadata)
            saved_sched = doc["model_metadata"].get("schedule_snapshot", {})
            cur_sched = expected_metadata.get("schedule_snapshot", {})
            drift = {k: (saved_sched.get(k), cur_sched.get(k)) for k in cur_sched
                     if saved_sched.get(k) != cur_sched.get(k)}
            if drift:
                logger.warning("Scheduler config drift at resume (resuming under the "
                               "current config): %s", drift)
        device = next(state.model.parameters()).device
        saved = torch.load(path / STATE_FILE, map_location=device, weights_only=True)
        restore_training_state(state, saved, generator)
        return doc

    def resume_from_checkpoint(self, resume: str, state,
                               expected_metadata: Optional[Dict[str, Any]] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> Optional[Dict[str, Any]]:
        """``'auto'`` | an explicit path | ``''`` (no resume)."""
        if not resume:
            return None
        if resume == "auto":
            path = self.find_latest_checkpoint()
            if path is None:
                logger.info("No checkpoint found for auto-resume; fresh start")
                return None
        else:
            path = Path(resume)
            if not path.exists():
                raise FileNotFoundError(f"Checkpoint not found: {path}")
        logger.info("Resuming from %s", path)
        return self.load_checkpoint(path, state, expected_metadata, generator)

    def save_phoneme_processor(self, processor) -> Path:
        path = self.output_dir / PROCESSOR_NAME
        path.write_text(json.dumps(processor.to_dict(), ensure_ascii=False, indent=1),
                        encoding="utf-8")
        return path


def _latest_epoch_checkpoint(run_dir: Path) -> Optional[Path]:
    best_epoch, best = -1, None
    for p in run_dir.glob(f"{CHECKPOINT_PREFIX}*"):
        m = re.match(rf"{CHECKPOINT_PREFIX}(\d+)$", p.name)
        if m and int(m.group(1)) > best_epoch and (p / METADATA_FILE).exists():
            best_epoch, best = int(m.group(1)), p
    return best


WEIGHT_CHOICES = ("auto", "ema", "model")


def load_inference_weights(run_dir: str | Path, use_ema_weights: str = "auto",
                           checkpoint: str | Path | None = None,
                           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``(model state dict, model_metadata)`` of a trainer's run directory,
    from ``checkpoint`` or else final > best > latest epoch.
    ``use_ema_weights`` (the reference's ``KokoroTTS`` choice): ``"ema"``
    the EMA parameters, ``"model"`` the raw ones, ``"auto"`` the EMA
    parameters when the checkpoint recorded EMA updates."""
    if use_ema_weights not in WEIGHT_CHOICES:
        raise ValueError(f"use_ema_weights must be one of {WEIGHT_CHOICES}, "
                         f"got {use_ema_weights!r}")
    run_dir = Path(run_dir)
    if checkpoint:
        path = Path(checkpoint)
    else:
        path = next((run_dir / name for name in (FINAL_NAME, BEST_NAME)
                     if (run_dir / name / METADATA_FILE).exists()), None)
        path = path or _latest_epoch_checkpoint(run_dir)
    if path is None:
        raise FileNotFoundError(f"no finished checkpoint under {run_dir}")
    doc = CheckpointManager.load_metadata(path)
    saved = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
    weights = dict(saved["model"])
    ema_updates = int(doc.get("counters", {}).get("ema_updates", 0))
    if use_ema_weights == "ema" or (use_ema_weights == "auto" and ema_updates > 0):
        weights.update(saved["ema"])
        logger.info("Using EMA weights of %s (%d updates)", path, ema_updates)
    else:
        logger.info("Using raw model weights of %s", path)
    return weights, doc["model_metadata"]
