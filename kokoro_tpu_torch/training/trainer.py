"""The training runtime: the host loop around the training step, on one GPU.

Port of ``kokoro_tpu/training/trainer.py`` (``KokoroTrainer`` /
``train_model``):

* set-up: the RUSLAN dataset and its seed-42 90/10 split, the frame-budget
  batcher (fixed-size batches for validation), the model (vocabulary from the
  phoneme processor), the training state, the per-tensor pre-clips, the EMA
  decay from its half-life, the checkpoint manager;
* the epoch loop: ``gradient_accumulation_steps`` consecutive batches are
  collated to common buckets and stacked on a leading microbatch axis, one
  ``make_train_step`` call per optimizer step, SpecAugment from
  ``spec_augment_start_epoch``; epoch means over the steps taken; the
  reference's scalar tags (``loss/*``, ``stats/*``, ``metrics/*``) every
  ``log_every_steps`` into a ``SummaryWriter`` when tensorboard imports, else
  a JSONL file;
* validation on the EMA parameters through ``make_eval_step`` every
  ``validation_interval`` epochs, best checkpoint on improvement, early
  stopping, epoch checkpoints every ``save_every`` epochs, the final model,
  and resume (``resume_checkpoint``) with the counters and the dropout
  generator where they were.

Every random draw of a step comes from one ``torch.Generator`` seeded
``seed + 1`` and saved in the checkpoints (the reference folds a step
counter into ``PRNGKey(seed + 1)``); the batch plan and the data RNG are pure
functions of ``seed`` and the epoch, as in the reference.

No counterpart (TPU or XLA machinery, or work of later slices; ROADMAP.md):
the compile cache and ``prng_impl``, mesh / data / tensor / pipeline /
sequence parallelism, AOT warm-up and the program-ladder prediction, scan
chunks and ``pad_tail_steps``, ``cross_epoch_prefetch`` and the device_put
worker pools, the memory-planner preflight, profiler traces, spectrogram
images, weight and gradient histograms, and the TensorBoard event purge at
resume.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
from kokoro_tpu_torch.data.batching import (
    FixedSizeBatcher, FrameBudgetBatcher, collate, effective_batch_quantum,
)
from kokoro_tpu_torch.data.dataset import RuslanDataset, train_val_split
from kokoro_tpu_torch.data.phonemes import RussianPhonemeProcessor
from kokoro_tpu_torch.device import resolve_device
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.training.checkpoint import CheckpointManager, build_model_metadata
from kokoro_tpu_torch.training.optimizer import build_preclip_norms, recommended_ema_decay
from kokoro_tpu_torch.training.train_step import (
    LOSS_KEYS, create_train_state, make_eval_step, make_train_step,
)

logger = logging.getLogger(__name__)

LR_TAGS = (
    ("encoder", "stats/lr_encoder"), ("decoder_other", "stats/lr_decoder"),
    ("decoder_ffn", "stats/lr_decoder_ffn"), ("decoder_attn", "stats/lr_decoder_attn"),
    ("stop_head", "stats/lr_stop_head"), ("variance_embed", "stats/lr_variance_embed"),
)


class _JsonlWriter:
    """Metric writer when tensorboard is not installed: one JSON line per
    scalar in ``logs/metrics.jsonl``."""

    def __init__(self, logdir: Path):
        logdir.mkdir(parents=True, exist_ok=True)
        self._f = open(logdir / "metrics.jsonl", "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def _make_writer(logdir: Path):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return _JsonlWriter(logdir)
    return SummaryWriter(str(logdir))


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


class KokoroTrainer:
    def __init__(self, model_config: KokoroConfig, config: TrainingConfig,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.output_dir = Path(config.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.writer = _make_writer(self.output_dir / "logs")
        self.ckpt = CheckpointManager(self.output_dir, keep=config.keep_checkpoints)
        self.phoneme_processor = RussianPhonemeProcessor()
        self.model_config = dataclasses.replace(
            model_config, vocab_size=self.phoneme_processor.get_vocab_size())
        self._setup_datasets()
        self._setup_state()
        self.generator = torch.Generator().manual_seed(config.seed + 1)
        self.best_val_loss = float("inf")
        self.best_val_epoch = -1
        self.epochs_without_improvement = 0
        self.start_epoch = 0
        self.host_step = 0  # steps dispatched, skipped ones included (log x-axis)

    # -- set-up ---------------------------------------------------------------
    def _setup_datasets(self) -> None:
        cfg, mcfg = self.config, self.model_config
        data = dict(phoneme_processor=self.phoneme_processor, device=self.device)
        full = RuslanDataset(cfg.data_dir, mcfg, cfg, **data)
        train_idx, val_idx = train_val_split(len(full), cfg.validation_split, seed=cfg.seed)
        self.train_dataset = RuslanDataset(cfg.data_dir, mcfg, cfg, indices=train_idx,
                                           is_training=True, **data)
        self.val_dataset = RuslanDataset(cfg.data_dir, mcfg, cfg, indices=val_idx,
                                         is_training=False, **data)
        lengths = [self.train_dataset.lengths(i) for i in range(len(self.train_dataset))]
        if cfg.use_dynamic_batching:
            self.batcher = FrameBudgetBatcher(
                lengths, max_frames_per_batch=cfg.max_frames_per_batch,
                min_batch_size=cfg.min_batch_size, max_batch_size=cfg.max_batch_size,
                seed=cfg.seed, batch_order=cfg.batch_order, mel_buckets=cfg.mel_bucket_sizes,
                phoneme_buckets=cfg.phoneme_bucket_sizes, carry_tail=cfg.carry_tail,
                pack_mode=cfg.pack_mode, batch_quantum=self._batch_quantum())
        else:
            self.batcher = FixedSizeBatcher(lengths, cfg.batch_size, seed=cfg.seed)
        val_lengths = [self.val_dataset.lengths(i) for i in range(len(self.val_dataset))]
        self.val_batcher = FixedSizeBatcher(val_lengths, cfg.batch_size, seed=cfg.seed)
        logger.info("Datasets: %d train / %d val utterances", len(self.train_dataset),
                    len(self.val_dataset))

    def _batch_quantum(self) -> int:
        return effective_batch_quantum(self.config.batch_size_multiple,
                                       self.config.max_batch_size)

    def _setup_state(self) -> None:
        cfg = self.config
        batches_per_epoch = max(1, len(self.batcher.build_batches(0)))
        steps_per_epoch = max(1, -(-batches_per_epoch // max(1, cfg.gradient_accumulation_steps)))
        self.total_steps = cfg.num_epochs * steps_per_epoch
        self.ema_decay = (cfg.ema_decay if cfg.ema_decay is not None
                          else recommended_ema_decay(steps_per_epoch, cfg.ema_half_life_epochs))
        logger.info("Schedule: %d opt-steps/epoch, %d total; EMA decay %.6f",
                    steps_per_epoch, self.total_steps, self.ema_decay)
        model = KokoroModel(self.model_config).init_weights(
            torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self.state = create_train_state(model, cfg, self.total_steps)
        self.preclips = build_preclip_norms(self.state.names, cfg)
        self.eval_step = make_eval_step(model, cfg)
        self._train_steps: Dict[bool, object] = {}
        self.metadata = build_model_metadata(self.model_config, cfg,
                                             self.phoneme_processor.get_vocab_size())

    def _train_step(self, spec_augment: bool):
        if spec_augment not in self._train_steps:
            self._train_steps[spec_augment] = make_train_step(
                self.config, self.preclips, self.ema_decay, spec_augment=spec_augment)
        return self._train_steps[spec_augment]

    # -- training ---------------------------------------------------------------
    def train(self) -> Dict[str, float]:
        cfg = self.config
        self.ckpt.save_phoneme_processor(self.phoneme_processor)
        self._maybe_resume()
        for epoch in range(self.start_epoch, cfg.num_epochs):
            t0 = time.time()
            train_metrics = self.train_epoch(epoch)
            step = self.state.opt_step
            for k in LOSS_KEYS:
                self.writer.add_scalar(f"loss/train_{k}_epoch", train_metrics.get(k, 0.0), step)
            logger.info("Epoch %d: train total %.4f (mel %.4f) in %.1fs, %d steps", epoch + 1,
                        train_metrics.get("total", math.nan), train_metrics.get("mel", math.nan),
                        time.time() - t0, step)
            if (epoch + 1) % cfg.validation_interval == 0 and len(self.val_dataset):
                val_loss = self.validate_epoch(epoch)["mel"]
                if val_loss < self.best_val_loss - cfg.early_stopping_min_delta:
                    self.best_val_loss, self.best_val_epoch = val_loss, epoch
                    self.epochs_without_improvement = 0
                    self._save(self.ckpt.save_best, epoch)
                    logger.info("New best val mel loss: %.4f", val_loss)
                else:
                    self.epochs_without_improvement += 1
                if self.epochs_without_improvement >= cfg.early_stopping_patience:
                    logger.info("Early stopping at epoch %d (no improvement for %d)",
                                epoch + 1, cfg.early_stopping_patience)
                    break
            if (epoch + 1) % cfg.save_every == 0:
                self._save(self.ckpt.save_epoch_checkpoint, epoch, epoch + 1)
        self._save(self.ckpt.save_final_model, cfg.num_epochs - 1)
        self.writer.close()
        return {"best_val_loss": self.best_val_loss, "best_val_epoch": self.best_val_epoch}

    def _save(self, save, epoch: int, *name) -> None:
        save(*name, self.state, self.model_config, self.config, self.metadata,
             self._counters(epoch), self.generator)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch of optimizer steps; the means of the losses over the
        steps taken."""
        cfg = self.config
        step_fn = self._train_step(cfg.use_spec_augment
                                   and epoch + 1 >= cfg.spec_augment_start_epoch)
        batches = self.batcher.build_batches(epoch)
        rng = np.random.default_rng(cfg.seed + epoch)
        accum = max(1, cfg.gradient_accumulation_steps)
        sums: Dict[str, float] = {}
        taken = 0
        for start in range(0, len(batches), accum):
            batch = self._assemble(batches[start:start + accum], rng)
            metrics = step_fn(self.state, self._to_device(batch), self.generator)
            self.host_step += 1
            if metrics["stepped"]:
                taken += 1
                for k in LOSS_KEYS:
                    sums[k] = sums.get(k, 0.0) + metrics[k]
            else:
                logger.warning("Step skipped (non-finite gradients) at opt step %d",
                               self.host_step)
            if metrics["total"] > 10.0:
                logger.warning("Total loss %.2f > 10 at opt step %d: divergence suspected "
                               "(losses are clamped, not reset)", metrics["total"],
                               self.host_step)
            if self.host_step % cfg.log_every_steps == 0:
                self._log_step(metrics, self.host_step)
        return {k: v / max(taken, 1) for k, v in sums.items()}

    def _log_step(self, metrics: Dict[str, float], step: int) -> None:
        for k in LOSS_KEYS:
            self.writer.add_scalar(f"loss/{k}", metrics[k], step)
        self.writer.add_scalar("stats/grad_norm", metrics["grad_norm"], step)
        self.writer.add_scalar("stats/grad_norm_clipped", metrics["grad_norm_clipped"], step)
        for label, tag in LR_TAGS:
            self.writer.add_scalar(tag, self.state.optimizer.lr(label), step)

    def _assemble(self, group: List[List[int]], rng: np.random.Generator
                  ) -> Dict[str, np.ndarray]:
        """Collate index-batches to one ``(B, ...)`` batch, or ``(A, B, ...)``
        for A > 1 accumulated batches padded to common buckets; the batch
        dimension rounds up to the batch quantum (padding rows are masked)."""
        cfg, n_mels = self.config, self.model_config.n_mels
        out_B = _round_up(max(len(g) for g in group), self._batch_quantum())
        collated = [collate([self.train_dataset.get_features(i, rng) for i in indices], cfg,
                            n_mels, pad_batch_to=out_B) for indices in group]
        if len(collated) == 1:
            return collated[0]
        T = max(c["mel_specs"].shape[1] for c in collated)
        L = max(c["phoneme_indices"].shape[1] for c in collated)

        def grow(c):
            out = {}
            for k, v in c.items():
                if k in ("mel_specs", "pitch_targets", "energy_targets", "stop_token_targets"):
                    out[k] = np.pad(v, ((0, 0), (0, T - v.shape[1])) + ((0, 0),) * (v.ndim - 2))
                elif k in ("phoneme_indices", "stress_indices", "phoneme_durations"):
                    out[k] = np.pad(v, ((0, 0), (0, L - v.shape[1])))
                else:
                    out[k] = v
            return out

        collated = [grow(c) for c in collated]
        return {k: np.stack([c[k] for c in collated]) for k in collated[0]}

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    # -- validation ---------------------------------------------------------------
    def validate_epoch(self, epoch: int) -> Dict[str, float]:
        """Validation on the EMA parameters (reference trainer.py:1771-1910):
        fixed-size batches padded to ``batch_size`` rows."""
        cfg = self.config
        rng = np.random.default_rng(0)
        sums: Dict[str, float] = {}
        n = 0
        for indices in self.val_batcher.build_batches(0):
            feats = [self.val_dataset.get_features(i, rng) for i in indices]
            batch = collate(feats, cfg, self.model_config.n_mels, pad_batch_to=cfg.batch_size)
            metrics = self.eval_step(self._to_device(batch), params=self.state.ema)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
            n += 1
        avg = {k: v / max(n, 1) for k, v in sums.items()}
        step = self.state.opt_step
        for k in LOSS_KEYS:
            self.writer.add_scalar(f"loss/val_{k}", avg.get(k, 0.0), step)
            self.writer.add_scalar(f"loss/val_{k}_epoch", avg.get(k, 0.0), step)
        for k in ("spectral_convergence", "f0_rmse", "mcd"):
            self.writer.add_scalar(f"metrics/val_{k}", avg.get(k, 0.0), step)
        logger.info("Validation epoch %d: mel %.4f, spectral_conv %.4f, f0_rmse %.4f",
                    epoch + 1, avg.get("mel", 0.0), avg.get("spectral_convergence", 0.0),
                    avg.get("f0_rmse", 0.0))
        return avg

    # -- checkpoints ---------------------------------------------------------------
    def _counters(self, epoch: int) -> Dict:
        return {"epoch": epoch, "optimizer_step": self.state.opt_step,
                "ema_updates": self.state.ema_updates,
                "skipped_steps": self.state.skipped_steps,
                "best_val_loss": self.best_val_loss, "best_val_epoch": self.best_val_epoch,
                "host_step": self.host_step}

    def _maybe_resume(self) -> None:
        doc = self.ckpt.resume_from_checkpoint(self.config.resume_checkpoint, self.state,
                                               self.metadata, self.generator)
        if doc is None:
            return
        counters = doc.get("counters", {})
        self.start_epoch = int(counters.get("epoch", -1)) + 1
        self.best_val_loss = float(counters.get("best_val_loss", float("inf")))
        self.best_val_epoch = int(counters.get("best_val_epoch", -1))
        self.host_step = int(counters.get("host_step", self.state.opt_step))
        logger.info("Resumed at epoch %d (opt step %d, best val %.4f)", self.start_epoch,
                    self.state.opt_step, self.best_val_loss)


def train_model(model_config: KokoroConfig, config: TrainingConfig,
                device: str | torch.device = "cuda") -> Dict[str, float]:
    """Entry point (the reference's ``train_model``): train, checkpoint and
    write the final model into ``config.output_dir``.  ``device`` defaults to
    CUDA and raises without it; tests pass ``"cpu"``."""
    return KokoroTrainer(model_config, config, device).train()
