"""The training runtime: the host loop around the training step, on one GPU
or on a mesh of processes.

Port of ``kokoro_tpu/training/trainer.py`` (``KokoroTrainer`` /
``train_model``):

* set-up: the RUSLAN dataset (durations from the MFA TextGrids under
  ``mfa_alignment_dir`` when ``use_mfa`` is set and the directory exists,
  else the fallback durations, with a warning) and its seed-42 90/10 split,
  the frame-budget batcher (fixed-size batches for validation), the model
  (vocabulary from the phoneme processor), the training state, the
  per-tensor pre-clips, the EMA decay from its half-life, the checkpoint
  manager;
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
  generator where they were; at resume the log records past the restored
  step, which a crash after the last save leaves, are purged
  (``training/tb_events.py``);
* observability, each piece where the reference has it: on cuda an
  advisory memory preflight (``utils/memory_planner.py``; it never aborts
  training); TensorBoard's custom-scalars layout; a ``torch.profiler``
  window (``utils/profiling.trace``) into ``<run>/profiler_logs`` over the
  first ``profile_steps`` optimizer steps of epoch ``profile_epoch_start``,
  closed on an exception too, in which the spans ``kokoro.data`` (a step's
  assembly and copy) and the step's own show; the ``InterbatchProfiler``'s
  phases of the same names; weight histograms every epoch; every
  ``histogram_every_steps`` optimizer steps the diagnostic step
  (``train_step.make_diagnostic_step``) for gradient histograms,
  ``metrics/train_spectral_convergence``, the train spectrogram images and,
  under ``verbose``, the duration diagnostics; validation spectrogram
  images and ``val_predictions/*`` histograms; the host batch of a skipped
  step as ``debug_batch_step_<n>.npz``; the feature-cache report every
  epoch.  Histogram tags use the reference's flax paths
  (``weights/params/<path>``, ``gradients/params/<path>``;
  ``convert.flax_names``), so the two packages' runs line up.  The logging
  is best-effort, as in the reference: an error is logged as a warning and
  training goes on.  Without tensorboard, ``logs/metrics.jsonl`` takes
  every record, a histogram as its summary statistics and an image as an
  ``.npy`` file under ``logs/images/``.

Every random draw of a step comes from one ``torch.Generator`` seeded
``seed + 1`` and saved in the checkpoints (the reference folds a step
counter into ``PRNGKey(seed + 1)``); the batch plan and the data RNG are pure
functions of ``seed`` and the epoch, as in the reference.

Data and tensor parallelism (``parallel/``, the reference's ``_setup_mesh``):
with ``distributed_init`` the process group starts from torchrun's
environment; a ``mesh_shape`` (or, under a process group, one ``data`` axis
over every rank) gives ``dp_size`` / ``tp_size``.  The batch plan is the
same on every rank; each rank collates only its row block of each batch,
with T and L forced from the length metadata so that every rank pads alike;
validation is sharded over ``data`` with metrics from global sums; the
model, moments and EMA are the rank's shards.  Logs, histograms, images, the
profiler window and checkpoint writes happen on global rank 0 only, while
every rank runs the collectives behind them.

Sequence and pipeline parallelism (the ``seq`` and ``stage`` axes, the
reference's routing): under either, ``use_flash_attention`` is turned off
with the reference's log line, so the attention kernels stay off.  Under
``seq`` each rank collates its data rank's rows with T forced to a multiple
of ``sp`` and keeps its seq rank's window of the frame-level keys
(``parallel/mesh.py::seq_window``); the step, the validation and the
diagnostics run the frame-sharded decoder.  Under ``stage`` the step is
``parallel/pp_step.py``'s, the accumulation microbatches being the
pipeline's; the state stays whole on every rank, so validation runs the
whole model on each.  Checkpoints are full tensors written by rank 0 and
resume on any mesh.

No counterpart (TPU or XLA machinery; ROADMAP.md): the compile cache and
``prng_impl``, AOT warm-up and the program-ladder prediction, scan chunks
(``scan_steps``) and ``pad_tail_steps``, ``cross_epoch_prefetch`` and the
device_put worker pools.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
from kokoro_tpu_torch.convert import flax_names
from kokoro_tpu_torch.data.batching import (
    FixedSizeBatcher, FrameBudgetBatcher, collate, effective_batch_quantum,
)
from kokoro_tpu_torch.data.dataset import RuslanDataset, train_val_split
from kokoro_tpu_torch.data.mfa import MFAIntegration
from kokoro_tpu_torch.data.phonemes import RussianPhonemeProcessor
from kokoro_tpu_torch.device import resolve_device
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.parallel.mesh import (
    create_mesh, init_distributed, process_local_rows, round_up_to_multiple, seq_window,
)
from kokoro_tpu_torch.parallel.tp import gather_tree
from kokoro_tpu_torch.training.checkpoint import CheckpointManager, build_model_metadata
from kokoro_tpu_torch.training.optimizer import build_preclip_norms, recommended_ema_decay
from kokoro_tpu_torch.training.train_step import (
    LOSS_KEYS, batch_masks, create_train_state, make_diagnostic_step, make_eval_step,
    make_train_step,
)
from kokoro_tpu_torch.utils.profiling import DATA, STEP, InterbatchProfiler, span, trace

logger = logging.getLogger(__name__)

LR_TAGS = (
    ("encoder", "stats/lr_encoder"), ("decoder_other", "stats/lr_decoder"),
    ("decoder_ffn", "stats/lr_decoder_ffn"), ("decoder_attn", "stats/lr_decoder_attn"),
    ("stop_head", "stats/lr_stop_head"), ("variance_embed", "stats/lr_variance_embed"),
)


class _JsonlWriter:
    """Metric writer when tensorboard is not installed: one JSON line per
    record in ``logs/metrics.jsonl``; a histogram as its count, min, max,
    mean and standard deviation, an image as an ``.npy`` file under
    ``logs/images/`` named in its line."""

    def __init__(self, logdir: Path):
        logdir.mkdir(parents=True, exist_ok=True)
        self._dir = logdir
        self._f = open(logdir / "metrics.jsonl", "a")

    def _write(self, record):
        self._f.write(json.dumps(record) + "\n")

    def add_scalar(self, tag, value, step):
        self._write({"tag": tag, "value": float(value), "step": int(step)})

    def add_histogram(self, tag, values, step):
        v = np.asarray(values, np.float64).ravel()
        stats = ({"min": float(v.min()), "max": float(v.max()), "mean": float(v.mean()),
                  "std": float(v.std())} if v.size else {})
        self._write({"tag": tag, "kind": "histogram", "step": int(step), "count": int(v.size),
                     **stats})

    def add_image(self, tag, image, step):
        path = self._dir / "images" / f"{tag.replace('/', '_')}_{int(step)}.npy"
        path.parent.mkdir(exist_ok=True)
        np.save(path, np.asarray(image, np.float32))
        self._write({"tag": tag, "kind": "image", "step": int(step),
                     "file": str(path.relative_to(self._dir))})

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class _NullWriter:
    """The metric writer of every rank but the main one: writes nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def _make_writer(logdir: Path):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return _JsonlWriter(logdir)
    return SummaryWriter(str(logdir))


def _mel_image(mel) -> np.ndarray:
    """(T, n_mels) log-mel -> min/max-normalised CHW image."""
    mel = np.asarray(mel, np.float32).T
    lo, hi = mel.min(), mel.max()
    return ((mel - lo) / max(hi - lo, 1e-6))[None]


# the reference's custom-scalars layout: train/val pairs and the per-group LRs
CUSTOM_SCALARS = {
    "Epoch Losses": {
        "Total Loss (train vs val)": ["Multiline", ["loss/train_total_epoch",
                                                    "loss/val_total_epoch"]],
        "Mel Loss (train vs val)": ["Multiline", ["loss/train_mel_epoch", "loss/val_mel_epoch"]],
        "Stop Loss (train vs val)": ["Multiline", ["loss/train_stop_epoch",
                                                   "loss/val_stop_epoch"]],
        "Duration Loss (train vs val)": ["Multiline", ["loss/train_duration_epoch",
                                                       "loss/val_duration_epoch"]],
    },
    "Spectral Metrics": {
        "Spectral Convergence (train vs val)": ["Multiline", [
            "metrics/train_spectral_convergence", "metrics/val_spectral_convergence"]],
    },
    "Learning Rate": {
        "LR (encoder vs decoder vs stop vs ffn vs attn)": ["Multiline", [
            tag for _, tag in LR_TAGS]],
    },
}


class KokoroTrainer:
    """``init_params`` (optional): a model state dict (whole tensors, e.g.
    ``convert.kokoro_state_dict_from_flax`` of another run's parameters)
    that replaces the seeded initialisation before the training state, and
    so the EMA, is built; a resumed checkpoint still overrides it."""

    def __init__(self, model_config: KokoroConfig, config: TrainingConfig,
                 device: str | torch.device = "cuda",
                 init_params: Dict[str, torch.Tensor] | None = None):
        self.device = resolve_device(device)
        self.config = config
        self._init_params = init_params
        self._setup_mesh()
        self.output_dir = Path(config.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.writer = self._new_writer()
        self.ckpt = CheckpointManager(self.output_dir, keep=config.keep_checkpoints,
                                      main=self.is_main)
        self.phoneme_processor = RussianPhonemeProcessor()
        self.model_config = dataclasses.replace(
            model_config, vocab_size=self.phoneme_processor.get_vocab_size())
        self._setup_datasets()
        self._setup_state()
        if self.device.type == "cuda":
            self._preflight_memory_check()
        self.generator = torch.Generator().manual_seed(config.seed + 1)
        self._flax_names = flax_names(self.state.model)
        self._diag_step = None
        self._interbatch = None
        self._trace = None
        self._trace_steps_left = 0
        self.best_val_loss = float("inf")
        self.best_val_epoch = -1
        self.epochs_without_improvement = 0
        self.start_epoch = 0
        self.host_step = 0  # steps dispatched, skipped ones included (log x-axis)
        # the dispatched-shape census (the reference's ``_shape_counts``):
        # (mel_specs shape of an assembled batch, 1) -> optimizer calls
        # through it; k is always 1, the port has no scan chunks
        self._shape_counts: Dict[tuple, int] = {}

    # -- set-up ---------------------------------------------------------------
    def _setup_mesh(self) -> None:
        """The mesh (reference ``_setup_mesh``): with ``distributed_init``
        the process group starts here (the device becomes the rank's card);
        without a process group and ``mesh_shape`` there is no mesh."""
        cfg = self.config
        if cfg.distributed_init and not dist.is_initialized():
            self.device = init_distributed(device=self.device)
        self.mesh = (create_mesh(cfg) if cfg.mesh_shape is not None or dist.is_initialized()
                     else None)
        size = (lambda axis: 1) if self.mesh is None else self.mesh.size
        self.dp_size, self.tp_size = size("data"), size("model")
        self.sp_size, self.pp_size = size("seq"), size("stage")
        self.process_count = dist.get_world_size() if dist.is_initialized() else 1
        self.process_index = dist.get_rank() if dist.is_initialized() else 0
        self.is_main = self.process_index == 0
        if max(self.dp_size, self.tp_size, self.sp_size, self.pp_size) > 1:
            logger.info("Parallelism: %d-way data x %d-way seq x %d-way tensor x %d-way "
                        "pipeline mesh over %s devices (%d process%s)", self.dp_size,
                        self.sp_size, self.tp_size, self.pp_size, self.device.type,
                        self.process_count, "es" if self.process_count > 1 else "")

    def _new_writer(self):
        if not self.is_main:
            return _NullWriter()
        writer = _make_writer(self.output_dir / "logs")
        if hasattr(writer, "add_custom_scalars"):
            try:
                writer.add_custom_scalars(CUSTOM_SCALARS)
            except Exception as err:
                logger.warning("custom scalars layout failed: %s", err)
        return writer

    def _setup_datasets(self) -> None:
        cfg, mcfg = self.config, self.model_config
        mfa = None
        if cfg.use_mfa:
            if Path(cfg.mfa_alignment_dir).exists():
                mfa = MFAIntegration(
                    alignment_dir=cfg.mfa_alignment_dir, acoustic_model=cfg.mfa_acoustic_model,
                    dictionary=cfg.mfa_dictionary, hop_length=mcfg.hop_length,
                    sample_rate=mcfg.sample_rate)
            else:
                logger.warning("MFA alignment dir %s missing; falling back to estimated "
                               "durations", cfg.mfa_alignment_dir)
        data = dict(phoneme_processor=self.phoneme_processor, device=self.device, mfa=mfa)
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

    def _preflight_memory_check(self) -> None:
        """The planner's estimate of the largest step the batcher can give
        (the batch rows, rounded to the quantum, at the largest buckets)
        against the card's memory: a warning when it does not fit, else one
        info line.  Advisory only: it never stops training."""
        from kokoro_tpu_torch.utils.memory_planner import (
            DEFAULT_HBM_BYTES, _bucket_lists, estimate_train_step_hbm, live_hbm_bytes,
        )

        cfg = self.config
        try:
            mels, phons = _bucket_lists(cfg)
            rows = cfg.max_batch_size if cfg.use_dynamic_batching else cfg.batch_size
            local_rows = round_up_to_multiple(rows, self._batch_quantum()) // self.dp_size
            est = estimate_train_step_hbm(
                self.model_config, cfg, local_rows, mels[-1],
                phons[-1], n_params=sum(p.numel() for p in self.state.model.parameters()))
            hbm = live_hbm_bytes() or DEFAULT_HBM_BYTES
            if not est.fits(hbm, margin=0.95):
                logger.warning("Estimated training-step memory exceeds the card (%.2f GiB "
                               "estimated vs %.2f GiB available): %s; consider a smaller "
                               "batch, gradient_checkpointing or use_flash_attention (see "
                               "kokoro-plan)", est.total_bytes / 1024**3, hbm / 1024**3,
                               est.summary())
            else:
                logger.info("HBM plan: %s", est.summary())
        except Exception as err:  # planning never blocks training
            logger.warning("memory preflight skipped: %s", err)

    def _batch_quantum(self) -> int:
        return effective_batch_quantum(self.config.batch_size_multiple,
                                       self.config.max_batch_size, self.dp_size)

    def _setup_state(self) -> None:
        cfg = self.config
        batches_per_epoch = max(1, len(self.batcher.build_batches(0)))
        steps_per_epoch = max(1, -(-batches_per_epoch // max(1, cfg.gradient_accumulation_steps)))
        self.total_steps = cfg.num_epochs * steps_per_epoch
        self.ema_decay = (cfg.ema_decay if cfg.ema_decay is not None
                          else recommended_ema_decay(steps_per_epoch, cfg.ema_half_life_epochs))
        logger.info("Schedule: %d opt-steps/epoch, %d total; EMA decay %.6f",
                    steps_per_epoch, self.total_steps, self.ema_decay)
        model_config = self.model_config
        if model_config.use_flash_attention and (self.sp_size > 1 or self.pp_size > 1):
            # the reference's routing (kokoro_tpu/training/trainer.py:409-425)
            logger.info("use_flash_attention disabled: %d-way seq x %d-way pipeline "
                        "parallelism partitions attention via SPMD einsum instead",
                        self.sp_size, self.pp_size)
            model_config = dataclasses.replace(model_config, use_flash_attention=False)
        model = KokoroModel(model_config).init_weights(torch.Generator().manual_seed(cfg.seed))
        if self._init_params is not None:
            model.load_state_dict(self._init_params, strict=True)
        model = model.to(self.device)
        self.state = create_train_state(model, cfg, self.total_steps, self.mesh)
        self.preclips = build_preclip_norms(self.state.names, cfg)
        self.eval_step = make_eval_step(model, cfg, self.mesh)
        self._train_steps: Dict[bool, object] = {}
        self.metadata = build_model_metadata(self.model_config, cfg,
                                             self.phoneme_processor.get_vocab_size())

    def _train_step(self, spec_augment: bool):
        if spec_augment not in self._train_steps:
            make = make_train_step
            if self.pp_size > 1:  # the accumulation microbatches are the pipeline's
                from kokoro_tpu_torch.parallel.pp_step import make_pp_train_step as make
            self._train_steps[spec_augment] = make(
                self.config, self.preclips, self.ema_decay, spec_augment=spec_augment)
        return self._train_steps[spec_augment]

    # -- training ---------------------------------------------------------------
    def train(self) -> Dict[str, float]:
        cfg = self.config
        self.ckpt.save_phoneme_processor(self.phoneme_processor)
        self._maybe_resume()
        for epoch in range(self.start_epoch, cfg.num_epochs):
            t0 = time.time()
            if cfg.enable_profiling and epoch == cfg.profile_epoch_start and self.is_main:
                self._start_trace()
                try:
                    train_metrics = self.train_epoch(epoch)
                finally:
                    self._stop_trace()
            else:
                train_metrics = self.train_epoch(epoch)
            self._log_weight_histograms()
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
            self._report_cache_stats()
        self._save(self.ckpt.save_final_model, cfg.num_epochs - 1)
        self.writer.close()
        if self.mesh is not None:
            self.mesh.barrier()  # the run directory is whole on every rank's return
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
        t_epoch = time.perf_counter()
        ib = self._interbatch = (InterbatchProfiler(cfg.interbatch_report_interval)
                                 if cfg.enable_interbatch_profiling else None)
        for start in range(0, len(batches), accum):
            if ib is not None:
                ib.start(DATA)
            with span("data", self.state.opt_step + self.state.skipped_steps):
                batch = self._assemble(batches[start:start + accum], rng)
                shape_key = (tuple(batch["mel_specs"].shape), 1)
                self._shape_counts[shape_key] = self._shape_counts.get(shape_key, 0) + 1
                device_batch = self._to_device(batch)
            if ib is not None:
                ib.end(DATA)
                ib.start(STEP)
            metrics = step_fn(self.state, device_batch, self.generator)
            if ib is not None:
                ib.end(STEP)
            self.host_step += 1
            if self._trace is not None:
                self._trace_steps_left -= 1
                if self._trace_steps_left <= 0:
                    self._stop_trace()
            if metrics["stepped"]:
                taken += 1
                for k in LOSS_KEYS:
                    sums[k] = sums.get(k, 0.0) + metrics[k]
            else:
                logger.warning("Step skipped (non-finite gradients) at opt step %d",
                               self.host_step)
                self._dump_debug_batch(batch, self.host_step)
            if metrics["total"] > 10.0:
                logger.warning("Total loss %.2f > 10 at opt step %d: divergence suspected "
                               "(losses are clamped, not reset)", metrics["total"],
                               self.host_step)
            if self.host_step % cfg.log_every_steps == 0:
                self._log_step(metrics, self.host_step)
            if cfg.histogram_every_steps and self.host_step % cfg.histogram_every_steps == 0:
                self._log_train_diagnostics(device_batch, batch, self.host_step)
        if ib is not None:
            elapsed = time.perf_counter() - t_epoch
            n = len(ib.phases.get(STEP, []))
            logger.info("Epoch %d: %d optimizer steps in %.1fs (%.2f steps/s)", epoch + 1, n,
                        elapsed, n / max(elapsed, 1e-9))
            if ib.phases:
                logger.info(ib.report())
        return {k: v / max(taken, 1) for k, v in sums.items()}

    # -- observability ---------------------------------------------------------
    def _start_trace(self) -> None:
        """Open the profiler window for the next ``profile_steps`` steps."""
        self._trace = contextlib.ExitStack()
        self._trace.enter_context(trace(self.output_dir / "profiler_logs"))
        self._trace_steps_left = max(1, self.config.profile_steps)

    def _stop_trace(self) -> None:
        trace_stack, self._trace, self._trace_steps_left = self._trace, None, 0
        if trace_stack is not None:
            trace_stack.close()  # stops the profiler and writes the trace

    def _log_histograms(self, prefix: str, tensors: Dict[str, torch.Tensor], step: int) -> None:
        """One histogram per tensor under ``<prefix>/params/<flax path>``;
        every tensor reaches the host in one copy.  Sharded tensors are
        gathered whole first (every rank calls this; the main one logs)."""
        tensors = gather_tree(tensors, self.state.layout)
        if not self.is_main:
            return
        names = list(tensors)
        flat = torch.cat([tensors[n].detach().reshape(-1).float() for n in names]).cpu().numpy()
        sizes = np.cumsum([tensors[n].numel() for n in names])[:-1]
        for name, values in zip(names, np.split(flat, sizes)):
            self.writer.add_histogram(f"{prefix}/params/{self._flax_names[name]}", values, step)

    def _log_weight_histograms(self) -> None:
        """Per-epoch parameter histograms."""
        try:
            self._log_histograms("weights", self.state.params, self.state.opt_step)
        except Exception as err:  # histograms are best-effort observability
            logger.warning("weight histogram logging failed: %s", err)

    def _log_train_diagnostics(self, device_batch: Dict[str, torch.Tensor],
                               host_batch: Dict[str, np.ndarray], step: int) -> None:
        """The diagnostic step on the first microbatch: gradient histograms,
        the train spectral convergence, the train pred/GT spectrogram images
        and, under ``verbose``, the duration diagnostics."""
        try:
            if self._diag_step is None:
                self._diag_step = make_diagnostic_step(self.state.model, self.config,
                                                       self.state.layout)
            if device_batch["mel_specs"].dim() == 4:
                device_batch = {k: v[0] for k, v in device_batch.items()}
                host_batch = {k: v[0] for k, v in host_batch.items()}
            out, losses, grads = self._diag_step(device_batch)
            self._log_histograms("gradients", grads, step)
            if not self.is_main:
                return
            self.writer.add_scalar("metrics/train_spectral_convergence",
                                   float(losses["spectral_convergence"]), step)
            if self.config.verbose:
                self._log_duration_diagnostics(
                    out["predicted_log_durations"].float().cpu().numpy(), host_batch, step)
            t = int(host_batch["mel_lengths"][0])
            self.writer.add_image("spectrogram/train_predicted", _mel_image(
                out["predicted_mel"][0, :t].float().cpu().numpy()), step)
            self.writer.add_image("spectrogram/train_ground_truth",
                                  _mel_image(host_batch["mel_specs"][0, :t]), step)
        except Exception as err:  # diagnostics are best-effort observability
            logger.warning("train diagnostics logging failed: %s", err)

    def _log_duration_diagnostics(self, pred_log_dur: np.ndarray,
                                  micro: Dict[str, np.ndarray], step: int) -> None:
        """Duration predictions against the targets, and the mask counts."""
        L = micro["phoneme_indices"].shape[-1]
        valid = np.arange(L)[None, :] < micro["phoneme_lengths"][:, None]
        pred = pred_log_dur[valid]
        targ = np.log1p(micro["phoneme_durations"].astype(np.float32))[valid]
        pred, targ = pred[np.isfinite(pred)], targ[np.isfinite(targ)]

        def stats(x):
            return (x.mean(), x.std(), x.min(), x.max()) if x.size else (math.nan,) * 4

        logger.info("Duration pred @%d: mean=%.4f std=%.4f min=%.4f max=%.4f | target: "
                    "mean=%.4f std=%.4f min=%.4f max=%.4f | phoneme mask positions=%d, "
                    "duration_valid positions=%d", step, *stats(pred), *stats(targ),
                    int(valid.sum()), int((valid & (micro["phoneme_durations"] > 0)).sum()))

    def _dump_debug_batch(self, batch: Dict[str, np.ndarray], step: int) -> None:
        """The host batch (the main rank's rows) of a step skipped for
        non-finite gradients."""
        if not self.is_main:
            return
        try:
            path = self.output_dir / f"debug_batch_step_{step}.npz"
            np.savez_compressed(path, **batch)
            logger.warning("Dumped offending batch to %s", path)
        except Exception as err:
            logger.warning("debug batch dump failed: %s", err)

    def _log_val_spectrograms(self, shown) -> None:
        """Predicted and ground-truth validation spectrogram images of the
        first batch, and the distributions of the predicted log-durations,
        pitch and energy pooled over the shown batches: ``(host batch,
        device batch, outputs)`` of the validation forwards (EMA parameters)."""
        try:
            step = self.state.opt_step
            hist: Dict[str, List[np.ndarray]] = {"log_durations": [], "pitch": [], "energy": []}
            for i, (batch, device_batch, out) in enumerate(shown):
                text_pad, mel_pad = batch_masks(device_batch)
                if i == 0:
                    t = int(batch["mel_lengths"][0])
                    self.writer.add_image("spectrogram/val_predicted", _mel_image(
                        out["predicted_mel"][0, :t].float().cpu().numpy()), step)
                    self.writer.add_image("spectrogram/val_ground_truth",
                                          _mel_image(batch["mel_specs"][0, :t]), step)
                hist["log_durations"].append(
                    out["predicted_log_durations"][~text_pad].float().cpu().numpy())
                if out["predicted_pitch"] is not None:
                    frame_ok = ~mel_pad[:, :out["predicted_pitch"].shape[1]]
                    hist["pitch"].append(out["predicted_pitch"][frame_ok].float().cpu().numpy())
                    hist["energy"].append(
                        out["predicted_energy"][frame_ok].float().cpu().numpy())
            for key, chunks in hist.items():
                if chunks:
                    self.writer.add_histogram(f"val_predictions/{key}", np.concatenate(chunks),
                                              step)
        except Exception as err:  # images are best-effort observability
            logger.warning("val spectrogram logging failed: %s", err)

    def _report_cache_stats(self) -> None:
        stats = self.train_dataset.cache_stats()
        if stats["requests"]:
            logger.info("Feature cache: %.1f%% hit rate (%d requests: %d mem / %d disk hits, "
                        "%d entries = %.1f MB in RAM, latency mem %.3f ms / disk %.3f ms)",
                        stats["hit_rate"] * 100, stats["requests"], stats["mem_hits"],
                        stats["disk_hits"], stats["memory_entries"], stats["memory_mb"],
                        stats["mem_latency_ms"], stats["disk_latency_ms"])

    def _log_step(self, metrics: Dict[str, float], step: int) -> None:
        for k in LOSS_KEYS:
            self.writer.add_scalar(f"loss/{k}", metrics[k], step)
        self.writer.add_scalar("stats/grad_norm", metrics["grad_norm"], step)
        self.writer.add_scalar("stats/grad_norm_clipped", metrics["grad_norm_clipped"], step)
        for label, tag in LR_TAGS:
            self.writer.add_scalar(tag, self.state.optimizer.lr(label), step)

    def _forced_dims(self, dataset, indices: List[int]) -> Dict[str, int]:
        """Under data or sequence parallelism, the padded T and L of a global
        batch from its length metadata (the reference's forced dims), so that
        every rank pads alike without seeing the others' features, T a
        multiple of the ``seq`` axis (``max_seq_length`` is one, as the
        config checks the bucket ladder); {} otherwise."""
        if self.dp_size <= 1 and self.sp_size <= 1:
            return {}
        cfg = self.config
        est = [dataset.lengths(i) for i in indices]
        T = max((t for t, _ in est), default=1)
        if cfg.use_speed_perturbation and dataset.is_training:
            # perturbation can lengthen audio by up to 1/(1-range)
            T = int(T / max(1.0 - cfg.speed_perturb_range, 0.5)) + 2
        T = round_up_to_multiple(T, self.sp_size)
        return {"pad_mel_to": min(T, cfg.max_seq_length),
                "pad_phoneme_to": max((n for _, n in est), default=1)}

    def _local_rows(self, indices: List[int], rows: int) -> List[int]:
        """This rank's contiguous block of a batch padded to ``rows`` rows;
        the ranks of one ``model`` group take the same block."""
        if self.dp_size <= 1:
            return indices
        return indices[process_local_rows(rows, self.dp_size, self.mesh.index("data"))]

    def _assemble(self, group: List[List[int]], rng: np.random.Generator
                  ) -> Dict[str, np.ndarray]:
        """Collate index-batches to one ``(B, ...)`` batch, or ``(A, B, ...)``
        for A > 1 accumulated batches padded to common buckets; the batch
        dimension rounds up to the batch quantum (padding rows are masked).
        Under data parallelism only this rank's rows (``B / dp_size`` of
        them), under sequence parallelism the seq rank's window of their
        frames."""
        cfg, n_mels = self.config, self.model_config.n_mels
        out_B = round_up_to_multiple(max(len(g) for g in group), self._batch_quantum())
        forced = self._forced_dims(self.train_dataset, [i for g in group for i in g])
        group = [self._local_rows(g, out_B) for g in group]
        collated = [collate([self.train_dataset.get_features(i, rng) for i in indices], cfg,
                            n_mels, pad_batch_to=out_B // self.dp_size, **forced)
                    for indices in group]
        if len(collated) == 1:
            return seq_window(collated[0], self.mesh)
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

        collated = [seq_window(grow(c), self.mesh) for c in collated]
        return {k: np.stack([c[k] for c in collated]) for k in collated[0]}

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    # -- validation ---------------------------------------------------------------
    def validate_epoch(self, epoch: int) -> Dict[str, float]:
        """Validation on the EMA parameters (reference trainer.py:1771-1910):
        fixed-size batches padded to ``batch_size`` rows (a multiple of the
        data-parallel degree), each rank its row block, the metrics the
        global batch's."""
        cfg = self.config
        rng = np.random.default_rng(0)
        sums: Dict[str, float] = {}
        n = 0
        shown = []  # (host batch, device batch, outputs) of the first 4 batches
        val_B = round_up_to_multiple(cfg.batch_size, self.dp_size)
        for indices in self.val_batcher.build_batches(0):
            forced = self._forced_dims(self.val_dataset, indices)
            feats = [self.val_dataset.get_features(i, rng)
                     for i in self._local_rows(indices, val_B)]
            batch = seq_window(collate(feats, cfg, self.model_config.n_mels,
                                       pad_batch_to=val_B // self.dp_size, **forced),
                               self.mesh)
            device_batch = self._to_device(batch)
            metrics, out = self.eval_step(device_batch, params=self.state.ema,
                                          with_outputs=True)
            if len(shown) < 4:
                shown.append((batch, device_batch, out))
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
            n += 1
        if shown and self.is_main:
            self._log_val_spectrograms(shown)
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
        self._purge_stale_events()
        logger.info("Resumed at epoch %d (opt step %d, best val %.4f)", self.start_epoch,
                    self.state.opt_step, self.best_val_loss)

    def _purge_stale_events(self) -> None:
        """Drop the log records past the restored step (reference
        trainer.py:1616-1632), so the resumed series stay monotonic and free
        of duplicates.  The step scalars are logged at ``host_step``, the
        epoch scalars at the optimizer step, which is never larger.  The
        writer is closed around the rewrite."""
        from kokoro_tpu_torch.training.tb_events import purge_events_after

        if not self.is_main:
            return
        try:
            self.writer.flush()
            self.writer.close()
            purge_events_after(self.output_dir / "logs", self.host_step)
        except Exception as err:  # never fail a resume over log hygiene
            logger.warning("Log event purge failed: %s", err)
        finally:
            self.writer = self._new_writer()


def train_model(model_config: KokoroConfig, config: TrainingConfig,
                device: str | torch.device = "cuda") -> Dict[str, float]:
    """Entry point (the reference's ``train_model``): train, checkpoint and
    write the final model into ``config.output_dir``.  ``device`` defaults to
    CUDA and raises without it; tests pass ``"cpu"``."""
    return KokoroTrainer(model_config, config, device).train()
