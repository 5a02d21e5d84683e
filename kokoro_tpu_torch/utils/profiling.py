"""Profiling tools: device traces, the port's spans and counters,
interbatch phases, step timing and the bf16/f32 A/B.

Port of ``kokoro_tpu/utils/profiling.py`` on PyTorch:

* :func:`trace` — ``torch.profiler`` CPU and CUDA activity into a Chrome
  trace (Perfetto, TensorBoard's profiler plugin);
* :func:`span` — a ``kokoro.<name>`` range on the profiler's timeline where
  the work happens (the training step's phases, the model's parts, the data
  path), free when no profiler runs;
* :func:`counters` — the batches and frames ``collate`` gave and the calls
  of the attention entries by shape, as plain counts;
* :class:`InterbatchProfiler` — wall-clock phase times, the reference's API,
  its phases named as the trainer's spans;
* :func:`profile_step_fn` — step times that end in a device synchronise;
* :func:`compare_dtype_policies` / :func:`profile_dtype_for_config` — the
  bf16-against-f32 step-time A/B that ``kokoro-train --profile-dtypes``
  runs before training.

The spans (each ``kokoro.<name>``; those of a training step carry its host
ordinal, ``opt_step + skipped_steps`` at entry, as the range's one input,
seen where the session records shapes, all but the model's parts, which
sit inside ``forward``):

* ``train_step`` (``training/train_step.py::make_train_step``'s step), and
  in it ``forward`` (a microbatch's losses; in it ``encoder``, ``variance``,
  ``decoder`` and ``loss``), ``backward`` (``torch.autograd.grad``; its
  launches come from the autograd engine's own thread) and ``optimizer``
  (everything after the gradients; in it ``clip``, ``host_read`` and
  ``update``, which holds ``ema``);
* ``plan`` (``FrameBudgetBatcher.build_batches``), ``collate`` and ``data``
  (the trainer's assembly and copy of a step's batch).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import statistics
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

from kokoro_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def _activities():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


def init_profiler() -> None:
    """Start and stop the profiler once, on the calling thread.  The
    profiler's backend initialises on the thread that imported torch; a
    first start from another thread (an HTTP handler's) leaves it
    uninitialised, so a server that will trace from its handlers calls this
    from the main thread first."""
    with torch.profiler.profile(activities=_activities()):
        pass


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Trace the enclosed work, CPU and (when there is a card) CUDA
    activity, into ``logdir/<worker>.<time>.pt.trace.json``: a Chrome trace
    that Perfetto and TensorBoard's profiler plugin open.  Yields the
    ``torch.profiler.profile``."""
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
        activities=_activities(),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir)),
    ) as prof:
        yield prof


# -- spans -------------------------------------------------------------------
SPAN_PREFIX = "kokoro."
DATA = SPAN_PREFIX + "data"
STEP = SPAN_PREFIX + "train_step"
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def _range(name: str, inputs: tuple):
    # record_function's own ``args`` is a string, which the profiler keeps
    # empty among an event's inputs; this entry keeps an int
    handle = torch.autograd._record_function_with_args_enter(name, *inputs)
    try:
        yield
    finally:
        torch.autograd._record_function_with_args_exit(handle)


def span(name: str, args: Optional[int] = None):
    """``with span(name, args):`` records ``kokoro.<name>`` on the running
    ``torch.profiler`` session's host timeline, beside the device activity
    it launches, with ``args`` (a step's ordinal) as its one input.  With no
    session it returns one shared no-op context after one read of the
    profiler's enabled flag: no range, no device work, no synchronise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _range(SPAN_PREFIX + name, () if args is None else (args,))


# -- counters -----------------------------------------------------------------
# the serving thread and the trainer's may count at once
_counts_lock = threading.Lock()
_batches = {"batches": 0, "frames_true": 0, "frames_padded": 0}
_attention: Dict[Tuple, int] = {}


def count_batch(frames_true: int, frames_padded: int) -> None:
    """One collated batch: its true (unpadded) mel frames and rows x padded T."""
    with _counts_lock:
        _batches["batches"] += 1
        _batches["frames_true"] += frames_true
        _batches["frames_padded"] += frames_padded


def count_attention(kind: str, B: int, T: int, H: int, Dh: int, dtype: torch.dtype,
                    causal: bool, grad: bool) -> None:
    """One call of an attention entry (``kind``: ``packed`` or ``flash``)."""
    key = (kind, B, T, H, Dh, dtype, causal, grad)
    with _counts_lock:
        _attention[key] = _attention.get(key, 0) + 1


def counters() -> Dict:
    """A snapshot: ``batches``, ``frames_true``, ``frames_padded`` of
    ``collate``, and ``attention``: calls by ``(kind, B, T, H, Dh, dtype,
    causal, grad)``, the dtype's name without ``torch.``."""
    with _counts_lock:
        attention = {k[:5] + (str(k[5]).replace("torch.", ""),) + k[6:]: n
                     for k, n in _attention.items()}
        return dict(_batches, attention=attention)


def reset_counters() -> None:
    with _counts_lock:
        for k in _batches:
            _batches[k] = 0
        _attention.clear()


def _synchronize() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class InterbatchProfiler:
    """Wall-clock phase profiler.  The trainer's phases are named as its
    spans, :data:`DATA` and :data:`STEP` (which the trainer and the step
    open themselves); a report is logged every ``report_interval`` ends of
    :data:`STEP`."""

    def __init__(self, report_interval: int = 100):
        self.report_interval = report_interval
        self.phases: Dict[str, List[float]] = {}
        self._marks: Dict[str, float] = {}
        self._count = 0

    def start(self, phase: str) -> None:
        self._marks[phase] = time.perf_counter()

    def end(self, phase: str) -> None:
        t0 = self._marks.pop(phase, None)
        if t0 is None:
            return
        self.phases.setdefault(phase, []).append(time.perf_counter() - t0)
        if phase == STEP:
            self._count += 1
            if self.report_interval and self._count % self.report_interval == 0:
                logger.info(self.report())

    def report(self) -> str:
        lines = [f"{phase}: mean {statistics.mean(times) * 1e3:.1f}ms "
                 f"median {statistics.median(times) * 1e3:.1f}ms n={len(times)}"
                 for phase, times in sorted(self.phases.items()) if times]
        return "interbatch profile: " + "; ".join(lines)


def profile_step_fn(step_fn: Callable, args: tuple, n_steps: int = 10,
                    warmup: int = 2) -> Dict[str, float]:
    """Times of ``step_fn(*args)``, each ending in a device synchronise."""
    for _ in range(warmup):
        step_fn(*args)
    _synchronize()
    times = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        step_fn(*args)
        _synchronize()
        times.append(time.perf_counter() - t0)
    return {
        "mean_s": statistics.mean(times),
        "median_s": statistics.median(times),
        "min_s": min(times),
        "max_s": max(times),
        "steps_per_s": 1.0 / statistics.mean(times),
    }


def compare_dtype_policies(make_step: Callable[[str], tuple],
                           n_steps: int = 10) -> Dict[str, Dict[str, float]]:
    """bf16-vs-f32 A/B: ``make_step(dtype) -> (step_fn, args)``."""
    results = {}
    for dtype in ("bfloat16", "float32"):
        step_fn, args = make_step(dtype)
        results[dtype] = profile_step_fn(step_fn, args, n_steps)
    speedup = results["float32"]["mean_s"] / results["bfloat16"]["mean_s"]
    logger.info("bf16 speedup vs fp32: %.2fx", speedup)
    results["speedup_bf16"] = {"value": speedup}
    return results


def dtype_ab_batch(n_mels: int, device) -> Dict[str, torch.Tensor]:
    """The reference's synthetic A/B batch: B=8, L=64, T=512 from
    ``numpy.random.default_rng(0)``, every phoneme 8 frames."""
    import numpy as np

    B, L, T = 8, 64, 512
    rng = np.random.default_rng(0)
    batch = {
        "phoneme_indices": rng.integers(1, 60, (B, L)).astype(np.int32),
        "stress_indices": rng.integers(0, 3, (B, L)).astype(np.int32),
        "phoneme_durations": np.full((B, L), T // L, np.int32),
        "mel_specs": rng.normal(size=(B, T, n_mels)).astype(np.float32),
        "pitch_targets": rng.uniform(size=(B, T)).astype(np.float32),
        "energy_targets": rng.uniform(size=(B, T)).astype(np.float32),
        "stop_token_targets": np.zeros((B, T), np.float32),
        "mel_lengths": np.full((B,), T, np.int32),
        "phoneme_lengths": np.full((B,), L, np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def profile_dtype_for_config(model_config, config, n_steps: int = 5,
                             device: str | torch.device = "cuda",
                             results: Dict | None = None) -> str:
    """Pre-train bf16-vs-f32 A/B on the configured widths; returns the faster
    compute dtype.  The model takes the reference's fixed list of fields
    (vocabulary 64, the widths, ``qk_norm``; no remat, no stochastic depth)
    and leaves every other field at its default: ``use_flash_attention`` is
    off, so both dtypes run the plain attention route (matmul and softmax,
    attention-weight dropout from HBM masks), whatever the caller's config
    routes.  ``results``, when given, receives :func:`compare_dtype_policies`'
    readings."""
    from kokoro_tpu_torch.config import KokoroConfig
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step

    dev = resolve_device(device)
    batch = dtype_ab_batch(model_config.n_mels, dev)

    def make_step(dtype: str):
        cfg = dataclasses.replace(config, compute_dtype=dtype, gradient_checkpointing=False)
        mcfg = KokoroConfig(
            vocab_size=64, n_mels=model_config.n_mels, hidden_dim=model_config.hidden_dim,
            n_encoder_layers=model_config.n_encoder_layers,
            n_decoder_layers=model_config.n_decoder_layers, n_heads=model_config.n_heads,
            encoder_ff_dim=model_config.encoder_ff_dim,
            decoder_ff_dim=model_config.decoder_ff_dim, qk_norm=model_config.qk_norm,
            use_stochastic_depth=False)
        model = KokoroModel(mcfg).init_weights(torch.Generator().manual_seed(0)).to(dev)
        state = create_train_state(model, cfg, total_steps=1000)
        step = make_train_step(cfg, build_preclip_norms(state.names, cfg), 0.999)
        gen = torch.Generator().manual_seed(0)
        return (lambda: step(state, batch, gen)), ()

    out = compare_dtype_policies(make_step, n_steps=n_steps)
    if results is not None:
        results.update(out)
    return "bfloat16" if out["speedup_bf16"]["value"] >= 1.0 else "float32"
