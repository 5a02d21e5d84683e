"""Benchmark: training throughput in mel-frames/sec/chip on the flagship model.

Port of the repository's ``bench.py``.  Prints ONE JSON line with the
reference's keys: ``metric``, ``value``, ``unit``, ``vs_baseline``,
``end_to_end``, ``end_to_end_vs_baseline`` and, from the end-to-end phase,
``buckets``, ``shape_steps`` and ``padding_efficiency``.

* **compute-only** (:func:`bench_compute_only`): the model and step of
  ``get_high_performance_config`` (bf16 compute on f32 parameters, the
  decoder's attention through the packed kernels K1/K2 and their backward
  with attention-weight dropout drawn in the kernel, no remat) at vocabulary
  128, seeded random weights, on one resident batch B=32, L=96, T=512 from
  ``numpy.random.default_rng(0)`` (``scripts/bench_step_shapes.py``'s
  ``synthetic_batch``).  The optimizer spans 20000 steps, the EMA decays at
  0.999.  The port has no ``make_multi_step``: one call is K=16 calls of
  ``make_train_step``'s step (each with its own host read of the metrics),
  ended by a device synchronise.  2 warm calls, then the best of 4 timed
  calls; ``value`` = B * T * K / best.  Each call draws its dropout from a
  ``torch.Generator`` seeded per call (the reference's ``PRNGKey(100 + i)``
  warm and ``fold_in(key, i)`` timed).
* **end-to-end** (:func:`bench_end_to_end`): real epochs through the port's
  ``KokoroTrainer`` (dataset, G2P, feature cache, frame-budget batcher,
  collate, the step) over :func:`_build_bench_corpus`'s 480 utterances, on
  the reference's overrides.  One warm epoch fills the feature cache; then
  ``measured_epochs`` epochs are timed, each ended by a device synchronise,
  and the phase reports the train split's true (unpadded) frames over the
  fastest of them, with the trainer's shape census over the measured epochs.

The end-to-end phase runs under a SIGALRM budget
(``KOKORO_BENCH_E2E_BUDGET_S``, default 2700 s) so that the compute-only
number always prints.  A failed or timed-out end-to-end phase prints
``end_to_end: 0.0``, as the reference does, and the command exits 1.  The
reference's retries of its remote compiler's transport are not ported: a
retry would hide a failure.

    python -m kokoro_tpu_torch.bench [--device cuda|cpu] [--out FILE] [--work DIR]

``--out`` also writes the payload with the card's name and power limit;
``--work`` holds the corpus and the trainer's output (default: a temporary
directory, removed at the end).  Baseline (BASELINE.md): the reference
trainer's ~18k mel-frames/s on Apple MPS; ``vs_baseline`` is value / 18000.
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import math
import os
import shutil
import signal
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

BASELINE_FRAMES_PER_SEC = 18000.0  # BASELINE.md derived MPS reference
VOCAB = 128
# the compute-only phase's batch and steps a call (the reference's K)
B, L, T, K = 32, 96, 512, 16
WARM_CALLS, TIMED_CALLS = 2, 4


class E2ETimeout(Exception):
    """Raised by the SIGALRM budget guard around the e2e phase."""


def _build_bench_corpus(root: Path, seed: int = 7) -> None:
    """The reference's synthetic RUSLAN-layout corpus, byte for byte: 480
    utterances in three duration clusters (224 of 2.80-3.55 s with 6 words,
    160 of 4.90-5.80 s with 12, 96 of 8.70-10.10 s with 19), each a two-
    harmonic tone plus noise, normalised to peak 1, written as
    ``wavs/b{i:04d}.wav`` with its line in ``metadata.csv``; the draws follow
    the reference's order exactly."""
    from kokoro_tpu_torch.data.audio_io import save_wav

    wavs = root / "wavs"
    wavs.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    words = [
        "привет", "мир", "как", "дела", "всё", "хорошо", "говорит", "москва",
        "сегодня", "завтра", "погода", "ясная", "ветер", "слабый", "дождь",
        "вечером", "утром", "новости", "слушайте", "внимательно",
    ]
    # (count, dur_lo_s, dur_hi_s, words) -> mel buckets 256-320 / 432-512 / 784-896
    clusters = [
        (224, 2.80, 3.55, 6),
        (160, 4.90, 5.80, 12),
        (96, 8.70, 10.10, 19),
    ]
    lines = []
    i = 0
    for count, lo, hi, n_words in clusters:
        for _ in range(count):
            dur_s = float(rng.uniform(lo, hi))
            n = int(22050 * dur_s)
            t = np.arange(n) / 22050.0
            f0 = rng.uniform(90, 220)
            audio = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.15 * np.sin(
                2 * np.pi * 2 * f0 * t
            )
            audio += 0.05 * rng.standard_normal(n)
            audio = (audio / np.abs(audio).max()).astype(np.float32)
            save_wav(wavs / f"b{i:04d}.wav", audio, 22050)
            text = " ".join(rng.choice(words, size=n_words))
            lines.append(f"b{i:04d}|{text}")
            i += 1
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")


def e2e_overrides(corpus: Path, output_dir: Path) -> Dict:
    """The reference's ``get_high_performance_config`` overrides of the
    end-to-end phase: nine mel buckets (three per duration cluster), three
    phoneme buckets, rows of up to 32 under a 16384-frame budget (B=32 up
    to T=512, B=16 at T >= 784), no validation, saves or step logs inside
    the bench.  Its ``scan_steps=2`` is dropped (scan chunks are XLA
    dispatch machinery; the port takes one step per call), as are the
    preset's other XLA-only fields, which the port's preset does not have:
    ``prng_impl``, ``batch_transfer_dtype``, ``host_prefetch_workers``,
    ``metric_drain_chunks`` and ``pad_tail_steps``."""
    return dict(
        data_dir=str(corpus),
        output_dir=str(output_dir),
        num_epochs=5,
        use_mfa=False,
        use_speed_perturbation=False,  # perturbation bypasses the cache
        validation_split=0.05,
        validation_interval=10**9,     # never validate inside the bench
        save_every=10**9,
        log_every_steps=10**9,
        warmup_steps=10,
        max_seq_length=896,
        mel_bucket_sizes=(256, 288, 320, 432, 464, 512, 784, 848, 896),
        phoneme_bucket_sizes=(64, 96, 160),
        max_batch_size=32,
        max_frames_per_batch=16384,
        histogram_every_steps=0,
    )


def census_summary(shape_counts: Dict[tuple, int], total_frames: int,
                   epochs: int) -> Tuple[Dict[str, int], float]:
    """The reference's reading of the trainer's census: ``shape_steps``
    keyed ``B{b}xT{t}xk{k}`` (b, t the shape's third- and second-last
    dimensions) and the padding efficiency, the true frames of ``epochs``
    epochs over the padded frames the steps carried, to 3 places."""
    shape_steps = {}
    padded_frames = 0
    for (shape, scan_k), steps in sorted(shape_counts.items()):
        b, t = shape[-3], shape[-2]
        shape_steps[f"B{b}xT{t}xk{scan_k}"] = steps
        padded_frames += b * t * steps
    eff = total_frames * epochs / max(padded_frames, 1)
    return shape_steps, round(eff, 3)


def e2e_trainer(tmp_root: Path, device: torch.device, **overrides):
    """The end-to-end phase's ``KokoroTrainer`` over the nine-bucket corpus
    under ``tmp_root`` (built there unless it exists), its output under
    ``tmp_root / "bench_out"``; ``overrides`` go on top of
    :func:`e2e_overrides`."""
    from kokoro_tpu_torch.config import get_high_performance_config
    from kokoro_tpu_torch.training.trainer import KokoroTrainer

    corpus = tmp_root / "bench_corpus_v3"
    if not (corpus / "metadata.csv").exists():
        _build_bench_corpus(corpus)
    model_cfg, cfg = get_high_performance_config(
        **{**e2e_overrides(corpus, tmp_root / "bench_out"), **overrides})
    return KokoroTrainer(model_cfg, cfg, device=device)


def bench_end_to_end(tmp_root: Path, device: torch.device, measured_epochs: int = 6,
                     **overrides) -> dict:
    """Real epochs through :func:`e2e_trainer`'s trainer (``overrides``: the
    tests shrink the widths).  Returns ``{"frames_per_sec", "buckets",
    "shape_steps", "padding_efficiency"}``."""
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("[trainer] %(message)s"))
    trainer_log = logging.getLogger("kokoro_tpu_torch.training.trainer")
    if not any(isinstance(x, logging.StreamHandler) for x in trainer_log.handlers):
        trainer_log.addHandler(handler)
    trainer_log.setLevel(logging.INFO)

    log = lambda *a: print("[e2e]", *a, file=sys.stderr, flush=True)  # noqa: E731
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t_setup = time.perf_counter()
    trainer = e2e_trainer(tmp_root, device, **overrides)
    log(f"trainer setup (corpus included) {time.perf_counter() - t_setup:.1f}s")
    # epoch 0 fills the feature cache (and the allocator, first calls)
    t_warm = time.perf_counter()
    trainer.train_epoch(0)
    sync()
    log(f"warm epoch (cache fill) {time.perf_counter() - t_warm:.1f}s")
    # true (unpadded) frames in one epoch of the train split
    total_frames = sum(trainer.train_dataset.lengths(i)[0]
                       for i in range(len(trainer.train_dataset)))
    trainer._shape_counts = {}
    times = []
    for e in range(1, measured_epochs + 1):
        t0 = time.perf_counter()
        means = trainer.train_epoch(e)
        sync()
        times.append(time.perf_counter() - t0)
        if not math.isfinite(means.get("total", math.nan)):
            raise RuntimeError(f"epoch {e}: non-finite mean loss {means}")
    elapsed = min(times)
    shape_steps, eff = census_summary(trainer._shape_counts, total_frames, measured_epochs)
    log(f"measured epochs {[round(t, 2) for t in times]}s, {total_frames} true frames, "
        f"shapes {shape_steps}, padding efficiency {eff:.2f}")
    return {
        "frames_per_sec": total_frames / elapsed,
        "buckets": len(trainer.config.mel_bucket_sizes),
        "shape_steps": shape_steps,
        "padding_efficiency": eff,
    }


def compute_only_step(device: torch.device, batch_rows: int = B, phonemes: int = L,
                      frames: int = T, **overrides):
    """``(state, train_step, batch)`` of the compute-only phase: the
    throughput preset at vocabulary ``VOCAB`` on seeded random weights, the
    optimizer over 20000 steps, EMA 0.999, the synthetic batch; ``overrides``
    go to ``get_high_performance_config``."""
    from kokoro_tpu_torch.config import get_high_performance_config
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.scripts.bench_step_shapes import synthetic_batch
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step

    model_cfg, config = get_high_performance_config(**{"vocab_size": VOCAB, **overrides})
    batch = synthetic_batch(batch_rows, phonemes, frames, model_cfg.n_mels,
                            model_cfg.vocab_size, device)
    model = KokoroModel(model_cfg).init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model.to(device), config, total_steps=20000)
    train_step = make_train_step(config, build_preclip_norms(state.names, config),
                                 ema_decay=0.999)
    return state, train_step, batch


def bench_compute_only(device: torch.device, batch_rows: int = B, phonemes: int = L,
                       frames: int = T, steps_per_call: int = K, warm_calls: int = WARM_CALLS,
                       timed_calls: int = TIMED_CALLS, **overrides) -> float:
    """Padded mel frames per second of :func:`compute_only_step`'s step on
    its resident batch (module docstring; ``overrides``: the tests shrink
    the widths).  Raises on a non-finite loss."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    state, train_step, batch = compute_only_step(device, batch_rows, phonemes, frames,
                                                 **overrides)

    def call(seed: int) -> float:
        gen = torch.Generator().manual_seed(seed)
        for _ in range(steps_per_call):
            metrics = train_step(state, batch, gen)
        sync()
        return metrics["total"]

    for i in range(warm_calls):
        call(100 + i)
    times = []
    for i in range(timed_calls):
        t0 = time.perf_counter()
        total = call(i)
        times.append(time.perf_counter() - t0)
        if not math.isfinite(total):
            raise RuntimeError(f"compute-only call {i}: non-finite loss {total}")
    best = min(times)  # min-of-N: host jitter only ever adds time
    return batch_rows * frames * steps_per_call / best


def main(argv=None) -> int:
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.scripts.quality_run import payload_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=None, help="also write the payload with the card's name")
    p.add_argument("--work", default=None,
                   help="directory for the corpus and the trainer's output "
                        "(default: a temporary directory, removed at the end)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    frames_per_sec = bench_compute_only(device)
    gc.collect()  # free the compute-only state before the trainer's
    if device.type == "cuda":
        torch.cuda.empty_cache()

    budget_s = int(os.environ.get("KOKORO_BENCH_E2E_BUDGET_S", "2700"))

    def _on_alarm(signum, frame):
        raise E2ETimeout(f"e2e phase exceeded {budget_s}s budget")

    work = Path(args.work) if args.work else Path(tempfile.mkdtemp(prefix="kokoro_bench_"))
    e2e_extra = {}
    try:
        old_handler = signal.signal(signal.SIGALRM, _on_alarm)
        signal.alarm(budget_s)
        try:
            e2e_result = bench_end_to_end(work, device)
            e2e = e2e_result.pop("frames_per_sec")
            e2e_extra = e2e_result
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old_handler)
    except Exception as err:  # never lose the compute-only number
        traceback.print_exc()
        print(f"end-to-end bench failed: {err}", file=sys.stderr, flush=True)
        e2e = 0.0
    finally:
        if not args.work:
            shutil.rmtree(work, ignore_errors=True)

    payload = {
        "metric": "train_mel_frames_per_sec_per_chip",
        "value": round(frames_per_sec, 1),
        "unit": "mel-frames/s",
        "vs_baseline": round(frames_per_sec / BASELINE_FRAMES_PER_SEC, 3),
        "end_to_end": round(e2e, 1),
        "end_to_end_vs_baseline": round(e2e / BASELINE_FRAMES_PER_SEC, 3),
        **e2e_extra,
    }
    print(json.dumps(payload), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "device": payload_device(device),
            "compute_only": f"get_high_performance_config (bf16 compute, f32 params, K1/K2 "
                            f"and the packed backward with attention dropout), vocab {VOCAB}, "
                            f"seeded random weights, B={B} L={L} T={T}, K={K} steps a call, "
                            f"best of {TIMED_CALLS} after {WARM_CALLS} warm calls",
            "end_to_end": "KokoroTrainer on _build_bench_corpus (480 utterances, 9 mel "
                          "buckets), best of 6 epochs after a warm epoch, true frames",
            "payload": payload}, indent=1))
    return 0 if e2e > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
