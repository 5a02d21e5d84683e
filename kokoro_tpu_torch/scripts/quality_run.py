"""Quality run: train the flagship model on a synthetic corpus and record
its learning curves.

Port of ``scripts/quality_run.py``.  Builds a seeded utterance-like corpus
(:func:`build_corpus`, byte for byte the reference's), trains the flagship
configuration (512 hidden, 6+6 layers, bf16) through ``KokoroTrainer`` in two
phases, the second resumed from ``auto`` after ``epochs // 2`` epochs, and
writes per-epoch train/val losses, spectral convergence and F0 RMSE to
``<out>/quality_run_metrics.json`` and ``<out>/QUALITY_RUN.md``
(``--long``: ``quality_run_long_metrics.json``, ``QUALITY_RUN_LONG.md``).
``--long`` trains every utterance at the 1408-frame bucket with the decoder's
self-attention through K4 (``ops/flash_attention.py``) and checks that K4 was
launched at every step and no step was skipped.  ``--flash-attention`` (the
port's option, off in the reference's runs) sends the default regime's
decoder attention through the packed kernels: K1 and K2 with in-kernel
attention dropout and their backward; the run checks that every step
launched K1.

    python -m kokoro_tpu_torch.scripts.quality_run [--long | --flash-attention] \\
        --epochs N --utts N --out DIR [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given.  Beside the reference's
keys the JSON carries the card's name and power limit, the wall time, the
peak allocated device memory, the bytes the run directory holds and each
kernel's launches per step.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

WORDS = [
    "привет", "мир", "как", "дела", "всё", "хорошо", "говорит", "москва",
    "сегодня", "завтра", "погода", "ясная", "ветер", "слабый", "дождь",
    "вечером", "утром", "новости", "слушайте", "внимательно", "спасибо",
    "пожалуйста", "конечно", "возможно", "правда", "работа", "время",
]


def build_corpus(root: Path, n_utts: int, seed: int = 11, long_mode: bool = False) -> None:
    """Utterance-like synthetic speech: a harmonic source with per-word f0
    moves and a noise burst at each word's onset, words separated by short
    pauses, so duration, pitch and energy targets follow the text.  Each
    utterance is padded or trimmed to 4.4 s (``long_mode``: 16.34 s, the
    1408-frame bucket) and written as ``wavs/q{i:04d}.wav`` with its line in
    ``metadata.csv``; the draws follow the reference's order exactly."""
    from kokoro_tpu_torch.data.audio_io import save_wav

    wavs = Path(root) / "wavs"
    wavs.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    sr = 22050
    lines = []
    for i in range(n_utts):
        # long mode: 18-30 words, about 9-15 s of speech padded to 16.34 s
        n_words = int(rng.integers(18, 31) if long_mode else rng.integers(6, 12))
        text_words = list(rng.choice(WORDS, size=n_words))
        base_f0 = float(rng.uniform(100, 200))
        pieces = []
        for w in text_words:
            dur = 0.12 + 0.05 * len(w) + float(rng.uniform(0, 0.08))
            n = int(sr * dur)
            t = np.arange(n) / sr
            # word-level pitch contour: declination + random accent
            f0 = base_f0 * (1.0 + 0.2 * rng.standard_normal()) * (1.0 - 0.1 * t / max(dur, 1e-6))
            phase = 2 * np.pi * np.cumsum(f0) / sr
            voiced = 0.5 * np.sin(phase) + 0.25 * np.sin(2 * phase) + 0.12 * np.sin(3 * phase)
            burst_n = int(0.25 * n)  # consonant-like noise at the word onset
            noise = np.zeros(n)
            noise[:burst_n] = 0.2 * rng.standard_normal(burst_n)
            env = np.minimum(1.0, np.arange(n) / (0.02 * sr))
            env *= env[::-1]
            pieces.append((voiced + noise) * env)
            pieces.append(np.zeros(int(sr * rng.uniform(0.02, 0.08))))
        audio = np.concatenate(pieces)
        target = int((16.34 if long_mode else 4.4) * sr)
        if audio.shape[0] < target:
            audio = np.pad(audio, (0, target - audio.shape[0]))
        audio = audio[:target]
        audio += 0.01 * rng.standard_normal(audio.shape[0])
        audio = (0.8 * audio / np.abs(audio).max()).astype(np.float32)
        save_wav(wavs / f"q{i:04d}.wav", audio, sr)
        lines.append(f"q{i:04d}|{' '.join(text_words)}")
    (Path(root) / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")


def config_overrides(corpus: Path, run_dir: Path, epochs: int, long_mode: bool,
                     flash_attention: bool = False) -> Dict:
    """The reference's configuration of the run, as ``get_default_config``
    overrides.  Its ``scan_steps=1`` (``--long``) has no counterpart: scan
    chunks are XLA dispatch machinery, and the port takes one step per
    call.  ``flash_attention`` (not the reference's) sends the default
    regime's decoder attention through the packed kernels (K1, K2 and their
    backward, attention dropout drawn in the kernel), which the reference's
    default regime runs as plain matmuls."""
    base = dict(
        data_dir=str(corpus), output_dir=str(run_dir), num_epochs=epochs, use_mfa=False,
        use_speed_perturbation=False, validation_split=0.1, save_every=2, keep_checkpoints=50,
        warmup_steps=min(200, epochs * 10), log_every_steps=10, max_frames_per_batch=20000,
        max_batch_size=12, resume_checkpoint="auto",
        # one closed bucket table: 4.4 s of audio -> at most 380 mel frames
        max_seq_length=384, mel_bucket_sizes=(384,), phoneme_bucket_sizes=(96, 128),
    )
    if flash_attention:
        base["use_flash_attention"] = True
    if long_mode:
        # every sequence at 1408 frames, the decoder's self-attention through
        # K4 (which needs dropout-free attention weights), no remat
        base.update(
            max_seq_length=1408, mel_bucket_sizes=(1408,), phoneme_bucket_sizes=(256,),
            max_frames_per_batch=18000, max_batch_size=12, batch_size_multiple=12,
            use_flash_attention=True, attention_weight_dropout=False,
            gradient_checkpointing=False,
        )
    return base


def history_row(epoch: int, step: int, train: Dict[str, float], val: Dict[str, float]) -> Dict:
    """One row of the learning curve, the reference's keys and rounding."""
    return {
        "epoch": epoch + 1, "step": int(step),
        "train_total": round(train.get("total", 0.0), 5),
        "train_mel": round(train.get("mel", 0.0), 5),
        "val_total": round(val.get("total", 0.0), 5),
        "val_mel": round(val.get("mel", 0.0), 5),
        "val_duration": round(val.get("duration", 0.0), 5),
        "val_stop": round(val.get("stop", 0.0), 5),
        "spectral_convergence": round(val.get("spectral_convergence", 0.0), 5),
        "f0_rmse": round(val.get("f0_rmse", 0.0), 5),
    }


def kernel_launches() -> Dict[str, int]:
    """Launches so far of every attention-kernel wrapper of the port."""
    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import fused_attention as fa

    return {kern.name: kern.launches for kern in fa.KERNELS + fl.KERNELS}


def recording_trainer(history: List[Dict], steps: List[Dict], validations: List[Dict]):
    """A ``KokoroTrainer`` subclass that appends a history row at each
    validation (the epoch's train means are ``train_epoch``'s return), one
    record per optimizer step to ``steps`` (its epoch, the optimizer step it
    started from, the step it logs at, its metrics, the kernel launches it
    made, its microbatches and its wall time in ms, synchronised on a card)
    and the kernel launches and batches of each validation to
    ``validations``; it keeps the optimizer step a resume restored as
    ``resumed_step``."""
    from kokoro_tpu_torch.training.trainer import KokoroTrainer

    def launched(before):
        return {k: v - before[k] for k, v in kernel_launches().items() if v > before[k]}

    class RecordingTrainer(KokoroTrainer):
        _train_means: Dict[str, float] = {}
        resumed_step = None

        def _maybe_resume(self):
            super()._maybe_resume()
            if self.start_epoch:
                self.resumed_step = self.state.opt_step

        def train_epoch(self, epoch):
            self._epoch = epoch + 1
            self._train_means = super().train_epoch(epoch)
            return self._train_means

        def _train_step(self, spec_augment):
            step = super()._train_step(spec_augment)
            sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)

            def recorded(state, batch, generator):
                sync()
                before, opt_step, t0 = kernel_launches(), state.opt_step, time.perf_counter()
                metrics = step(state, batch, generator)
                sync()
                steps.append({"epoch": self._epoch, "opt_step": opt_step,
                              "logged_step": self.host_step + 1, "metrics": metrics,
                              "launches": launched(before),
                              "microbatches": (batch["mel_specs"].shape[0]
                                               if batch["mel_specs"].dim() == 4 else 1),
                              "ms": (time.perf_counter() - t0) * 1e3})
                return metrics

            return recorded

        def validate_epoch(self, epoch):
            before = kernel_launches()
            metrics = super().validate_epoch(epoch)
            validations.append({"epoch": epoch + 1, "launches": launched(before),
                                "batches": len(self.val_batcher.build_batches(0))})
            history.append(history_row(epoch, self.state.opt_step, self._train_means, metrics))
            return metrics

    return RecordingTrainer


def run(args) -> Dict:
    """Build the corpus (unless ``<out>/corpus`` holds one), train in two
    phases, write the JSON and the markdown table under ``args.out``; returns
    ``{"payload", "steps", "validations", "run_dir"}`` (the JSON written and
    the per-step and per-validation records)."""
    from kokoro_tpu_torch.config import get_default_config
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.ops.flash_attention import flash_attention_fwd
    from kokoro_tpu_torch.ops.fused_attention import packed_attention_causal

    device = resolve_device(args.device)
    out = Path(args.out)
    corpus, run_dir = out / "corpus", out / "run"
    if not (corpus / "metadata.csv").exists():
        print(f"building corpus ({args.utts} utterances{', long mode' if args.long else ''})...")
        build_corpus(corpus, args.utts, long_mode=args.long)

    def make_cfg(num_epochs):
        overrides = config_overrides(corpus, run_dir, args.epochs, args.long,
                                     args.flash_attention)
        overrides["num_epochs"] = num_epochs
        return get_default_config(**overrides)

    history: List[Dict] = []
    steps: List[Dict] = []
    validations: List[Dict] = []
    RecordingTrainer = recording_trainer(history, steps, validations)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    half = max(args.epochs // 2, 1)
    t0 = time.time()
    print(f"phase 1: epochs 1..{half}")
    trainer = RecordingTrainer(*make_cfg(half), device=device)
    trainer.train()
    step_at_break = trainer.state.opt_step
    del trainer

    print(f"phase 2: resume -> epochs {half + 1}..{args.epochs}")
    trainer = RecordingTrainer(*make_cfg(args.epochs), device=device)
    result = trainer.train()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    assert trainer.state.opt_step > step_at_break, "resume did not continue"
    skipped = trainer.state.skipped_steps
    k4 = flash_attention_fwd.name
    k4_per_step = [s["launches"].get(k4, 0) for s in steps]
    launches_per_step = {name: sorted({s["launches"].get(name, 0) for s in steps})
                         for name in kernel_launches()}
    if args.long:
        assert skipped == 0, f"{skipped} steps skipped in the long run"
    if device.type == "cuda":  # on the CPU the attention runs its plain version
        if args.long:
            assert min(k4_per_step) > 0, (
                "a long-sequence step did not launch K4 (the flash-attention kernel)")
        elif args.flash_attention:
            k1 = packed_attention_causal.name
            assert min(s["launches"].get(k1, 0) for s in steps) > 0, (
                "a step did not launch K1 (the packed causal kernel)")

    total_frames = sum(trainer.train_dataset.lengths(i)[0]
                       for i in range(len(trainer.train_dataset)))
    checkpoint = run_dir / "checkpoint_epoch_2"
    payload = {
        "config": ("flagship default + long-seq regime (1408 frames, flash, no remat)"
                   if args.long else "flagship default (512 hidden, 6+6 layers)"
                   + (", decoder attention through the packed kernels"
                      if args.flash_attention else "")),
        "corpus": f"synthetic, {args.utts} utterances, {total_frames} train mel-frames/epoch",
        "epochs": args.epochs,
        "resume_break_after_epoch": half,
        "resume_continued_from_step": step_at_break,
        "wall_seconds": round(wall, 1),
        "best_val_mel": result["best_val_loss"],
        "best_val_epoch": int(result["best_val_epoch"]) + 1,
        "skipped_steps": skipped,
        # the reference counts traces of its flash program; the port counts
        # launches of K4's forward wrapper over the run's optimizer steps
        "flash_trace_count": sum(k4_per_step),
        "history": history,
        "device": payload_device(device),
        "resumed_at_step": trainer.resumed_step,
        "optimizer_steps": trainer.state.opt_step,
        "k4_launches_per_step": sorted(set(k4_per_step)),
        "launches_per_step": launches_per_step,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None),
        "run_dir_bytes": _dir_bytes(run_dir),
        "checkpoint_bytes": _dir_bytes(checkpoint) if checkpoint.exists() else None,
    }
    del trainer
    metrics_name = "quality_run_long_metrics.json" if args.long else "quality_run_metrics.json"
    (out / metrics_name).write_text(json.dumps(payload, indent=2))

    title = ("# Long-sequence quality run (1408 frames, flash attention live)" if args.long
             else "# Quality-evidence run")
    extra = ([f"Every sequence trains at the 1408-frame bucket with K4 in the decoder's "
              f"self-attention ({sum(k4_per_step)} K4 forward launches), {skipped} skipped "
              f"steps, remat off.", ""] if args.long else [])
    lines = [
        title, "",
        "Flagship config (512 hidden, 6+6 layers, bf16) on a synthetic",
        f"{args.utts}-utterance corpus ({total_frames} train mel-frames/epoch),",
        f"{args.epochs} epochs with a checkpoint-resume break after epoch {half}",
        f"(run continued from optimizer step {step_at_break}).", "",
        *extra,
        "Generated by `python -m kokoro_tpu_torch.scripts.quality_run`; raw numbers in",
        f"`{metrics_name}`.", "",
        "| epoch | step | train mel | val mel | val dur | val stop | spec-conv | F0 RMSE |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for h in history:
        lines.append(f"| {h['epoch']} | {h['step']} | {h['train_mel']} | {h['val_mel']} "
                     f"| {h['val_duration']} | {h['val_stop']} "
                     f"| {h['spectral_convergence']} | {h['f0_rmse']} |")
    mels = [h["val_mel"] for h in history]
    lines += [
        "",
        f"Best val mel **{min(mels):.4f}** (epoch {mels.index(min(mels)) + 1}); "
        f"first->last val mel {mels[0]:.4f} -> {mels[-1]:.4f}.",
        f"Wall time {wall / 60:.1f} min on {payload['device']}.",
    ]
    doc_name = "QUALITY_RUN_LONG.md" if args.long else "QUALITY_RUN.md"
    (out / doc_name).write_text("\n".join(lines) + "\n")
    print(f"wrote {out / doc_name} (best val mel {min(mels):.4f})")
    return {"payload": payload, "steps": steps, "validations": validations, "run_dir": run_dir}


def payload_device(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def _dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--utts", type=int, default=384)
    p.add_argument("--out", default=str(Path(tempfile.gettempdir()) / "kokoro_quality_torch"))
    p.add_argument("--long", action="store_true",
                   help="long-sequence regime: 1408-frame sequences, K4 in training "
                        "(writes QUALITY_RUN_LONG.md)")
    p.add_argument("--flash-attention", action="store_true",
                   help="default regime: the decoder's attention through the packed kernels "
                        "(K1, K2, in-kernel attention dropout); the reference runs plain matmuls")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
