"""Train the HiFi-GAN V1 generator as a mel inverter on the synthetic corpus.

Port of ``scripts/train_hifigan.py``.  No discriminator: the loss is the
paper's mel-spectrogram reconstruction term plus a multi-resolution STFT
magnitude term (phase-insensitive), ``45 * mel_l1 + stft_l1``.  The corpus
is cropped into non-overlapping 64-frame (16384-sample) ``(mel, wav)``
segments (:func:`build_segment_bank`) that stay resident on the device;
each optimizer step draws ``--batch`` of them (:func:`batch_indices`).

* Generator: ``models/hifigan.py::HiFiGANGenerator`` at
  ``upsample_initial_channel=--channels`` (512: universal V1, 13.93 M
  parameters), f32 parameters, initialised by the port's own init (torch's
  default convolution init) from seed 0.
* Optimizer: AdamW (b1 0.8, b2 0.99, eps 1e-8, weight decay 1e-4, decay on
  every tensor, as ``optax.adamw``) on optax's
  ``warmup_cosine_decay_schedule(0, lr, 100, max(steps, 101), 0.05 * lr)``
  (:func:`lr_schedule`, evaluated at the update's pre-increment count).
* Batches: step ``s`` draws its indices from a ``torch.Generator`` seeded
  with ``(42 << 32) + s`` on the host.  The reference's ``fold_in`` stream
  is JAX's and is not reproduced; at equal indices the steps agree.
* ``--scan-steps`` is the interval of the history rows: a row holds the
  last step of each interval, as the reference logs the last step of each
  ``lax.scan`` chunk, and the run ends at the first interval end at or past
  ``--steps``.  The scan packing itself is XLA dispatch machinery; the port
  takes one step per call and reads the losses back once per interval.
* Numerics on the card: cuDNN runs the convolutions with TF32 on (as the
  serving vocoder does) and ``cudnn.benchmark`` on; cuBLAS TF32 stays off
  (the mel filterbank product is f32).  Both are set for the run only.

At the end the generator is written with
``inference/vocoder.py::export_hifigan_npz`` and segment 0 is vocoded as a
self-check (its round-trip mel L1 over 64 frames).  The metrics JSON has the
reference's keys and, beside them, the card's name and power limit, the
step time (over the run, and after the first interval, which pays cuDNN's
autotuning), the peak allocated device memory, and a step's operations
(:func:`step_flops`) with their time at the card's TF32 peak.

    python -m kokoro_tpu_torch.scripts.train_hifigan --steps 2000 \\
        --channels 512 --out /tmp/hifigan_v1.npz --metrics /tmp/hifigan_train.json \\
        [--corpus DIR] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given.  A corpus that
``--corpus`` does not hold yet is built by the port's ``quality_run.build_corpus``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

SR = 22050
HOP = 256
SEGMENT_FRAMES = 64          # 64 mel frames -> 16384-sample crops
SEGMENT_SAMPLES = SEGMENT_FRAMES * HOP
# log_mel_spectrogram(w, sample_rate, n_fft, hop, win, n_mels, f_min, f_max)
MEL_ARGS = (SR, 1024, HOP, 1024, 80, 0.0, 8000.0)
STFT_RESOLUTIONS = ((512, 128), (2048, 512))
MEL_WEIGHT = 45.0
WARMUP_STEPS = 100
TF32_PEAK = 495e12  # H100 SXM dense TF32 operations a second (NVIDIA's data sheet)
INIT_SEED = 0
BATCH_SEED = 42
TMP = Path(tempfile.gettempdir())


def build_segment_bank(corpus: Path, max_segments: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Crop every corpus WAV (sorted by name) into non-overlapping
    ``(mel (64, 80), wav (16384,))`` pairs, at most ``max_segments``.

    The mel is ``ops/stft.log_mel_spectrogram`` of the whole utterance, on
    the CPU.  Its centred frames pad by ``n_fft // 2``, so the segments come
    from the interior: ``wav[k*HOP : k*HOP + SEGMENT_SAMPLES]`` pairs with
    ``mel[k : k + 64]``; an utterance of ``n`` samples gives
    ``(n - SEGMENT_SAMPLES) // SEGMENT_SAMPLES`` segments."""
    from kokoro_tpu_torch.data.audio_io import read_wav
    from kokoro_tpu_torch.ops.stft import log_mel_spectrogram

    mels, wavs = [], []
    for wav_path in sorted((Path(corpus) / "wavs").glob("*.wav")):
        sr, audio = read_wav(wav_path)
        assert sr == SR, (wav_path, sr)
        with torch.no_grad():
            mel = log_mel_spectrogram(torch.from_numpy(audio), *MEL_ARGS).numpy()
        n_seg = (len(audio) - SEGMENT_SAMPLES) // SEGMENT_SAMPLES
        for s in range(n_seg):
            k = s * SEGMENT_FRAMES
            wavs.append(audio[k * HOP : k * HOP + SEGMENT_SAMPLES])
            mels.append(mel[k : k + SEGMENT_FRAMES])
            if len(mels) >= max_segments:
                break
        if len(mels) >= max_segments:
            break
    return np.stack(mels), np.stack(wavs)


def multires_stft_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum over the (n_fft, hop) resolutions (512, 128) and (2048, 512) of
    the mean |log(|P|^2 + 1e-7) - log(|T|^2 + 1e-7)|: the phase-insensitive
    half of the Parallel-WaveGAN / HiFi-GAN auxiliary loss."""
    from kokoro_tpu_torch.ops.stft import stft_power

    total = pred.new_zeros(())
    for n_fft, hop in STFT_RESOLUTIONS:
        p = stft_power(pred, n_fft, hop, n_fft)
        t = stft_power(target, n_fft, hop, n_fft)
        total = total + torch.mean(torch.abs(torch.log(p + 1e-7) - torch.log(t + 1e-7)))
    return total


def loss_fn(generator: torch.nn.Module, mel: torch.Tensor, wav: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(45 * mel_l1 + stft_l1, mel_l1, stft_l1)`` of the generator on a
    batch: the mel L1 between the log-mels of the vocoded and the true
    waveform (all 65 centred frames), and :func:`multires_stft_l1`."""
    from kokoro_tpu_torch.ops.stft import log_mel_spectrogram

    pred = generator(mel)
    mel_l1 = torch.mean(torch.abs(log_mel_spectrogram(pred, *MEL_ARGS)
                                  - log_mel_spectrogram(wav, *MEL_ARGS)))
    stft_l1 = multires_stft_l1(pred, wav)
    return MEL_WEIGHT * mel_l1 + stft_l1, mel_l1, stft_l1


def lr_schedule(lr: float, steps: int) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, lr, 100, max(steps, 101),
    0.05 * lr)`` as a function of the update count: linear from 0 to ``lr``
    over 100 steps, then a cosine over ``max(steps, 101) - 100`` steps down
    to ``0.05 * lr``, constant after it.  The arithmetic is optax's, in
    float32 and in its order (the warm-up as ``(0 - lr) * (1 - n/100) +
    lr``); the cosine is rounded from double precision."""
    f32 = np.float32
    decay_steps = f32(max(steps, WARMUP_STEPS + 1) - WARMUP_STEPS)
    alpha = (lr * 0.05) / lr

    def schedule(count: int) -> float:
        if count < WARMUP_STEPS:
            frac = f32(1.0) - f32(count) / f32(WARMUP_STEPS)
            return float(f32(0.0 - lr) * frac + f32(lr))
        t = min(f32(count - WARMUP_STEPS), decay_steps)
        cosine = f32(0.5) * (f32(1.0) + f32(math.cos(float(f32(math.pi) * t / decay_steps))))
        return float(f32(lr) * (f32(1.0 - alpha) * cosine + f32(alpha)))

    return schedule


def make_optimizer(generator: torch.nn.Module, lr: float, steps: int):
    """``(AdamW, LambdaLR)``: optax's ``adamw(schedule, b1=0.8, b2=0.99,
    weight_decay=1e-4)`` on every parameter; the scheduler's factor is the
    learning rate itself (the optimizer's base rate is 1)."""
    opt = torch.optim.AdamW(generator.parameters(), lr=1.0, betas=(0.8, 0.99), eps=1e-8,
                            weight_decay=1e-4, foreach=True)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule(lr, steps))


def batch_indices(step: int, batch: int, segments: int, seed: int = BATCH_SEED) -> torch.Tensor:
    """The segment indices step ``step`` trains on, drawn uniformly from a
    host ``torch.Generator`` seeded with ``(seed << 32) + step``."""
    gen = torch.Generator().manual_seed((seed << 32) + step)
    return torch.randint(0, segments, (batch,), generator=gen)


def one_step(generator: torch.nn.Module, optimizer, scheduler, mel: torch.Tensor,
             wav: torch.Tensor) -> torch.Tensor:
    """One optimizer step on a batch; returns ``[loss, mel_l1, stft_l1]``
    detached, on the batch's device (no host read)."""
    optimizer.zero_grad(set_to_none=True)
    loss, mel_l1, stft_l1 = loss_fn(generator, mel, wav)
    loss.backward()
    optimizer.step()
    scheduler.step()
    return torch.stack([loss, mel_l1, stft_l1]).detach()


def init_generator(channels: int, seed: int = INIT_SEED):
    """``(HiFiGANGenerator, HiFiGANConfig)`` at ``upsample_initial_channel
    = channels``, initialised by torch's default init from ``seed`` (the
    process's own random stream is left as it was)."""
    from kokoro_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator

    cfg = HiFiGANConfig(upsample_initial_channel=channels)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        generator = HiFiGANGenerator(cfg)
    return generator, cfg


@torch.no_grad()
def step_flops(generator: torch.nn.Module, mel: torch.Tensor) -> float:
    """Operations of a training step on ``mel``: twice the multiply-adds of
    the generator's convolutions (a ``Conv1d`` does ``in x k`` a output
    element, a ``ConvTranspose1d`` ``out x k`` an input element), times 3
    for the forward and the backward's input and weight gradients."""
    total = 0

    def count(module, inputs, output):
        nonlocal total
        k = module.kernel_size[0]
        if isinstance(module, torch.nn.ConvTranspose1d):
            total += 2 * inputs[0].numel() * module.out_channels * k
        else:
            total += 2 * output.numel() * module.in_channels * k

    handles = [m.register_forward_hook(count) for m in generator.modules()
               if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d))]
    try:
        generator(mel)
    finally:
        for handle in handles:
            handle.remove()
    return 3.0 * total


@torch.no_grad()
def roundtrip_mel_l1(generator: torch.nn.Module, mels: torch.Tensor) -> float:
    """Mean |log-mel(vocoded) - mel| over segments ``mels (S, 64, 80)``: a
    centred STFT of a segment gives 65 frames, of which the first 64 align
    with the segment's mel."""
    from kokoro_tpu_torch.ops.stft import log_mel_spectrogram

    got = log_mel_spectrogram(generator(mels), *MEL_ARGS)[:, :SEGMENT_FRAMES]
    return float(torch.mean(torch.abs(got - mels)))


def training_numerics(device: torch.device):
    """The run's numerics: on a card, cuDNN TF32 and autotuning on and
    cuBLAS TF32 off, restored afterwards; on the CPU nothing changes."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                                   deterministic=False, allow_tf32=True))
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    stack.callback(setattr, torch.backends.cuda.matmul, "allow_tf32", previous)
    return stack


def ensure_corpus(corpus: Path, utts: int) -> None:
    """Build the quality run's synthetic corpus at ``corpus`` unless it has
    a ``metadata.csv``."""
    if not (corpus / "metadata.csv").exists():
        from kokoro_tpu_torch.scripts.quality_run import build_corpus

        print(f"building corpus ({utts} utts) at {corpus}", flush=True)
        build_corpus(corpus, utts)


def run(args) -> Dict:
    """Train, export and self-check; writes ``args.metrics`` and returns the
    payload."""
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.inference.vocoder import export_hifigan_npz
    from kokoro_tpu_torch.scripts.quality_run import payload_device

    device = resolve_device(args.device)
    corpus = Path(args.corpus)
    ensure_corpus(corpus, args.utts)

    t0 = time.time()
    mel_bank, wav_bank = build_segment_bank(corpus)
    print(f"segment bank: {mel_bank.shape[0]} segments of {SEGMENT_FRAMES} "
          f"frames ({time.time() - t0:.1f}s)", flush=True)

    generator, gen_cfg = init_generator(args.channels)
    generator.to(device).train()
    n_params = sum(p.numel() for p in generator.parameters())
    print(f"HiFi-GAN V1 generator: {n_params / 1e6:.1f}M params", flush=True)
    optimizer, scheduler = make_optimizer(generator, args.lr, args.steps)
    mels_d = torch.from_numpy(mel_bank).to(device)
    wavs_d = torch.from_numpy(wav_bank).to(device)
    S = mel_bank.shape[0]
    n_steps = -(-args.steps // args.scan_steps) * args.scan_steps
    indices = torch.stack([batch_indices(s, args.batch, S) for s in range(n_steps)]).to(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    history: List[Dict] = []
    with training_numerics(device):
        t0 = time.time()
        for start in range(0, n_steps, args.scan_steps):
            for step in range(start, start + args.scan_steps):
                idx = indices[step]
                metrics = one_step(generator, optimizer, scheduler, mels_d[idx], wavs_d[idx])
            m = metrics.tolist()  # one host read per interval
            if start == 0:  # cuDNN's autotuning and the first calls
                first_s = time.time() - t0
            history.append({"step": start + args.scan_steps, "loss": m[0], "mel_l1": m[1],
                            "stft_l1": m[2]})
            if len(history) % 8 == 1:
                print(f"step {history[-1]['step']}: loss {m[0]:.3f} mel_l1 {m[1]:.4f} "
                      f"stft_l1 {m[2]:.3f} ({time.time() - t0:.0f}s)", flush=True)
        train_s = time.time() - t0

        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        export_hifigan_npz(generator, out, config=gen_cfg)
        # self-check: vocode segment 0 and compare its mel over 64 frames
        generator.eval()
        check = roundtrip_mel_l1(generator, mels_d[:1])
        flops = step_flops(generator, mels_d[indices[0]])
    payload = {
        "steps": args.steps, "batch": args.batch, "segments": int(S),
        "params_m": round(n_params / 1e6, 2),
        "train_seconds": round(train_s, 1),
        "final": history[-1], "roundtrip_mel_l1": check,
        "history": history[:: max(1, len(history) // 40)],
        "weights": str(out),
        "device": payload_device(device),
        "channels": args.channels,
        "optimizer_steps": n_steps,
        "ms_per_step": train_s * 1e3 / n_steps,
        "first_interval_s": round(first_s, 2),
        # after the first interval, which pays the autotuning
        "steady_ms_per_step": ((train_s - first_s) * 1e3 / (n_steps - args.scan_steps)
                               if n_steps > args.scan_steps else None),
        "step_tflop": flops / 1e12,
        # the least time of a step on the card: its convolutions at the TF32 peak
        "tf32_bound_ms": flops / TF32_PEAK * 1e3,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "tf32": ({"cudnn": True, "cublas": False} if device.type == "cuda" else None),
        "nonfinite_history_rows": sum(not all(math.isfinite(r[k]) for k in
                                              ("loss", "mel_l1", "stft_l1")) for r in history),
    }
    metrics_path = Path(args.metrics)
    metrics_path.parent.mkdir(parents=True, exist_ok=True)
    metrics_path.write_text(json.dumps(payload, indent=1))
    print(json.dumps({k: payload[k] for k in
                      ("steps", "train_seconds", "final", "roundtrip_mel_l1")}), flush=True)
    return payload


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scan-steps", type=int, default=25,
                    help="interval of the history rows (the reference's scan chunk)")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--utts", type=int, default=48)
    ap.add_argument("--channels", type=int, default=512,
                    help="upsample_initial_channel: 512 = universal_v1; 128 = compact")
    ap.add_argument("--corpus", default=str(TMP / "kokoro_quality_torch" / "corpus"))
    ap.add_argument("--out", default=str(TMP / "hifigan_v1.npz"))
    ap.add_argument("--metrics", default=str(TMP / "hifigan_train.json"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
