"""End-to-end audio from a trained run directory with the real vocoder.

Port of ``scripts/e2e_audio_artifact.py``: the run directory's checkpoint ->
G2P -> AR decode -> health checks -> HiFi-GAN (``docs/hifigan_v1_int8.npz``,
the committed universal-V1 weights, unless ``--vocoder`` names others) ->
WAV.  Writes, under the run directory unless told otherwise:

* ``sample_hifigan.wav``, the HiFi-GAN waveform;
* ``e2e_audio.json``, health metrics (duration, peak, RMS, silence
  fraction, spectral centroid, non-finite and clipped samples) of the
  HiFi-GAN and the 60-iteration Griffin-Lim waveform of the same mel, and the
  warm latency of each stage (mel decode, each vocoder), each timed with the
  device synchronised before and after, and the card's name and power
  limit.

A Griffin-Lim fallback of the HiFi-GAN path is a failure, not a result.

    python -m kokoro_tpu_torch.scripts.e2e_audio_artifact --model RUN_DIR \\
        [--text ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

DEFAULT_VOCODER = Path(__file__).resolve().parents[2] / "docs" / "hifigan_v1_int8.npz"


def audio_health(wav: np.ndarray, sr: int) -> dict:
    if wav.size == 0:
        return {"empty": True}
    peak = float(np.abs(wav).max())
    rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
    # frame-level silence fraction at -40 dBFS relative to peak
    frame = 512
    n = wav.size // frame
    frames = wav[: n * frame].reshape(n, frame)
    frame_rms = np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=1))
    silent = float(np.mean(frame_rms < peak * 0.01)) if n else 1.0
    spec = np.abs(np.fft.rfft(wav.astype(np.float64)))
    freqs = np.fft.rfftfreq(wav.size, 1.0 / sr)
    centroid = float((spec * freqs).sum() / max(spec.sum(), 1e-9))
    return {
        "seconds": round(wav.size / sr, 3),
        "peak": round(peak, 4),
        "rms": round(rms, 5),
        "silence_fraction": round(silent, 3),
        "spectral_centroid_hz": round(centroid, 1),
        "nonfinite": int((~np.isfinite(wav)).sum()),
        "clipped_fraction": round(float(np.mean(np.abs(wav) > 0.999)), 4),
    }


def _timed(device: torch.device, fn):
    """``(fn(), seconds)`` with the device synchronised before and after."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def run(args) -> dict:
    """Synthesise ``args.text``, write the WAV and the JSON; returns the
    JSON's payload."""
    from kokoro_tpu_torch.data.audio_io import save_wav
    from kokoro_tpu_torch.inference.tts import KokoroTTS
    from kokoro_tpu_torch.inference.vocoder import VocoderManager
    from kokoro_tpu_torch.scripts.quality_run import payload_device

    model = Path(args.model)
    wav_out = Path(args.wav_out or model / "sample_hifigan.wav")
    json_out = Path(args.json_out or model / "e2e_audio.json")
    tts = KokoroTTS(str(model), device=args.device, vocoder_path=args.vocoder,
                    max_len=args.max_len)
    assert tts.vocoder.vocoder_type == "hifigan", (
        f"HiFi-GAN weights not loaded from {args.vocoder}: Griffin-Lim fallback")
    device = tts.device

    # a cold pass pays the first calls; then measure warm
    mel = tts.synthesize_mel(args.text)
    assert mel is not None, "health checks rejected the decoded mel"
    tts.vocoder.mel_to_audio(mel)

    mel, t_mel = _timed(device, lambda: tts.synthesize_mel(args.text))
    wav_h, t_voc_h = _timed(device, lambda: tts.vocoder.mel_to_audio(mel))
    gl = VocoderManager("griffin_lim", sample_rate=tts.sample_rate, n_mels=mel.shape[-1],
                        griffin_lim_iters=60, device=device)
    gl.mel_to_audio(mel)
    wav_g, t_voc_g = _timed(device, lambda: gl.mel_to_audio(mel))

    save_wav(wav_out, wav_h, tts.sample_rate)
    payload = {
        "model": str(model),
        "text": args.text,
        "mel_frames": int(mel.shape[0]),
        "samples": int(wav_h.size),
        "vocoder": Path(args.vocoder).name,
        "device": str(device),
        "card": payload_device(device),
        "hifigan": audio_health(wav_h, tts.sample_rate),
        "griffin_lim": audio_health(wav_g, tts.sample_rate),
        "warm_latency_s": {
            "mel_decode": round(t_mel, 3),
            "vocode_hifigan": round(t_voc_h, 3),
            "vocode_griffin_lim_60it": round(t_voc_g, 3),
            "total_hifigan_path": round(t_mel + t_voc_h, 3),
        },
        "wav": str(wav_out),
    }
    json_out.write_text(json.dumps(payload, indent=1, ensure_ascii=False))
    return payload


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, help="a trainer's run directory")
    ap.add_argument("--text", default="привет мир сегодня хорошая погода")
    ap.add_argument("--vocoder", default=str(DEFAULT_VOCODER), help="HiFi-GAN .npz weights")
    ap.add_argument("--wav-out", default=None, help="default: <model>/sample_hifigan.wav")
    ap.add_argument("--json-out", default=None, help="default: <model>/e2e_audio.json")
    ap.add_argument("--max-len", type=int, default=None, help="cap on the decoded frames")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv)), indent=1, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
