"""Serving benchmark: end-to-end synthesis real-time factor (RTF).

Port of the repository's ``bench_inference.py``.  Prints ONE JSON line with
the reference's keys: ``metric`` "synthesis_x_realtime", ``value``,
``unit``, ``vs_baseline``, and ``detail``, ``batched`` and ``batched_32``.

RTF = synthesis_time / audio_duration (lower is better); ``value`` is 1/RTF
(x real time, higher is better) of one stream's AR decode plus HiFi-GAN V1.
The reference logs frames/s per utterance with no published number
(BASELINE.md), so ``vs_baseline`` is measured against 1.0x real time.

The model is ``get_default_config``'s at vocabulary 128 on seeded random
weights, no stochastic depth or remat, bf16 compute on f32 parameters
(``scripts/bench_batched_decode.py``'s ``build_model``), decoded by the
port's eager ``models/generator.py::generate`` from L=128 phonemes drawn
from ``numpy.random.default_rng(0)``.  Every decode is forced to
``max_frames`` frames (``stop_threshold`` 1.1, ``min_len_ratio`` 0,
``min_len_floor`` max_frames - 1, ``max_len_cap`` max_frames); the bench
raises if any row decodes another length.  One warm decode, then the mean
of 3 timed decodes, each ended by a device synchronise.  Griffin-Lim
(``ops/stft.griffin_lim``) at 60 and 30 iterations and HiFi-GAN V1 in bf16
from the committed ``docs/hifigan_v1_int8.npz`` (``hifigan_weights`` names
the file; "random" if it is missing) are each warmed once and timed once.
Then batched decode plus vocoding (in chunks of 8 rows) at 8 and 32 streams.

    python -m kokoro_tpu_torch.bench_inference [--device cuda|cpu] [--out FILE]

``--out`` also writes the payload with the card's name and power limit.
:func:`run` takes other lengths and stream counts (``chip_smoke.py`` runs
128 frames).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

VOCAB, L, MAX_FRAMES = 128, 128, 1024
STREAMS = (8, 32)   # the batched blocks: "batched" (8) and "batched_32"
REPEATS = 3         # timed decodes, averaged
VOCODE_CHUNK = 8    # rows a HiFi-GAN call in the batched blocks
HIFIGAN_WEIGHTS = Path(__file__).resolve().parents[1] / "docs" / "hifigan_v1_int8.npz"


def load_hifigan(device: torch.device, path: Path = HIFIGAN_WEIGHTS):
    """HiFi-GAN V1 in bf16 on ``device`` and the name the payload gives its
    weights: ``trained (<file>)`` from ``path``, or ``random`` (torch's
    initialisation from seed 1) when the file is missing."""
    from kokoro_tpu_torch.convert import hifigan_state_dict_from_flax
    from kokoro_tpu_torch.inference.vocoder import load_hifigan_npz
    from kokoro_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator

    if path.exists():
        params, cfg = load_hifigan_npz(path)
        hifi = HiFiGANGenerator(cfg or HiFiGANConfig())
        hifi.load_state_dict(hifigan_state_dict_from_flax(params))
        name = f"trained ({path.name})"
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            hifi = HiFiGANGenerator(HiFiGANConfig())
        name = "random"
    return hifi.to(device, torch.bfloat16).eval(), name


def run(device: torch.device, max_frames: int = MAX_FRAMES, streams: Sequence[int] = STREAMS,
        repeats: int = REPEATS, **overrides) -> Dict:
    """The payload (module docstring); ``overrides`` go to
    ``get_default_config`` (the tests shrink the widths)."""
    from kokoro_tpu_torch.models.generator import generate
    from kokoro_tpu_torch.ops.stft import griffin_lim
    from kokoro_tpu_torch.scripts.bench_batched_decode import build_model

    model = build_model(device, **overrides)
    config = model.config
    vocab = config.vocab_size
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(0)
    kwargs = dict(stop_threshold=1.1, min_len_ratio=0.0, min_len_floor=max_frames - 1,
                  max_len_cap=max_frames)

    def inputs(rows):
        ph = torch.as_tensor(rng.integers(1, vocab, (rows, L)), dtype=torch.long, device=device)
        st = torch.as_tensor(rng.integers(0, 3, (rows, L)), dtype=torch.long, device=device)
        return ph, st, torch.zeros(rows, L, dtype=torch.bool, device=device)

    def decode(ph, st, pad):
        mel, length, _ = generate(model, ph, st, pad, max_frames, **kwargs)
        sync()
        lengths = [int(n) for n in torch.as_tensor(length).reshape(-1).tolist()]
        if lengths != [max_frames] * ph.shape[0]:
            raise RuntimeError(f"decoded {lengths} frames, not {max_frames} each")
        return mel, lengths

    def timed_decodes(ph, st, pad):
        decode(ph, st, pad)  # warm: allocator, first calls
        t0 = time.perf_counter()
        for _ in range(repeats):
            mel, lengths = decode(ph, st, pad)
        return mel, lengths, (time.perf_counter() - t0) / repeats

    def timed_once(fn, *args):
        out = fn(*args)  # warm
        sync()
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        return out, time.perf_counter() - t0

    hifi, hifi_weights = load_hifigan(device)

    def vocode(mel):
        return hifi(mel.to(torch.bfloat16)).float()

    with torch.inference_mode():
        mel, lengths, decode_s = timed_decodes(*inputs(1))
        n_frames = lengths[0]
        audio_seconds = n_frames * config.hop_length / config.sample_rate
        mel0 = mel[0, :n_frames]
        wav, vocoder_s = timed_once(lambda m: griffin_lim(m, n_iter=60), mel0)
        wav_h, hifigan_s = timed_once(vocode, mel0[None])
        if not (torch.isfinite(wav).all() and torch.isfinite(wav_h).all()):
            raise RuntimeError("non-finite audio from the single stream's vocoders")

        def bench_batched(rows):
            mel_b, len_b, decode_b = timed_decodes(*inputs(rows))
            frames = sum(len_b)
            audio = frames * config.hop_length / config.sample_rate

            def vocode_all():
                return [vocode(mel_b[i:i + VOCODE_CHUNK]) for i in range(0, rows, VOCODE_CHUNK)]

            _, hifi_b = timed_once(vocode_all)
            return decode_b, frames, audio, hifi_b

        batched = {n: bench_batched(n) for n in streams}
        _, gl30_s = timed_once(lambda m: griffin_lim(m, n_iter=30), mel0)

    total_s = decode_s + hifigan_s
    x_realtime = audio_seconds / total_s
    gl_x_realtime = audio_seconds / (decode_s + vocoder_s)

    def batched_block(rows):
        decode_b, frames, audio, hifi_b = batched[rows]
        x_b = audio / (decode_b + hifi_b)
        return {
            "streams": rows,
            "frames_total": frames,
            "audio_s_total": round(audio, 2),
            "decode_s": round(decode_b, 3),
            "hifigan_s": round(hifi_b, 3),
            "x_realtime_aggregate": round(x_b, 2),
            "throughput_vs_single": round(x_b / x_realtime, 2),
        }

    blocks = {("batched" if i == 0 else f"batched_{rows}"): batched_block(rows)
              for i, rows in enumerate(streams)}
    return {
        "metric": "synthesis_x_realtime",
        "value": round(x_realtime, 2),
        "unit": "x realtime (AR decode + HiFi-GAN V1, 1 chip)",
        "vs_baseline": round(x_realtime / 1.0, 2),
        "detail": {
            "hifigan_weights": hifi_weights,
            "frames": n_frames,
            "audio_s": round(audio_seconds, 2),
            "decode_s": round(decode_s, 3),
            "hifigan_s": round(hifigan_s, 3),
            "griffin_lim_s": round(vocoder_s, 3),
            "griffin_lim_30iter_s": round(gl30_s, 3),
            "griffin_lim_x_realtime": round(gl_x_realtime, 2),
            "frames_per_s": round(n_frames / decode_s, 1),
        },
        **blocks,
    }


def main(argv=None) -> int:
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.scripts.quality_run import payload_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=None, help="also write the payload with the card's name")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    payload = run(device)
    print(json.dumps(payload), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "device": payload_device(device),
            "model": f"flagship widths (get_default_config), vocab {VOCAB}, seeded random "
                     f"weights, bf16 compute on f32 parameters, L={L}; HiFi-GAN V1 in bf16",
            "max_frames": MAX_FRAMES, "payload": payload}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
