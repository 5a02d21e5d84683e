"""Batched AR-decode scaling sweep: aggregate decode throughput against the
number of concurrent streams on one card, so a serving deployment can pick
its batch size.

Port of ``scripts/bench_batched_decode.py``.  The flagship widths of
``get_default_config`` (hidden 512, 6+6 layers, 8 heads, ff 1536) at
vocabulary 128, seeded random weights, no stochastic depth, bf16 compute on
f32 parameters (the reference's flax ``dtype=bfloat16``), decoded by the
port's eager ``models/generator.py::generate`` (the counterpart of
``make_generate_fn``) from L = 128 phonemes.  Every row decodes exactly
``frames`` frames, forced the reference's way: ``stop_threshold`` 1.1 (a
sigmoid never exceeds it), ``min_len_floor`` frames - 1 and
``max_len_cap`` frames.  Each stream count is decoded once to warm up
(allocator, first calls), then timed three times, best of 3, the device
synchronised at the end of each.  Prints the reference's JSON list of rows
(``streams``, ``decode_s``, ``frames_per_s``, ``ms_per_frame_per_stream``,
``throughput_vs_single``; a row that fails holds ``error``); ``--out``
writes it with the card's name and power limit and the configuration.

    python -m kokoro_tpu_torch.scripts.bench_batched_decode [--out FILE] [--device cuda|cpu]

``sweep(device, streams, frames)`` runs other stream counts and lengths
(``chip_smoke.py`` runs streams 1 and 8 at 64 frames).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

STREAMS = (1, 8, 16, 32, 64)
VOCAB, L, MAX_FRAMES = 128, 128, 1024


def build_model(device: torch.device, **overrides):
    """The flagship model at vocabulary ``VOCAB`` on seeded random weights,
    bf16 compute on f32 parameters, in eval mode; ``overrides`` go to
    ``get_default_config`` (the tests shrink the widths)."""
    from kokoro_tpu_torch.config import get_default_config
    from kokoro_tpu_torch.models.kokoro import KokoroModel

    model_cfg, _ = get_default_config(**{"vocab_size": VOCAB, "use_stochastic_depth": False,
                                         **overrides})
    model = KokoroModel(model_cfg).init_weights(torch.Generator().manual_seed(0))
    return model.to(device).set_compute_dtype(torch.bfloat16).eval()


def sweep(device: torch.device, streams: Sequence[int] = STREAMS, frames: int = MAX_FRAMES,
          repeats: int = 3, **overrides) -> List[Dict]:
    """One row per stream count (see the module docstring)."""
    from kokoro_tpu_torch.models.generator import generate

    model = build_model(device, **overrides)
    vocab = model.config.vocab_size
    kwargs = dict(stop_threshold=1.1, min_len_ratio=0.0, min_len_floor=frames - 1,
                  max_len_cap=frames)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    rng = np.random.default_rng(0)
    results: List[Dict] = []
    single_fps = None
    for B in streams:
        ph = torch.as_tensor(rng.integers(1, vocab, (B, L)), dtype=torch.long, device=device)
        st = torch.as_tensor(rng.integers(0, 3, (B, L)), dtype=torch.long, device=device)
        pad = torch.zeros(B, L, dtype=torch.bool, device=device)
        try:
            mel, length, _ = generate(model, ph, st, pad, frames, **kwargs)
            sync()
            if int(torch.as_tensor(length).min()) != frames:
                raise RuntimeError(f"decoded {length.tolist()} frames, not {frames}")
            times = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                mel, length, _ = generate(model, ph, st, pad, frames, **kwargs)
                sync()
                times.append(time.perf_counter() - t0)
            best = min(times)
            fps = B * frames / best
            if single_fps is None:
                single_fps = fps
            results.append({
                "streams": B,
                "decode_s": round(best, 3),
                "frames_per_s": round(fps, 0),
                "ms_per_frame_per_stream": round(best / frames * 1e3, 3),
                "throughput_vs_single": round(fps / single_fps, 2),
            })
            log(f"B={B:3d}: {best:.3f}s  {fps/1e3:7.1f}k frames/s  "
                f"x{fps/single_fps:.2f} vs single")
        except Exception as err:  # noqa: BLE001 - a row records its failure
            results.append({"streams": B, "error": str(err)[:160]})
            log(f"B={B}: FAILED {err}")
    return results


def main(argv=None) -> int:
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.scripts.quality_run import payload_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=None, help="also write the rows with the card's name")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    results = sweep(device, STREAMS, MAX_FRAMES)
    print(json.dumps(results))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "device": payload_device(device),
            "model": f"flagship widths (get_default_config), vocab {VOCAB}, seeded random "
                     f"weights, bf16 compute on f32 parameters, L={L}",
            "frames": MAX_FRAMES, "rows": results}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
