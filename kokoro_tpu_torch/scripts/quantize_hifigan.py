"""Quantize a trained HiFi-GAN to int8 and measure what it costs.

Port of ``scripts/quantize_hifigan.py``.  Loads the f32 ``.npz`` that
``train_hifigan`` wrote (``inference/vocoder.py::load_hifigan_npz``), writes
it as symmetric per-output-channel int8 with f32 biases
(``export_hifigan_npz(quantize="int8")``, the reference's arrays and
scales), loads that back (dequantized) and measures the round-trip mel L1
over the first ``--segments`` of ``train_hifigan.build_segment_bank``, for
the f32 and the int8 generator side by side, and the largest relative
weight error over the leaves (max |a - b| / (max |a| + 1e-12), in float32).
The JSON has the reference's keys, the card's name and power limit, and
whether cuDNN TF32 was on (on a card it is, as in serving and training).

    python -m kokoro_tpu_torch.scripts.quantize_hifigan --src /tmp/hifigan_v1.npz \\
        --out /tmp/hifigan_v1_int8.npz --metrics /tmp/hifigan_v1_int8.json \\
        [--corpus DIR] [--segments 64] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from kokoro_tpu_torch.scripts.train_hifigan import TMP


def max_rel_weight_err(a: Mapping[str, np.ndarray], b: Mapping[str, np.ndarray]) -> float:
    """max over the leaves of max |a - b| / (max |a| + 1e-12), each leaf's
    ratio in float32 as the reference computes it."""
    f32 = np.float32
    return max(float(f32(np.max(np.abs(a[k] - b[k]))) / (f32(np.max(np.abs(a[k]))) + f32(1e-12)))
               for k in sorted(a))


def load_generator(params: Mapping[str, np.ndarray], cfg, device: torch.device):
    """A ``HiFiGANGenerator`` in eval mode on ``device`` holding flat flax
    ``params``."""
    from kokoro_tpu_torch.convert import hifigan_state_dict_from_flax
    from kokoro_tpu_torch.models.hifigan import HiFiGANGenerator

    generator = HiFiGANGenerator(cfg)
    generator.load_state_dict(hifigan_state_dict_from_flax(params), strict=True)
    return generator.to(device).eval()


def run(args) -> Dict:
    """Quantize, reload, evaluate; writes ``args.metrics`` and returns the
    payload."""
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.inference.vocoder import export_hifigan_npz, load_hifigan_npz
    from kokoro_tpu_torch.models.hifigan import HiFiGANConfig
    from kokoro_tpu_torch.scripts.quality_run import payload_device
    from kokoro_tpu_torch.scripts.train_hifigan import (
        build_segment_bank, ensure_corpus, roundtrip_mel_l1, training_numerics,
    )

    device = resolve_device(args.device)
    src = Path(args.src)
    params_f32, cfg = load_hifigan_npz(src)
    cfg = cfg or HiFiGANConfig()
    gen_f32 = load_generator(params_f32, cfg, device)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    export_hifigan_npz(gen_f32, out, config=cfg, quantize="int8")
    params_q, _ = load_hifigan_npz(out)
    gen_q = load_generator(params_q, cfg, device)

    corpus = Path(args.corpus)
    ensure_corpus(corpus, 48)
    mel_bank, _ = build_segment_bank(corpus)
    mels = torch.from_numpy(mel_bank[: args.segments]).to(device)

    t0 = time.time()
    with training_numerics(device):
        l1_f32 = roundtrip_mel_l1(gen_f32, mels)
        l1_int8 = roundtrip_mel_l1(gen_q, mels)
    werr = max_rel_weight_err(params_f32, params_q)
    payload = {
        "src": str(src),
        "out": str(out),
        "src_mb": round(src.stat().st_size / 1e6, 2),
        "out_mb": round(out.stat().st_size / 1e6, 2),
        "segments": int(mels.shape[0]),
        "mel_l1_f32": round(l1_f32, 4),
        "mel_l1_int8": round(l1_int8, 4),
        "mel_l1_delta": round(l1_int8 - l1_f32, 5),
        "max_rel_weight_err": round(werr, 5),
        "eval_seconds": round(time.time() - t0, 1),
        "device": payload_device(device),
        "tf32": {"cudnn": True, "cublas": False} if device.type == "cuda" else None,
    }
    metrics_path = Path(args.metrics)
    metrics_path.parent.mkdir(parents=True, exist_ok=True)
    metrics_path.write_text(json.dumps(payload, indent=1))
    print(json.dumps(payload), flush=True)
    return payload


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=str(TMP / "hifigan_v1.npz"))
    ap.add_argument("--out", default=str(TMP / "hifigan_v1_int8.npz"))
    ap.add_argument("--metrics", default=str(TMP / "hifigan_v1_int8.json"))
    ap.add_argument("--corpus", default=str(TMP / "kokoro_quality_torch" / "corpus"))
    ap.add_argument("--segments", type=int, default=64,
                    help="held-out segments for the mel-L1 eval")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
