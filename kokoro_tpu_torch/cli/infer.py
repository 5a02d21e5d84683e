"""kokoro-infer of the PyTorch port: text -> WAV.

    python -m kokoro_tpu_torch.cli.infer --model <run> --text "Привет, мир!" --output out.wav
    python -m kokoro_tpu_torch.cli.infer --model <run> --file lines.txt --batched --output-dir wavs

Port of ``kokoro_tpu/cli/infer.py`` (the same arguments, plus ``--device``):
``<run>`` is a trainer's run directory or a model directory
(``convert.save_model_dir``); ``--file`` writes ``output_{i:04d}.wav`` per
line; ``--profile DIR`` traces the synthesis with ``torch.profiler``.  Runs
on CUDA unless ``--device cpu`` is given, and raises without CUDA.
A model directory that cannot be loaded returns 1.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

logger = logging.getLogger(__name__)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="kokoro-infer-torch",
                                     description="Synthesize Russian speech")
    parser.add_argument("--model", required=True, help="trained run or model directory")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--text", help="text to synthesize")
    parser.add_argument("--file", help="text file: one utterance per line")
    parser.add_argument("--output", default="output.wav")
    parser.add_argument("--output-dir", default="tts_output",
                        help="output directory for --file / --interactive")
    parser.add_argument("--vocoder", choices=("hifigan", "griffin_lim"), default="hifigan")
    parser.add_argument("--vocoder-path", default=None, help="HiFi-GAN weights (.pth or .npz)")
    parser.add_argument("--weights", choices=("auto", "ema", "model"), default="auto")
    parser.add_argument("--max-len", type=int, default=None)
    parser.add_argument("--stop-threshold", type=float, default=None)
    parser.add_argument("--min-len-ratio", type=float, default=None)
    parser.add_argument("--batched", action="store_true",
                        help="file mode: decode single-chunk utterances together "
                             "(one AR decode per phoneme-bucket group)")
    parser.add_argument("--interactive", action="store_true")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="trace the synthesis with torch.profiler into DIR")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(message)s")

    from kokoro_tpu_torch.inference.tts import KokoroTTS

    try:
        tts = KokoroTTS(args.model, device=args.device, vocoder_type=args.vocoder,
                        vocoder_path=args.vocoder_path, use_ema_weights=args.weights,
                        max_len=args.max_len, stop_threshold=args.stop_threshold,
                        min_len_ratio=args.min_len_ratio)
    except (FileNotFoundError, ValueError) as err:
        logger.error("Could not load model from %s: %s", args.model, err)
        return 1
    if not args.profile:
        return _run_synthesis(args, parser, tts)
    from kokoro_tpu_torch.utils.profiling import trace

    with trace(args.profile):
        rc = _run_synthesis(args, parser, tts)
    logger.info("trace written to %s", args.profile)
    return rc


def _run_synthesis(args, parser, tts) -> int:
    if args.interactive:
        out_dir = Path(args.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        print("Enter Russian text (empty line or Ctrl-D to quit):")
        for i, line in enumerate(sys.stdin):
            text = line.strip()
            if not text:
                break
            path = out_dir / f"interactive_{i:03d}.wav"
            tts.text_to_speech(text, str(path))
            print(f"-> {path}")
        return 0
    if args.file:
        texts = [ln.strip() for ln in Path(args.file).read_text(encoding="utf-8").splitlines()
                 if ln.strip()]
        tts.batch_text_to_speech(texts, args.output_dir, batched=args.batched)
        return 0
    if not args.text:
        parser.error("one of --text, --file, --interactive is required")
    tts.text_to_speech(args.text, args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
