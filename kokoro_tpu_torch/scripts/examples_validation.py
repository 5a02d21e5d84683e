"""Validate the README's usage example end to end on a synthetic corpus:
train through the Python API, then synthesise through ``KokoroTTS``.

Port of ``scripts/examples_validation.py``: four short utterances (a sine
per utterance plus seeded noise) in a temporary corpus,
``train_model(*get_smoke_test_config(...), device=...)`` for one epoch in
f32 (the port's ``get_smoke_test_config`` returns the model and the
training config), then ``KokoroTTS(run_dir, vocoder_type="griffin_lim")``
speaks «Привет, мир!» into a WAV.  It asserts the reference's checks: a
finite best validation loss, and a 22050 Hz WAV that is not empty and
finite.

    python -m kokoro_tpu_torch.scripts.examples_validation [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given; prints ``EXAMPLES: PASS``.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

TEXTS = ["привет мир", "как дела", "всё хорошо", "пока"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from kokoro_tpu_torch.config import get_smoke_test_config
    from kokoro_tpu_torch.data.audio_io import read_wav, save_wav
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.inference.tts import KokoroTTS
    from kokoro_tpu_torch.training.trainer import train_model

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = Path(tmp) / "corpus"
        (corpus / "wavs").mkdir(parents=True)
        rng = np.random.default_rng(0)
        lines = []
        for i, text in enumerate(TEXTS):
            t = np.arange(int(22050 * (0.4 + 0.1 * i))) / 22050
            audio = (0.4 * np.sin(2 * np.pi * (140 + 30 * i) * t)).astype(np.float32)
            audio += 0.03 * rng.normal(size=len(t)).astype(np.float32)
            save_wav(corpus / "wavs" / f"e{i}.wav", audio, 22050)
            lines.append(f"e{i}|{text}")
        (corpus / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")

        out = Path(tmp) / "run"
        print("== train_model (README example) ==")
        result = train_model(
            *get_smoke_test_config(
                data_dir=str(corpus), output_dir=str(out), num_epochs=1,
                batch_size=2, validation_split=0.25,
                use_speed_perturbation=False, use_spec_augment=False,
                compute_dtype="float32",
            ),
            device=device,
        )
        print("train result:", result)
        assert np.isfinite(result["best_val_loss"])

        print("== KokoroTTS (README example) ==")
        tts = KokoroTTS(str(out), vocoder_type="griffin_lim", device=device)
        wav_path = Path(tmp) / "hello.wav"
        tts.text_to_speech("Привет, мир!", str(wav_path))
        sr, data = read_wav(wav_path)
        print(f"synthesized {len(data) / sr:.2f}s at {sr} Hz")
        assert sr == 22050 and len(data) > 0 and np.isfinite(data).all()

    print("EXAMPLES: PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
