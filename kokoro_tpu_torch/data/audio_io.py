"""Host-side wav writing (numpy only).

Port of ``kokoro_tpu/data/audio_io.py::save_wav``: float audio is peak-limited
to [-1, 1] and written as 16-bit PCM mono.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def save_wav(path: str | Path, audio: np.ndarray, sample_rate: int) -> None:
    """Save float audio as 16-bit PCM mono; normalizes when the peak > 1."""
    audio = np.asarray(audio, dtype=np.float32).squeeze()
    peak = np.max(np.abs(audio)) if audio.size else 0.0
    if peak > 1.0:
        audio = audio / peak
    pcm = (audio * 32767.0).astype("<i2")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)
