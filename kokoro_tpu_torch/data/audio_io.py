"""Host-side audio I/O: wav read and save, resampling, peak normalisation
and speed perturbation.

Port of ``kokoro_tpu/data/audio_io.py``: a wav read normalises int16/int32/
uint8 PCM to float32 in [-1, 1] and averages channels to mono; float audio is
written as 16-bit PCM, peak-limited to [-1, 1].  Resampling is scipy's
polyphase ``resample_poly`` (imported when called), as in the reference.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from pathlib import Path
from typing import Tuple

import numpy as np


def read_wav(path: str | Path) -> Tuple[int, np.ndarray]:
    """Read a wav file -> (sample_rate, float32 mono samples in [-1, 1])."""
    from scipy.io import wavfile

    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:  # (samples, channels) -> mono
        data = data.mean(axis=1)
    return int(sr), data


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


def wav_num_samples(path: Path) -> int:
    """Sample count from the wav header (no full decode); 0 if unreadable."""
    try:
        with open(path, "rb") as f:
            if f.read(12)[:4] != b"RIFF":
                return 0
            channels = bits = 0
            while True:
                chunk = f.read(8)
                if len(chunk) < 8:
                    return 0
                cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
                if cid == b"fmt ":
                    fmt = f.read(size)
                    channels = struct.unpack("<H", fmt[2:4])[0]
                    bits = struct.unpack("<H", fmt[14:16])[0]
                elif cid == b"data":
                    return size // (channels * bits // 8) if channels and bits else 0
                else:
                    f.seek(size, 1)
    except (OSError, struct.error):
        return 0


def resample(audio: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase sinc resampling."""
    if orig_sr == new_sr:
        return audio
    from scipy.signal import resample_poly

    frac = Fraction(new_sr, orig_sr).limit_denominator(1000)
    return resample_poly(audio, frac.numerator, frac.denominator).astype(np.float32)


def peak_normalize(audio: np.ndarray) -> np.ndarray:
    return audio / (np.max(np.abs(audio)) + 1e-9)


def apply_speed_perturbation(audio: np.ndarray, sample_rate: int, factor: float) -> np.ndarray:
    """Change the speaking rate by resampling to ``sr * factor`` and playing
    back at ``sr``; factor > 1 is faster (shorter)."""
    if factor == 1.0:
        return audio
    return peak_normalize(resample(audio, sample_rate, int(sample_rate * factor)))
