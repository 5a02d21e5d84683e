"""Hann window, HTK mel filterbank, STFT framing, the log-mel feature and
Griffin-Lim (the vocoder fallback).

Port of ``kokoro_tpu/ops/stft.py``.  The log-mel is the reference's feature
definition: torchaudio ``MelSpectrogram(power=2)`` (periodic hann window,
centered reflect-padded frames, HTK mel scale without filterbank
normalisation, torchaudio's ``melscale_fbanks(mel_scale='htk', norm=None)``)
followed by ``log(mel + 1e-9)``.  Griffin-Lim inverts ``log(mel)`` by
``exp``, a least-squares (pseudo-inverse) mel inversion and ``n_iter``
phase-recovery iterations.  Everything runs on the input's device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(periodic=True)``)."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)


def _hz_to_mel_htk(freq):
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float,
                   f_max: float) -> np.ndarray:
    """Triangular HTK mel filterbank ``(n_freqs, n_mels)`` float32."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(mel_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def _window(n_fft: int, win_length: int, dtype, device) -> torch.Tensor:
    window = hann_window(win_length, dtype=dtype, device=device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def frame_signal(waveform: torch.Tensor, frame_length: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """``(..., samples)`` -> overlapping frames ``(..., n_frames,
    frame_length)``; ``center`` reflect-pads ``frame_length // 2`` on both
    sides (torch.stft's convention: ``n_frames = samples // hop + 1``)."""
    if center:
        pad = frame_length // 2
        lead = waveform.shape[:-1]
        waveform = F.pad(waveform.reshape(-1, 1, waveform.shape[-1]), (pad, pad),
                         mode="reflect").reshape(*lead, -1)
    return waveform.unfold(-1, frame_length, hop_length)


def stft_power(waveform: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
               center: bool = True) -> torch.Tensor:
    """``|STFT|^2`` ``(..., n_frames, n_fft // 2 + 1)`` with a periodic hann
    window zero-padded to ``n_fft``."""
    frames = frame_signal(waveform, n_fft, hop_length, center=center)
    spec = torch.fft.rfft(frames * _window(n_fft, win_length, frames.dtype, frames.device),
                          n=n_fft, dim=-1)
    return spec.abs() ** 2


def log_mel_spectrogram(
    waveform: torch.Tensor, sample_rate: int = 22050, n_fft: int = 1024,
    hop_length: int = 256, win_length: int = 1024, n_mels: int = 80, f_min: float = 0.0,
    f_max: Optional[float] = 8000.0, eps: float = 1e-9,
) -> torch.Tensor:
    """Log-mel ``(..., n_frames, n_mels)`` of ``(..., samples)`` float32
    audio: ``log(mel_power + eps)``."""
    if f_max is None:
        f_max = sample_rate / 2.0
    power = stft_power(waveform.float(), n_fft, hop_length, win_length)
    fb = torch.as_tensor(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max),
                         device=waveform.device)
    return torch.log(power @ fb + eps)


def griffin_lim(
    log_mel: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    n_iter: int = 60,
    sample_rate: int = 22050,
    n_mels: int = 80,
    f_min: float = 0.0,
    f_max: Optional[float] = 8000.0,
    init_angles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Waveform from a log-mel ``(..., n_frames, n_mels)`` (leading dims batch).

    ``init_angles`` ``(..., n_frames, n_fft // 2 + 1)`` sets the initial
    phases; otherwise they are drawn uniform in [-pi, pi) from a generator
    seeded with 0."""
    if f_max is None:
        f_max = sample_rate / 2.0
    dev, dtype = log_mel.device, torch.float32
    batch_shape = log_mel.shape[:-2]
    log_mel = log_mel.reshape(-1, *log_mel.shape[-2:]).to(dtype)
    B, n_frames, _ = log_mel.shape
    fb = torch.as_tensor(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max), device=dev)
    # least-squares inversion of the mel projection, with numpy's pinv cutoff
    # of 10 * max(m, n) * eps
    pinv = torch.linalg.pinv(fb, rtol=10.0 * max(fb.shape) * torch.finfo(dtype).eps)
    magnitude = torch.sqrt(torch.clamp(torch.exp(log_mel) @ pinv, min=0.0))
    window = _window(n_fft, win_length, dtype, dev)
    out_len = n_fft + hop_length * (n_frames - 1)
    idx = (torch.arange(n_frames, device=dev)[:, None] * hop_length
           + torch.arange(n_fft, device=dev)[None, :]).reshape(-1)
    norm = torch.zeros(out_len, dtype=dtype, device=dev).index_add_(
        0, idx, (window**2).expand(n_frames, n_fft).reshape(-1)
    )
    pad = n_fft // 2

    def istft(spec):
        frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
        wav = torch.zeros(B, out_len, dtype=dtype, device=dev).index_add_(
            1, idx, frames.reshape(B, -1)
        )
        return (wav / torch.clamp(norm, min=1e-8))[:, pad : out_len - pad]

    def stft(wav):
        padded = F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]
        frames = padded.unfold(-1, n_fft, hop_length)[:, :n_frames]
        return torch.fft.rfft(frames * window, n=n_fft, dim=-1)

    if init_angles is None:
        generator = torch.Generator(device=dev).manual_seed(0)
        init_angles = (torch.rand(magnitude.shape, generator=generator, device=dev) * 2 - 1) * math.pi
    angles = init_angles.reshape(magnitude.shape).to(device=dev, dtype=dtype)
    spec = torch.polar(magnitude, angles)
    for _ in range(n_iter):
        rebuilt = stft(istft(spec))
        spec = magnitude * rebuilt / torch.clamp(rebuilt.abs(), min=1e-8)
    return istft(spec).reshape(*batch_shape, -1)
