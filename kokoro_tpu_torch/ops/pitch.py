"""YIN/CMND pitch (F0) extraction on the input's device.

Port of ``kokoro_tpu/ops/pitch.py`` (itself the reference's torch extractor,
model/variance_predictor.py:442-625): pre-emphasis 0.97; hann-windowed
frames of ``max(2048, 8 * hop)``; the autocorrelation through a ``2 * win``
rfft; the cumulative mean normalised difference with a 0.15 dip threshold
and an argmin fallback; parabolic interpolation; an adaptive voicing
threshold (the 25th percentile of the autocorrelation peaks) and an energy
gate; linear interpolation over unvoiced gaps of at most 5 frames; a 5-tap
median filter; voiced F0 normalised into [0, 1] over [fmin, fmax], unvoiced
0.  The percentiles count real frames only when ``valid_frames`` is given
(the audio is zero-padded to a length bucket).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from kokoro_tpu_torch.ops.stft import hann_window


def _median_filter_1d(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k-tap median filter along the last axis of ``(B, T)`` with reflect
    padding."""
    pad = k // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    return xp.unfold(-1, k, 1).median(dim=-1).values


def masked_quantile(x: torch.Tensor, valid: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile over the last axis counting only ``valid`` entries, with
    linear interpolation (``jnp.quantile``'s), keepdim."""
    sorted_x = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf"))), dim=-1).values
    n = valid.sum(-1, keepdim=True).float()
    pos = q * torch.clamp(n - 1.0, min=0.0)
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    frac = pos - lo.float()
    return torch.gather(sorted_x, -1, lo) * (1.0 - frac) + torch.gather(sorted_x, -1, hi) * frac


def extract_pitch(
    waveform: torch.Tensor, sample_rate: int = 22050, hop_length: int = 256,
    fmin: float = 50.0, fmax: float = 800.0, win_length: Optional[int] = None,
    valid_frames: Optional[int] = None,
) -> torch.Tensor:
    """Normalised F0 in [0, 1] of ``(batch, samples)`` or ``(samples,)``
    audio, one value per hop; unvoiced frames are 0.  ``valid_frames``: the
    true frame count of zero-padded audio (percentiles over real frames only,
    later frames unvoiced)."""
    squeeze = waveform.dim() == 1
    if squeeze:
        waveform = waveform[None, :]
    waveform = waveform.float()
    hop = int(hop_length)
    win = int(win_length) if win_length is not None else max(2048, hop * 8)
    if waveform.shape[1] < win:
        waveform = F.pad(waveform, (0, win - waveform.shape[1]))

    waveform = torch.cat([waveform[:, :1], waveform[:, 1:] - 0.97 * waveform[:, :-1]], dim=1)
    pad = win // 2
    waveform = F.pad(waveform[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = waveform.unfold(-1, win, hop) * hann_window(win, device=waveform.device)

    nfft = win * 2
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    acf = torch.fft.irfft(spec.abs() ** 2, n=nfft, dim=-1)[..., :win]

    zero_lag = acf[..., 0:1]
    diff = 2.0 * zero_lag - 2.0 * acf
    cumsum = torch.cumsum(diff[..., 1:], dim=-1)
    tau = torch.arange(1, win, dtype=torch.float32, device=acf.device)
    cmnd = torch.cat([torch.ones_like(zero_lag), diff[..., 1:] / (cumsum / tau + 1e-8)], dim=-1)

    lag_min = max(2, int(sample_rate / fmax))
    lag_max = min(win - 2, max(lag_min + 1, int(sample_rate / fmin)))
    lags = torch.arange(lag_min, lag_max + 1, dtype=torch.float32, device=acf.device)
    n_lags = lag_max - lag_min + 1
    cmnd_lags = cmnd[..., lag_min:lag_max + 1]
    acf_norm = acf / torch.clamp(zero_lag, min=1e-8)
    ac_max_vals = acf_norm[..., lag_min:lag_max + 1].amax(-1)

    below = cmnd_lags < 0.15
    has_dip = below.any(-1)
    first_dip = below.to(torch.uint8).argmax(-1)
    best_idx = torch.where(has_dip, first_dip, cmnd_lags.argmin(-1))

    def take(i):
        return torch.gather(cmnd_lags, -1, i[..., None])[..., 0]

    alpha = take(torch.clamp(best_idx - 1, min=0))
    beta = take(best_idx)
    gamma = take(torch.clamp(best_idx + 1, max=n_lags - 1))
    denom = torch.clamp(alpha - 2.0 * beta + gamma, min=1e-8)
    offset = torch.clamp(0.5 * (alpha - gamma) / denom, -1.0, 1.0)
    freqs = sample_rate / torch.clamp(lags[best_idx] + offset, min=1.0)

    frame_energy = (frames ** 2).mean(-1)
    T = ac_max_vals.shape[-1]
    if valid_frames is None:
        ac_25th = torch.quantile(ac_max_vals, 0.25, dim=-1, keepdim=True)
        energy_med = torch.quantile(frame_energy, 0.5, dim=-1, keepdim=True)
        frame_valid = None
    else:
        frame_valid = torch.arange(T, device=acf.device)[None, :] < int(valid_frames)
        ac_25th = masked_quantile(ac_max_vals, frame_valid, 0.25)
        energy_med = masked_quantile(frame_energy, frame_valid, 0.5)
    voicing_thresh = torch.clamp(ac_25th * 0.8, 0.15, 0.35)
    energy_thresh = torch.clamp(energy_med * 0.05, min=1e-9)
    unvoiced = (ac_max_vals < voicing_thresh) | (frame_energy < energy_thresh)
    if frame_valid is not None:
        unvoiced = unvoiced | ~frame_valid
    zero = torch.zeros((), device=acf.device)
    freqs = torch.where(unvoiced, zero, freqs)
    freqs = torch.where((freqs < fmin) | (freqs > fmax), zero, freqs)

    # interpolate short unvoiced gaps (<= 5 frames) between voiced neighbours
    B = freqs.shape[0]
    pos = torch.arange(T, device=acf.device).expand(B, T)
    voiced = freqs > 0.0
    prev_idx = torch.cummax(torch.where(voiced, pos, -1), dim=1).values
    next_idx = torch.flip(torch.cummin(torch.flip(torch.where(voiced, pos, T), [1]), dim=1).values,
                          [1])
    fill = (~voiced) & (prev_idx >= 0) & (next_idx < T) & (next_idx - prev_idx - 1 <= 5)
    prev_vals = torch.gather(freqs, 1, torch.clamp(prev_idx, min=0))
    next_vals = torch.gather(freqs, 1, torch.clamp(next_idx, max=T - 1))
    t = (pos - prev_idx).float() / torch.clamp((next_idx - prev_idx).float(), min=1.0)
    freqs = torch.where(fill, prev_vals * (1.0 - t) + next_vals * t, freqs)

    freqs = _median_filter_1d(freqs, 5)
    norm = torch.clamp((freqs - fmin) / (fmax - fmin + 1e-8), 0.0, 1.0)
    norm = torch.where(freqs == 0.0, zero, norm)
    return norm[0] if squeeze else norm
