"""Energy contours from mel spectrograms or waveforms.

Port of ``kokoro_tpu/ops/energy.py`` (the reference's ``EnergyExtractor``,
model/variance_predictor.py:628-727): log-domain mels average over the mel
bins, linear mels take ``log1p`` of the mean power (``median < -1`` picks
the log domain when not given); the contour is normalised into [0, 1] by
its 5th/95th percentiles (min/max below 3 frames).  The waveform variant is
a windowed RMS.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from kokoro_tpu_torch.ops.stft import hann_window


def extract_energy_from_mel(mel_spec: torch.Tensor,
                            log_domain: Optional[bool] = None) -> torch.Tensor:
    """Energy in [0, 1] from ``(..., frames, n_mels)`` mels."""
    if log_domain is None:
        # jnp.median averages the two middle values of an even count
        log_domain = bool(torch.quantile(mel_spec.float().flatten(), 0.5) < -1.0)
    if log_domain:
        energy = mel_spec.mean(-1)
    else:
        energy = torch.log1p(torch.clamp(mel_spec.mean(-1), min=0.0))
    if energy.shape[-1] < 3:
        floor = energy.amin(-1, keepdim=True)
        ceil = energy.amax(-1, keepdim=True)
    else:
        floor = torch.quantile(energy, 0.05, dim=-1, keepdim=True)
        ceil = torch.quantile(energy, 0.95, dim=-1, keepdim=True)
    return torch.clamp((energy - floor) / torch.clamp(ceil - floor, min=1e-8), 0.0, 1.0)


def extract_energy_from_waveform(waveform: torch.Tensor, hop_length: int = 256,
                                 win_length: int = 1024) -> torch.Tensor:
    """Windowed RMS energy of ``(batch, samples)`` or ``(samples,)`` audio."""
    squeeze = waveform.dim() == 1
    if squeeze:
        waveform = waveform[None, :]
    pad = win_length // 2
    waveform = F.pad(waveform[:, None].float(), (pad, pad), mode="reflect")[:, 0]
    if waveform.shape[1] < win_length:
        waveform = F.pad(waveform, (0, win_length - waveform.shape[1]))
    frames = waveform.unfold(-1, win_length, hop_length)
    frames = frames * hann_window(win_length, device=waveform.device)
    energy = torch.sqrt((frames ** 2).mean(-1) + 1e-8)
    return energy[0] if squeeze else energy
