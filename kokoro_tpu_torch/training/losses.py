"""Training losses and validation metrics.

Port of ``kokoro_tpu/training/losses.py``, in float32 whatever the model's
compute dtype:

* mel: L1 over the mel mask AND finite elements;
* duration: Huber (torch form) on ``log(d + 1)`` targets over the phoneme
  mask AND d > 0;
* stop: BCE-with-logits with ``pos_weight``, softplus as ``logaddexp(v, 0)``,
  over the mel mask;
* pitch/energy: Huber on frame-level targets cut to the mel length, over the
  mel mask;
* per-loss clamps (mel/duration/stop <= 100, pitch/energy <= 10) and the
  weighted total.

A masked mean skips non-finite values and is 0 when nothing is valid.

On a mesh (``mesh=``, ``parallel/mesh.py``) every masked mean is over the
GLOBAL batch, as the reference's loss under data parallelism: each rank's
masked sums and counts are summed over the ``data`` group (one collective of
float64 sums and counts, through ``reduce_from_region``, whose backward is
the identity), so the clamps and the weighted total see the global values,
equal on every rank, and each rank's gradient is its rows' share of the
global loss's.  The validation metrics sum the same way.

Under a ``seq`` axis each rank holds a window of frames starting at
``frame_offset``: the frame-level terms (mel, stop, pitch, energy, and the
metrics) are its window's sums, and the sums run over ``('data', 'seq')``;
the phoneme-level duration term, whole on every rank of a ``seq`` group,
is counted by seq rank 0 alone.  So no term is counted on two ranks, and a
parameter's gradient is the sum over the mesh of what each rank's own
backward gives it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from kokoro_tpu_torch.parallel.tp import reduce_from_region


def masked_sum(values: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, count) of the valid finite elements."""
    valid = mask & torch.isfinite(values)
    total = torch.where(valid, values, torch.zeros((), dtype=values.dtype,
                                                    device=values.device)).sum()
    return total, valid.sum()


def _mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return torch.where(count > 0, total / torch.clamp(count, min=1), torch.zeros_like(total))


def frame_mask(lengths: torch.Tensor, frames: int, frame_offset: int = 0) -> torch.Tensor:
    """(B, frames) validity of the frames ``[frame_offset, frame_offset +
    frames)`` under per-row ``lengths``."""
    pos = frame_offset + torch.arange(frames, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _mean(*masked_sum(values, mask))


SUM_AXES = ("data", "seq")


def data_sums(values: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Scalars summed over the ``data`` and ``seq`` groups (those of the
    mesh's axes) in one float64 collective, each back in its dtype; a
    gradient flows through unchanged (identity backward)."""
    if mesh is None:
        return values
    packed = reduce_from_region(torch.stack([v.double() for v in values]), mesh, SUM_AXES)
    return [p.to(v.dtype) for p, v in zip(packed.unbind(), values)]


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs()


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float) -> torch.Tensor:
    """torch.nn.HuberLoss elementwise: 0.5 e^2 below delta, delta (|e| - delta / 2) above."""
    err = (pred - target).abs()
    return torch.where(err < delta, 0.5 * err ** 2, delta * (err - 0.5 * delta))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: float = 1.0) -> torch.Tensor:
    """``pw * z * softplus(-x) + (1 - z) * softplus(x)``."""
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    return (pos_weight * targets * torch.logaddexp(-logits, zero)
            + (1.0 - targets) * torch.logaddexp(logits, zero))


def calculate_training_losses(
    *,
    predicted_mel: torch.Tensor,            # (B, T, M)
    predicted_log_durations: torch.Tensor,  # (B, L)
    predicted_stop_logits: torch.Tensor,    # (B, T)
    mel_specs: torch.Tensor,                # (B, T, M)
    phoneme_durations: torch.Tensor,        # (B, L)
    stop_token_targets: torch.Tensor,       # (B, T)
    mel_lengths: torch.Tensor,              # (B,)
    phoneme_lengths: torch.Tensor,          # (B,)
    predicted_pitch: Optional[torch.Tensor] = None,
    predicted_energy: Optional[torch.Tensor] = None,
    pitch_targets: Optional[torch.Tensor] = None,
    energy_targets: Optional[torch.Tensor] = None,
    duration_loss_weight: float = 0.35,
    stop_token_loss_weight: float = 0.010,
    pitch_loss_weight: float = 1.0,
    energy_loss_weight: float = 1.0,
    stop_token_pos_weight: float = 17.0,
    duration_huber_delta: float = 1.0,
    pitch_huber_delta: float = 0.05,
    energy_huber_delta: float = 0.05,
    mesh=None,
    frame_offset: int = 0,
) -> Dict[str, torch.Tensor]:
    """Returns total, mel, duration, stop, pitch, energy (f32 scalars);
    with ``mesh``, masked means over the global batch.  The frame-level
    inputs are the frames from ``frame_offset`` on (a seq rank's window)."""
    def f32(x):
        return None if x is None else x.float()

    predicted_mel, mel_specs = f32(predicted_mel), f32(mel_specs)
    predicted_log_durations = f32(predicted_log_durations)
    predicted_stop_logits, stop_token_targets = f32(predicted_stop_logits), f32(stop_token_targets)
    predicted_pitch, pitch_targets = f32(predicted_pitch), f32(pitch_targets)
    predicted_energy, energy_targets = f32(predicted_energy), f32(energy_targets)
    device = mel_specs.device
    T, L = mel_specs.shape[1], phoneme_durations.shape[1]
    mel_mask = frame_mask(mel_lengths, T, frame_offset)
    phoneme_mask = torch.arange(L, device=device)[None, :] < phoneme_lengths[:, None]

    target_log_durations = torch.log(phoneme_durations.float() + 1.0)
    parts = {
        "mel": masked_sum(l1_loss(predicted_mel, mel_specs), mel_mask[:, :, None]),
        "duration": masked_sum(
            huber_loss(predicted_log_durations, target_log_durations, duration_huber_delta),
            phoneme_mask & (phoneme_durations > 0)),
        "stop": masked_sum(
            bce_with_logits(predicted_stop_logits, stop_token_targets, stop_token_pos_weight),
            mel_mask),
    }
    if mesh is not None and mesh.index("seq") > 0:  # counted by seq rank 0
        parts["duration"] = tuple(torch.zeros_like(x) for x in parts["duration"])
    if predicted_pitch is not None and pitch_targets is not None:
        parts["pitch"] = masked_sum(huber_loss(predicted_pitch[:, :T], pitch_targets[:, :T],
                                               pitch_huber_delta), mel_mask)
    if predicted_energy is not None and energy_targets is not None:
        parts["energy"] = masked_sum(huber_loss(predicted_energy[:, :T], energy_targets[:, :T],
                                                energy_huber_delta), mel_mask)
    sums = data_sums([x for pair in parts.values() for x in pair], mesh)
    means = {k: _mean(sums[2 * i], sums[2 * i + 1]) for i, k in enumerate(parts)}
    zero = torch.zeros((), device=device)
    loss_mel, loss_duration, loss_stop = means["mel"], means["duration"], means["stop"]
    loss_pitch, loss_energy = means.get("pitch", zero), means.get("energy", zero)

    loss_mel = torch.clamp(loss_mel, max=100.0)
    loss_duration = torch.clamp(loss_duration, max=100.0)
    loss_stop = torch.clamp(loss_stop, max=100.0)
    loss_pitch = torch.clamp(loss_pitch, max=10.0)
    loss_energy = torch.clamp(loss_energy, max=10.0)
    total = (loss_mel + loss_duration * duration_loss_weight
             + loss_stop * stop_token_loss_weight + loss_pitch * pitch_loss_weight
             + loss_energy * energy_loss_weight)
    return {"total": total, "mel": loss_mel, "duration": loss_duration, "stop": loss_stop,
            "pitch": loss_pitch, "energy": loss_energy}


def build_stop_token_targets(T: int, lengths: torch.Tensor, tail: int = 6,
                             decay: float = 0.5) -> torch.Tensor:
    """Smoothed stop targets (B, T): ``frame[len - 1 - k] = decay**k`` for
    k = 0..tail, zero elsewhere."""
    pos = torch.arange(T, device=lengths.device)[None, :]
    k = (lengths[:, None] - 1) - pos
    in_tail = (k >= 0) & (k <= tail) & (pos < lengths[:, None])
    return torch.where(in_tail, decay ** torch.clamp(k, min=0).float(),
                       torch.zeros((), device=lengths.device))


def spectral_convergence(pred_mel: torch.Tensor, target_mel: torch.Tensor,
                         mel_mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """||pred - target||_F / ||target||_F over valid frames (of the global
    batch with ``mesh``)."""
    m = mel_mask[:, :, None]
    zero = torch.zeros((), dtype=pred_mel.dtype, device=pred_mel.device)
    diff = torch.where(m, pred_mel - target_mel, zero)
    tgt = torch.where(m, target_mel, zero)
    diff2, tgt2 = data_sums([(diff ** 2).sum(), (tgt ** 2).sum()], mesh)
    return torch.sqrt(diff2) / torch.clamp(torch.sqrt(tgt2), min=1e-8)


def f0_rmse(pred_pitch: torch.Tensor, target_pitch: torch.Tensor,
            mel_mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Frame-level F0 RMSE over voiced and valid frames."""
    valid = mel_mask & (target_pitch > 0)
    se = torch.where(valid, (pred_pitch - target_pitch) ** 2,
                     torch.zeros((), dtype=pred_pitch.dtype, device=pred_pitch.device))
    se, count = data_sums([se.sum(), valid.sum()], mesh)
    return torch.sqrt(se / torch.clamp(count, min=1))


def mel_cepstral_distortion(pred_log_mel: torch.Tensor, target_log_mel: torch.Tensor,
                            mel_mask: torch.Tensor, n_coeffs: int = 13,
                            mesh=None) -> torch.Tensor:
    """Mel-cepstral distortion in dB: orthonormal DCT-II of the natural-log
    mel per frame, coefficients 1..n_coeffs, ``(10 / ln 10) sqrt(2 sum dc^2)``
    averaged over valid frames."""
    M = pred_log_mel.shape[-1]
    device = pred_log_mel.device
    n = torch.arange(M, device=device, dtype=torch.float32)
    k = torch.arange(M, device=device, dtype=torch.float32)[:, None]
    basis = torch.cos(math.pi * k * (2 * n[None, :] + 1) / (2 * M))
    basis = basis * torch.where(k == 0, math.sqrt(1.0 / M), math.sqrt(2.0 / M))
    c_pred = torch.einsum("btm,km->btk", pred_log_mel.float(), basis)
    c_tgt = torch.einsum("btm,km->btk", target_log_mel.float(), basis)
    dc = (c_pred - c_tgt)[..., 1:n_coeffs + 1]
    per_frame = (10.0 / math.log(10.0)) * torch.sqrt(2.0 * (dc ** 2).sum(-1) + 1e-12)
    valid = mel_mask.float()
    total, count = data_sums([(per_frame * valid).sum(), valid.sum()], mesh)
    return total / torch.clamp(count, min=1.0)
