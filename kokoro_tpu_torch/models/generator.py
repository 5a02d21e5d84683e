"""Autoregressive mel generation, the serving hot loop.

Port of ``kokoro_tpu/models/generator.py``.  The reference's
``lax.while_loop`` becomes a Python loop over preallocated head-first KV
caches ``(B, H, max_frames, Dh)`` that each step updates in place.  The
semantics are the reference's, per row:

* cross-attention K/V projected once from the expanded memory;
* stop when ``sigmoid(stop) > threshold`` past ``min_expected``, with the
  relaxed ``post_expected_stop_threshold`` once past the duration-predicted
  length;
* energy stop when the mean of the last 30 frames is below -9.5;
* bounds ``min = max(floor, 0.7 * expected)`` and
  ``max = min(max_frames, max(expected + 80, 3 * expected), cap)``
  (``min + 1`` when that is not above ``min``);
* rows that finished ride along with their outputs frozen;
* the result is clamped to [-11.5, 2.0]; B=1 returns 0-d length/expected.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kokoro_tpu_torch.models.kokoro import KokoroModel


@torch.no_grad()
def generate(
    model: KokoroModel,
    phoneme_indices: torch.Tensor,           # (B, L)
    stress_indices: Optional[torch.Tensor],  # (B, L) or None
    text_padding_mask: torch.Tensor,         # (B, L) True = pad
    max_frames: int,
    stop_threshold: float = 0.5,
    post_expected_stop_threshold: float = 0.2,
    min_len_ratio: float = 0.7,
    min_len_floor: int = 12,
    max_len_ratio: float = 3.0,
    max_len_cap: int = 1600,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(mel (B, max_frames, M) f32, length, expected)``."""
    cfg = model.config
    B = phoneme_indices.shape[0]
    M = cfg.n_mels
    dev = phoneme_indices.device
    dtype = model.mel_projection_in.weight.dtype

    memory, memory_pad_mask, expected = model.encode_for_inference(
        phoneme_indices, stress_indices, text_padding_mask, max_frames
    )
    cross_kvs = model.project_memory_kv(memory)

    min_expected = torch.clamp((expected * min_len_ratio).to(torch.int32), min=min_len_floor)
    max_expected = torch.clamp(
        torch.maximum(expected + 80, (expected * max_len_ratio).to(torch.int32)),
        max=min(max_frames, max_len_cap),
    )
    max_expected = torch.where(
        max_expected <= min_expected,
        torch.clamp(min_expected + 1, max=max_frames),
        max_expected,
    )

    head_dim = cfg.hidden_dim // cfg.n_heads
    caches = [
        {
            "k": torch.zeros(B, cfg.n_heads, max_frames, head_dim, dtype=dtype, device=dev),
            "v": torch.zeros(B, cfg.n_heads, max_frames, head_dim, dtype=dtype, device=dev),
            "index": 0,
        }
        for _ in range(cfg.n_decoder_layers)
    ]
    prev_frame = torch.zeros(B, 1, M, dtype=dtype, device=dev)
    mels = torch.zeros(B, max_frames, M, dtype=torch.float32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    length = torch.zeros(B, dtype=torch.int32, device=dev)

    relaxed_threshold = min(stop_threshold, post_expected_stop_threshold)
    t = 0
    while t < max_frames and bool(((~done) & (t < max_expected)).any()):
        row_active = (~done) & (t < max_expected)
        mel_t, stop_t, caches = model.decode_step(
            prev_frame, t, caches, cross_kvs, memory_pad_mask
        )
        mels[:, t] = torch.where(row_active[:, None], mel_t[:, 0].float(), mels[:, t])
        stop_prob = torch.sigmoid(stop_t.float()).reshape(B, -1).mean(-1)
        past_min = t >= min_expected
        eff_thresh = torch.where(t < expected, stop_threshold, relaxed_threshold)
        stop_hit = past_min & (stop_prob > eff_thresh)
        n_gen = t + 1
        if n_gen >= 30:
            energy_hit = past_min & (mels[:, n_gen - 30 : n_gen].mean(dim=(1, 2)) < -9.5)
        else:
            energy_hit = torch.zeros_like(done)
        done = done | (row_active & (stop_hit | energy_hit))
        length = torch.where(row_active, torch.full_like(length, n_gen), length)
        prev_frame = mel_t
        t = n_gen

    mel = torch.clamp(mels, -11.5, 2.0)
    if B == 1:
        return mel, length[0], expected[0]
    return mel, length, expected
