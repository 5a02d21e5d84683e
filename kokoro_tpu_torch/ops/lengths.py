"""Token <-> frame conversion (length regulation).

Port of ``kokoro_tpu/ops/lengths.py``: frame ``t`` belongs to the first token
whose cumulative end exceeds ``t`` (``searchsorted(side="right")`` on the
cumulative ends), and expansion is a gather.
"""

from __future__ import annotations

from typing import Tuple

import torch


def token_to_frame_map(
    durations: torch.Tensor, max_len: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(frame_to_token (B, T) int64 in [0, L-1], frame_valid (B, T) bool,
    total_lengths (B,) int32)`` for ``(B, L)`` durations clamped to >= 0."""
    durations = torch.clamp(durations.to(torch.int32), min=0)
    ends = torch.cumsum(durations, dim=1, dtype=torch.int32)
    total = torch.clamp(ends[:, -1], max=max_len)
    frames = torch.arange(max_len, dtype=torch.int32, device=durations.device)
    frame_to_token = torch.searchsorted(
        ends.contiguous(), frames.expand(ends.shape[0], max_len).contiguous(), right=True
    )
    frame_valid = frames[None, :] < total[:, None]
    frame_to_token = torch.clamp(frame_to_token, 0, durations.shape[1] - 1)
    return frame_to_token, frame_valid, total.to(torch.int32)


def expand_tokens(
    tokens: torch.Tensor, durations: torch.Tensor, max_len: int,
    stop_gradient: bool = True,
) -> torch.Tensor:
    """Repeat ``(B, L[, D])`` token values per duration into ``(B, max_len[, D])``;
    frames past the total length are zero."""
    if stop_gradient:
        tokens = tokens.detach()
    frame_to_token, frame_valid, _ = token_to_frame_map(durations, max_len)
    if tokens.dim() == 3:
        idx = frame_to_token[:, :, None].expand(-1, -1, tokens.shape[2])
        gathered = torch.gather(tokens, 1, idx)
        return torch.where(frame_valid[:, :, None], gathered, torch.zeros((), dtype=tokens.dtype, device=tokens.device))
    gathered = torch.gather(tokens, 1, frame_to_token)
    return torch.where(frame_valid, gathered, torch.zeros((), dtype=tokens.dtype, device=tokens.device))


def length_regulate(
    encoder_outputs: torch.Tensor, durations: torch.Tensor,
    text_padding_mask: torch.Tensor, max_len: int, stop_gradient: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient-preserving length regulation: valid tokens last >= 1 frame,
    padded tokens 0.  Returns ``(expanded (B, T, D), frame_padding_mask (B, T)
    True = padding)``."""
    keep = ~text_padding_mask.to(torch.bool)
    dur = torch.where(keep, torch.clamp(durations.to(torch.int32), min=1), 0)
    expanded = expand_tokens(encoder_outputs, dur, max_len, stop_gradient=stop_gradient)
    _, frame_valid, _ = token_to_frame_map(dur, max_len)
    return expanded, ~frame_valid
