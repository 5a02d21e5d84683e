"""SpecAugment on the expanded encoder memory (not the decoder's mel input).

Port of ``kokoro_tpu/ops/specaugment.py``: per batch row, ``num_time_masks``
spans of the frame axis and ``num_freq_masks`` spans of the feature axis are
zeroed; each span has a width uniform in [0, max] and a start uniform in
[0, max(size - width, 1)).  The draws come from the caller's generator (the
training step's, through ``models/rng.py``), so they differ from the JAX
package's ``jax.random`` draws but follow the same distribution.
"""

from __future__ import annotations

import torch


def _span_mask(gen: torch.Generator, batch: int, size: int, max_width: int,
               n_masks: int, device) -> torch.Tensor:
    """(batch, size) bool, True where masked."""
    widths = torch.randint(0, max_width + 1, (batch, n_masks), generator=gen, device=device)
    high = torch.clamp(size - widths, min=1)
    starts = (torch.rand((batch, n_masks), generator=gen, device=device) * high).long()
    starts = torch.minimum(starts, high - 1)
    pos = torch.arange(size, device=device)[None, None, :]
    spans = (pos >= starts[:, :, None]) & (pos < (starts + widths)[:, :, None])
    return spans.any(dim=1)


def apply_spec_augment(memory: torch.Tensor, gen: torch.Generator, time_mask_max: int = 5,
                       freq_mask_max: int = 3, num_time_masks: int = 1,
                       num_freq_masks: int = 2) -> torch.Tensor:
    """Zero random time spans and feature spans of ``memory`` (B, T, D) per
    sample (a multiplicative keep mask)."""
    B, T, D = memory.shape
    time_mask = _span_mask(gen, B, T, time_mask_max, num_time_masks, memory.device)
    freq_mask = _span_mask(gen, B, D, freq_mask_max, num_freq_masks, memory.device)
    keep = ~(time_mask[:, :, None] | freq_mask[:, None, :])
    return memory * keep.to(memory.dtype)
