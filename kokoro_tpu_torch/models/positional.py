"""Positional encodings: absolute sinusoidal PE and interleaved RoPE.

Port of ``kokoro_tpu/models/positional.py``.  RoPE rotates interleaved pairs
(0, 1), (2, 3), ... with ``inv_freq = base ** (-i / half)``; the sinusoidal
table takes an offset for cached decode, clipped to ``max_len``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def sinusoidal_table(length: int, dim: int) -> np.ndarray:
    """Sinusoidal position table ``(length, dim)`` in float64 numpy."""
    position = np.arange(length, dtype=np.float64)[:, None]
    div_term = np.exp(
        np.arange(0, dim, 2, dtype=np.float64) * (-np.log(10000.0) / dim)
    )
    table = np.zeros((length, dim), dtype=np.float64)
    table[:, 0::2] = np.sin(position * div_term)
    table[:, 1::2] = np.cos(position * div_term[: table[:, 1::2].shape[1]])
    return table


@functools.lru_cache(maxsize=16)
def _device_table(length: int, dim: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # a row depends only on its position, so one table per (length, dim)
    # serves every offset; cached so the AR loop neither recomputes it on
    # the host nor copies it to the device at each step
    return torch.as_tensor(sinusoidal_table(length, dim), dtype=dtype, device=device)


def add_positional_encoding(
    x: torch.Tensor, seq_offset: int = 0, max_len: int | None = None
) -> torch.Tensor:
    """Add sinusoidal PE to ``(B, T, D)`` from absolute position ``seq_offset``.

    With ``max_len`` given (cached decode), positions are clipped to
    ``max_len - 1`` as the reference's dynamic-offset branch does."""
    _, T, D = x.shape
    seq_offset = int(seq_offset)
    if max_len is None:
        length = seq_offset + T
        pe = _device_table(length, D, x.dtype, x.device)[seq_offset:]
    else:
        table = _device_table(max_len, D, x.dtype, x.device)
        if seq_offset + T <= max_len:
            pe = table[seq_offset : seq_offset + T]
        else:
            idx = torch.clamp(torch.arange(seq_offset, seq_offset + T), max=max_len - 1)
            pe = table[idx.to(x.device)]
    return x + pe[None]


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, base: float = 10000.0,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` of shape ``positions.shape + (head_dim // 2,)``."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (base ** exponent)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    pairs = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    x1, x2 = pairs[..., 0], pairs[..., 1]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotate ``(..., T, head_dim)`` by the angles of ``positions`` ``(T,)``."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], base, dtype=x.dtype)
    return _rotate(x, cos, sin)


def apply_rope_heads_last(
    x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0
) -> torch.Tensor:
    """:func:`apply_rope` on the heads-last ``(B, T, H, head_dim)`` layout."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], base, dtype=x.dtype)
    return _rotate(x, cos[:, None, :], sin[:, None, :])
