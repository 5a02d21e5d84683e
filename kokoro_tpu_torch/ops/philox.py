"""Philox4x32-10 in plain PyTorch: the attention kernels' dropout mask.

The CUDA kernels (``csrc/attention_common.cuh``) draw attention-weight
dropout from Philox4x32-10 keyed on the call's 64-bit seed, with counter
``(b*H + h, row, col // 4, 0)``; word ``col % 4`` of the output decides the
weight at ``(row, col)``, which is kept iff the word is below
``floor(keep * 2**32)`` (the reference's threshold,
``kokoro_tpu/ops/fused_attention.py::_dropout_mask``).  This module is the
same generator on int64 tensors, so the plain versions of the kernels apply
bit-identical masks on any device.

uint32 arithmetic is emulated in int64 with explicit ``& 0xFFFFFFFF``; the
32 x 32 -> 64-bit products of Philox's multipliers would overflow int64, so
each is split into two 32 x 16-bit products.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the 64-bit product ``a * b``."""
    x = a * (b & 0xFFFF)              # < 2**48
    y = a * (b >> 16)                 # < 2**48
    z = ((y & 0xFFFF) << 16) + x      # low 48 bits of the product, < 2**49
    return (y >> 16) + (z >> 32), z & MASK32


def philox4x32_10(counter: tuple, key: int) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 of a counter ``(c0, c1, c2, c3)`` (int64 tensors of
    uint32 values, broadcastable) under a 64-bit ``key``; four int64 tensors
    of uint32 words."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = key & MASK32, (key >> 32) & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """uint32 threshold of a kept weight at dropout ``rate``: the reference's
    ``uint32(min(keep, 1 - 1e-9) * 2**32)``."""
    keep = 1.0 - rate
    return int(min(keep, 1.0 - 1e-9) * 4294967296.0)


def attention_keep_mask(seed: int, B: int, H: int, T: int, rate: float,
                        device=None) -> torch.Tensor:
    """Keep flags ``(B, H, T, T)`` (bool) of the attention weights at
    (row, col) of head h of batch row b, as the kernels draw them."""
    groups = -(-T // 4)
    i64 = dict(dtype=torch.int64, device=device)
    bh = torch.arange(B * H, **i64).view(-1, 1, 1)
    rows = torch.arange(T, **i64).view(1, -1, 1)
    cols = torch.arange(groups, **i64).view(1, 1, -1)
    words = philox4x32_10((bh, rows, cols, torch.zeros((), **i64)), int(seed))
    bits = torch.stack(words, dim=-1).reshape(B * H, T, groups * 4)[..., :T]
    return (bits < keep_threshold(rate)).view(B, H, T, T)
