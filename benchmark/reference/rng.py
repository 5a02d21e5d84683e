"""The training step's randomness, worked out again from the step's seed.

A frozen copy of the seed tree the port folds (one 63-bit seed a step drawn
from the step's ``torch.Generator``; each random site folds its path name
into it with BLAKE2b) and of the attention kernels' Philox4x32-10 dropout
mask (counter ``(b*H + h, row, col // 4, 0)``, word ``col % 4``, kept below
``floor(keep * 2**32)``).  Kept apart from the port so that the reference
takes nothing from the program it judges.
"""

from __future__ import annotations

import hashlib

import torch

SEED_BITS = 63
MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def step_seed(generator: torch.Generator) -> int:
    """The one seed a step draws from its generator before its forward."""
    return int(torch.randint(0, (1 << SEED_BITS) - 1, (), generator=generator))


def fold(seed: int, name: str) -> int:
    """The seed of the child site ``name``."""
    digest = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << SEED_BITS) - 1)


def uniform(seed: int, shape, device) -> torch.Tensor:
    """The f32 uniforms a site with ``seed`` draws over ``shape``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device)


def _mulhilo(a: int, b: torch.Tensor):
    x = a * (b & 0xFFFF)
    y = a * (b >> 16)
    z = ((y & 0xFFFF) << 16) + x
    return (y >> 16) + (z >> 32), z & MASK32


def _philox(c0, c1, c2, c3, key: int):
    k0, k1 = key & MASK32, (key >> 32) & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    return int(min(1.0 - rate, 1.0 - 1e-9) * 4294967296.0)


def attention_keep(seed: int, rows: range, H: int, T: int, rate: float,
                   device) -> torch.Tensor:
    """Keep flags ``(len(rows), H, T, T)`` of batch rows ``rows`` of an
    attention site's weights, as the kernels draw them."""
    groups = -(-T // 4)
    i64 = dict(dtype=torch.int64, device=device)
    bh = (rows.start * H + torch.arange(len(rows) * H, **i64)).view(-1, 1, 1)
    r = torch.arange(T, **i64).view(1, -1, 1)
    c = torch.arange(groups, **i64).view(1, 1, -1)
    c0, c1, c2, c3 = torch.broadcast_tensors(bh, r, c, torch.zeros((), **i64))
    words = _philox(c0, c1, c2, c3, int(seed))
    bits = torch.stack(words, dim=-1).reshape(len(rows) * H, T, groups * 4)[..., :T]
    return (bits < keep_threshold(rate)).view(len(rows), H, T, T)
