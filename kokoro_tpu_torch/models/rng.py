"""Explicit randomness of a training forward, the counterpart of flax's named
rngs and ``make_rng`` folding.

A training step draws ONE 63-bit seed from its ``torch.Generator`` before
the forward (:meth:`Rng.from_generator`); every random site of the model
(dropout, stochastic depth, SpecAugment, the attention kernels' in-kernel
dropout) folds its own path name into it (:meth:`Rng.fold`).  A site's draws
are a pure function of (step seed, site path), so a recompute under
``torch.utils.checkpoint`` regenerates the masks the forward applied, and the
attention backward kernel regenerates the forward's mask from the same seed.
Nothing reads the global RNG; an eval forward (``model.eval()``) draws
nothing.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import torch

SEED_BITS = 63


class Rng:
    """A node of the per-site seed tree."""

    __slots__ = ("seed",)

    def __init__(self, seed: int) -> None:
        self.seed = int(seed) & ((1 << SEED_BITS) - 1)

    @classmethod
    def from_generator(cls, generator: torch.Generator) -> "Rng":
        return cls(int(torch.randint(0, (1 << SEED_BITS) - 1, (), generator=generator)))

    def fold(self, name: str) -> "Rng":
        """The child stream of site ``name``."""
        digest = hashlib.blake2b(f"{self.seed}/{name}".encode(), digest_size=8).digest()
        return Rng(int.from_bytes(digest, "little"))

    def generator(self, device) -> torch.Generator:
        """A generator on ``device`` seeded from this node."""
        return torch.Generator(device=device).manual_seed(self.seed)


def fold(rng: Optional[Rng], name: str) -> Optional[Rng]:
    return None if rng is None else rng.fold(name)


def _need(rng: Optional[Rng], what: str) -> Rng:
    if rng is None:
        raise ValueError(f"{what} in a training forward needs an Rng (models/rng.py); "
                         "pass rng= or call model.eval()")
    return rng


def dropout(x: torch.Tensor, rate: float, rng: Optional[Rng], training: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, kept values
    divided by it."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    gen = _need(rng, "dropout").generator(x.device)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, rng: Optional[Rng], training: bool) -> torch.Tensor:
    """Per-sample stochastic depth: a whole batch row is kept or zeroed."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    gen = _need(rng, "stochastic depth").generator(x.device)
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def attention_seed(rng: Optional[Rng], rate: float) -> Optional[int]:
    """The packed attention kernels' dropout seed of a site (None at rate 0)."""
    return None if rate == 0.0 else _need(rng, "attention dropout").seed
