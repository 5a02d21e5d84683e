"""The tiling arithmetic of ``probe_flash_tf32_wide`` against a brute-force
count, and the split of ``csrc/attention_tf32_wide.cuh`` in numpy.

``tiling`` counts what a call of K4's f32 kernels at head dims 192 and 256
does beside its products (the streamed tiles a CTA loads, the tiles a whole
CTA splits, the loops' barriers, the score exchanges of the row groups) from
the shapes and a design's tiling; PERF.md's attribution of those kernels
rests on it.  Here the visits it counts are held against the (query, key)
pairs a causal or full call computes, enumerated one by one: a CTA loads a
streamed tile, and a row group of 16 rows computes it, exactly when the tile
holds a visible pair of theirs.
"""

import numpy as np
import pytest

from kokoro_tpu_torch.scripts import probe_flash_tf32_wide as probe


def _brute(kind, design, T, causal):
    """(cta_tiles, group_tiles) of one head, from the visible pairs."""
    d = probe.DESIGNS[design]
    R, S = d["rows"], d["stream"]
    q, k = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    visible = (k <= q) if causal else np.ones_like(q, dtype=bool)
    q, k = q[visible], k[visible]
    if kind == "dkdv":  # a CTA owns keys and streams query tiles from its first key
        owner, group = k // R, k // 16
        first = (owner * R) if causal else np.zeros_like(owner)
        tile = (q - first) // S
    else:
        owner, group, tile = q // R, q // 16, k // S
    cta_tiles = len(set(zip(owner.tolist(), tile.tolist())))
    group_tiles = len(set(zip(group.tolist(), tile.tolist())))
    return cta_tiles, group_tiles


@pytest.mark.parametrize("T", [1, 17, 32, 100, 257])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkdv"])
@pytest.mark.parametrize("design", sorted(probe.DESIGNS))
def test_tiling_visits_match_the_visible_pairs(design, kind, causal, T):
    B, H = 2, 3
    counted = probe.tiling(kind, design, B, H, T, causal)
    cta_tiles, group_tiles = _brute(kind, design, T, causal)
    assert counted["cta_tiles"] == B * H * cta_tiles
    assert counted["group_tiles"] == B * H * group_tiles
    d = probe.DESIGNS[design]
    assert counted["ctas"] == B * H * -(-T // d["rows"])
    assert counted["loop_barriers"] == d["barriers"][kind] * counted["cta_tiles"]
    assert counted["split_tiles"] == (2 * counted["cta_tiles"] if d["cta_split"] else 0)
    deltas = d["delta_exchanges"] * B * H * -(-T // 16) if kind == "dq" else 0
    assert counted["exchanges"] == d["exchanges"][kind] * counted["group_tiles"] + deltas
    assert counted["named_barriers"] == d["exchange_barriers"][kind] * counted["exchanges"]


def test_the_redesign_takes_fewer_barriers_and_no_cta_split():
    """At the timed shape the design loads half the (CTA, tile) visits of
    the parent's, splits no tile CTA-wide, and takes a quarter (forward) or
    an eighth (dQ, dK/dV) of its loops' barriers."""
    B, T = probe.SHAPE["B"], probe.SHAPE["T"]
    for H, _ in probe.TIMED:
        for kind, ratio in (("fwd", 4), ("dq", 8), ("dkdv", 8)):
            old = probe.tiling(kind, "parent", B, H, T)
            new = probe.tiling(kind, "wide", B, H, T)
            assert new["split_tiles"] == 0 and old["split_tiles"] == 2 * old["cta_tiles"]
            assert 2 * new["cta_tiles"] == old["cta_tiles"]
            assert ratio * new["loop_barriers"] == old["loop_barriers"]
            assert new["exchanges"] < old["exchanges"]


def _tf32_rna(x):
    """x rounded to TF32 to nearest, ties away (the kernels' big)."""
    return ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _tf32_trunc(x):
    """x truncated to TF32, as the tensor cores read an operand."""
    return (x.view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)


def test_truncated_small_splits_big_plus_small_back():
    """A one-key row's O is big(v) + small(v) of its key's row v (the
    forward's P V with P = 1).  With small the f32 remainder that the tensor
    cores truncate (``split_t``), splitting that sum gives big and small
    back, so the row's delta takes its dPd's very products and its dS is
    exactly 0; with small rounded to nearest (the attention_tf32.cuh split)
    about 1.2e-4 of random normal values split otherwise."""
    v = np.random.default_rng(0).standard_normal(1 << 21).astype(np.float32)
    for rounded in (False, True):
        big = _tf32_rna(v)
        rest = (v - big).astype(np.float32)
        small = _tf32_rna(rest) if rounded else _tf32_trunc(rest)
        o = (big + small).astype(np.float32)
        big2 = _tf32_rna(o)
        rest2 = (o - big2).astype(np.float32)
        small2 = _tf32_rna(rest2) if rounded else _tf32_trunc(rest2)
        moved = np.mean((big2 != big) | (small2 != small))
        if rounded:
            assert 5e-5 < moved < 5e-4
        else:
            assert moved == 0.0
