"""The schedule of K4's scores-in-memory kernels (``csrc/attention_scores.cuh``,
each dtype's chunk and grid in ``csrc/attention_scores_tc.cuh`` and
``csrc/attention_scores_tf32.cuh``) in plain Python, against the visible
(query, key) pairs enumerated one by one.

``ops/flash_scores.py`` mirrors the launcher's schedule: ``score_tile_count``
and ``score_tile`` (the flat list of (query tile, key tile) the scores kernel
takes), ``apply_range`` (the contraction of the products over keys, O and
dQ, and over queries, dK and dV) and ``dh_strips`` (the head dim's 128-column
strips), and ``grid``, which phase ``kernels_flash`` of ``chip_smoke.py``
holds against the compiled launcher's ``kokoro_flash_attention_scores_grid``
on the card.  Here: the tile list is exactly the tiles holding a visible
pair, each once; every visible pair of a row tile lies in its contraction,
and every workspace cell the contraction reads lies in a listed tile or past
Tq / Tk (zero-filled or written zero); the strips cover the head dim once,
a ragged last strip 64 wide; the constants are the header's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kokoro_tpu_torch.ops import flash_scores as fs

HEADER = Path(fs.__file__).resolve().parents[1] / "csrc" / "attention_scores.cuh"
TF32_HEADER = HEADER.with_name("attention_scores_tf32.cuh")
BF16_HEADER = HEADER.with_name("attention_scores_tc.cuh")
LENGTHS = [(1, 1), (100, 100), (128, 128), (129, 129), (1024, 1024), (1408, 1408),
           (1433, 1433), (300, 1000), (1000, 300)]


def _visible(Tq, Tk, causal):
    q, k = np.meshgrid(np.arange(Tq), np.arange(Tk), indexing="ij")
    return (k <= q) if causal else np.ones((Tq, Tk), bool)


def _listed(Tq, Tk, causal):
    return [fs.score_tile(t, Tq, Tk, causal) for t in range(fs.score_tile_count(Tq, Tk, causal))]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("Tq,Tk", LENGTHS)
def test_score_tiles_are_the_tiles_with_a_visible_pair(Tq, Tk, causal):
    listed = _listed(Tq, Tk, causal)
    assert len(set(listed)) == len(listed)  # each tile once
    q, k = np.nonzero(_visible(Tq, Tk, causal))
    wanted = set(zip((q // fs.TILE).tolist(), (k // fs.TILE).tolist()))
    assert set(listed) == wanted
    # row by row, as the kernel's map walks them
    assert listed == sorted(listed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("Tq,Tk", LENGTHS)
def test_apply_contractions_cover_the_visible_pairs_and_read_written_tiles(Tq, Tk, causal,
                                                                           dtype):
    rows, chunk = fs.cta_rows(dtype), fs.chunk_of(dtype)
    visible = _visible(Tq, Tk, causal)
    written = set(_listed(Tq, Tk, causal))

    def readable(qr, kc):  # a workspace cell apply may read
        return qr >= Tq or kc >= Tk or (qr // fs.TILE, kc // fs.TILE) in written

    for over_queries, T_rows in ((False, Tq), (True, Tk)):
        for r0 in range(0, T_rows, rows):
            k0, k1 = fs.apply_range(r0, rows, Tq, Tk, causal, over_queries, chunk)
            assert k0 % chunk == 0 and k1 % chunk == 0 and k0 <= k1
            r1 = min(r0 + rows, T_rows)
            if over_queries:  # rows are keys: the queries that see them
                need = np.nonzero(visible[:, r0:r1].any(1))[0]
                assert k1 <= fs.padded(Tq) or k0 == k1  # keys past every query: none
                cells = [(qr, kc) for qr in range(k0, min(k1, Tq)) for kc in (r0, r1 - 1)]
            else:  # rows are queries: the keys they see
                need = np.nonzero(visible[r0:r1].any(0))[0]
                assert k1 <= fs.padded(Tk)
                cells = [(qr, kc) for qr in (r0, r1 - 1) for kc in range(k0, min(k1, Tk))]
            assert need.size == 0 or (k0 <= need.min() and need.max() < k1)
            assert all(readable(qr, kc) for qr, kc in cells)


@pytest.mark.parametrize("Dh", [64, 128, 2112, 2176, 2560, 3072, 4096, 8192])
def test_head_dim_strips_cover_it_once_with_a_ragged_last_strip(Dh):
    strips = fs.dh_strips(Dh)
    cols = np.concatenate([np.arange(n0, n0 + w) for n0, w in strips])
    assert np.array_equal(cols, np.arange(Dh))
    assert all(w == fs.STRIP for _, w in strips[:-1])
    assert strips[-1][1] == (64 if Dh % 128 else 128)
    assert fs.grid(1408, 1408, Dh, True, torch.bfloat16)["strips"] == len(strips)


def test_schedule_constants_are_the_headers():
    text = HEADER.read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert (const["kTile"], const["kChunk"], const["kStrip"]) == (fs.TILE, fs.CHUNK, fs.STRIP)
    # each dtype: two warpgroups of 64 rows and its own chunk
    # (csrc/attention_scores_tc.cuh in bf16, csrc/attention_scores_tf32.cuh in f32)
    for header, dtype in ((BF16_HEADER, torch.bfloat16), (TF32_HEADER, torch.float32)):
        own = {name: int(v) for name, v in
               re.findall(r"constexpr int (k\w+) = (\d+);", header.read_text())}
        assert own["kConsumers"] * 64 == own["kTile"] == fs.cta_rows(dtype)
        assert own["kChunk"] == fs.chunk_of(dtype)


def test_grid_at_the_models_shape():
    """Hidden 2560 at one head (B=12, T=1408, causal): 66 of the 121 score
    tiles a head, 20 strips of the head dim; one CTA a tile in both dtypes
    (two warpgroups of 64 rows on wgmma), the contraction in chunks of 128
    bytes (64 bf16, 32 f32)."""
    g = fs.grid(1408, 1408, 2560, True, torch.bfloat16)
    assert g == {"score_tiles": 66, "ctas_a_tile": 1, "query_rows": 11, "key_rows": 11,
                 "strips": 20, "chunk": 64}
    assert fs.grid(1408, 1408, 2560, True, torch.float32) == {
        "score_tiles": 66, "ctas_a_tile": 1, "query_rows": 11, "key_rows": 11, "strips": 20,
        "chunk": 32}
