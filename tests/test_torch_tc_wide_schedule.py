"""The schedule model of ``probe_flash_tc_wide`` against a brute-force count,
and against the kernels' own constants.

``schedule`` counts what a call of K4's bf16 kernels at head dims 192 and 256
does under a design (``templates``: the Dh 64/128 templates instantiated at
these head dims; ``wide``: ``csrc/attention_tc_wide.cuh``'s): the (CTA, streamed tile)
and (64-row warpgroup, streamed tile) visits, the products each warpgroup
issues a tile, the tiles in flight when a consumer starts one, and each
kernel's shared memory; PERF.md's account of those kernels rests on it.
Here the visits are held against the (query, key) pairs a causal or full
call computes, enumerated one by one: a CTA loads a streamed tile, and a
warpgroup computes it, exactly when the tile holds a visible pair of theirs.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from kokoro_tpu_torch.scripts import probe_flash_tc_wide as probe

DESIGNS = ("templates", "wide")
KINDS = ("fwd", "dq", "dkdv")
HEADER = Path(probe.__file__).resolve().parents[1] / "csrc" / "attention_tc_wide.cuh"


def _rows(design, kind):
    """Rows (queries, or the dK/dV kernel's keys) a CTA owns."""
    return 128 if kind == "fwd" or (kind == "dq" and design == "wide") else 64


def _brute(design, kind, T, causal):
    """(cta_tiles, group_tiles) of one head, from the visible pairs."""
    rows = _rows(design, kind)
    q, k = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    visible = (k <= q) if causal else np.ones_like(q, dtype=bool)
    q, k = q[visible], k[visible]
    if kind == "dkdv":  # a CTA owns 64 keys; both warpgroups share them
        owner = group = k // rows
        first = owner * rows if causal else np.zeros_like(owner)
        tile = (q - first) // 64
    else:
        owner, group, tile = q // rows, q // 64, k // 64
    cta_tiles = len(set(zip(owner.tolist(), tile.tolist())))
    group_tiles = len(set(zip(group.tolist(), tile.tolist())))
    return cta_tiles, group_tiles


@pytest.mark.parametrize("T", [1, 63, 64, 100, 129, 257, 1408])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("design", DESIGNS)
def test_schedule_visits_match_the_visible_pairs(design, kind, causal, T):
    B, H = 2, 3
    counted = probe.schedule(design, kind, 256, B, H, T, causal)
    cta_tiles, group_tiles = _brute(design, kind, T, causal)
    assert counted["cta_tiles"] == B * H * cta_tiles
    assert counted["group_tiles"] == B * H * group_tiles
    assert counted["ctas"] == B * H * -(-T // _rows(design, kind))
    per_tile = counted["products_per_tile"]
    per_group = sum(per_tile.values()) if kind == "dkdv" else max(per_tile.values())
    assert counted["products"] == per_group * counted["group_tiles"]


@pytest.mark.parametrize("Dh", [192, 256])
def test_the_new_dkdv_kernel_takes_four_products_a_tile(Dh):
    """The templates' dK/dV warpgroups both compute S^T: five products a
    tile, three on the dK warpgroup; the wide design hands P^T over: two
    each."""
    old = probe.schedule("templates", "dkdv", Dh, 12, 2, 1408)
    new = probe.schedule("wide", "dkdv", Dh, 12, 2, 1408)
    assert old["products_per_tile"] == {"dv": 2, "dk": 3}
    assert new["products_per_tile"] == {"dv": 2, "dk": 2}
    assert 4 * old["products"] == 5 * new["products"]


@pytest.mark.parametrize("Dh", [192, 256])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("design", DESIGNS)
def test_no_design_exceeds_the_shared_memory_of_a_cta(design, kind, Dh):
    assert probe.schedule(design, kind, Dh, 1, 1, 1408)["smem_bytes"] <= probe.SMEM_LIMIT


def test_the_new_forward_has_a_tile_in_flight_at_head_dim_256():
    """The templates' forward stage (K and V of 64 keys) is freed after its
    P V, so with two stages a consumer holds both and none loads; the new
    one frees K after S and keeps V apart."""
    assert probe.schedule("templates", "fwd", 256, 12, 2, 1408)["in_flight"] == 0
    assert probe.schedule("wide", "fwd", 256, 12, 2, 1408)["in_flight"] >= 1
    assert probe.schedule("wide", "fwd", 192, 12, 4, 1408)["in_flight"] >= 1


def _header_constant(name, Dh):
    """A ``DH == 256 ? a : b`` constant of attention_tc_wide.cuh at ``Dh``."""
    body = re.search(rf"constexpr int {name}\(\) {{\s*return DH == 256 \? (\d+) : (\d+);",
                     HEADER.read_text())
    assert body is not None, name
    return int(body.group(1) if Dh == 256 else body.group(2))


@pytest.mark.parametrize("Dh", [192, 256])
def test_the_model_follows_the_kernels_constants(Dh):
    """The model's slots are the header's (``fwd_k_slots`` ...), and its
    shared memory the header's formulas, written out in the same terms."""
    for kind, names in (("fwd", {"k": "fwd_k_slots", "v": "fwd_v_slots"}),
                        ("dq", {"k": "dq_k_slots", "v": "dq_v_slots"}),
                        ("dkdv", {"stages": "dkdv_stages", "p": "p_buffers"})):
        slots = probe.slots("wide", kind, Dh)
        assert slots == {key: _header_constant(name, Dh) for key, name in names.items()}
    text = HEADER.read_text()
    for fn in ("fwd_smem_bytes", "dq_smem_bytes", "dkdv_smem_bytes"):
        assert f"constexpr size_t {fn}()" in text
