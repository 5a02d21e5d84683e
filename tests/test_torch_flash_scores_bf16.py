"""K4's bf16 scores path on wgmma (``csrc/attention_scores_tc.cuh``) on the
CPU: the crossover ``BF16_SCORES_FROM``, the header's sizes, the launch
grid and the contractions per dtype at the models' shapes, and the bf16
path held against the JAX package's ``_flash_attention`` through the plain
versions at Dh 512 (the flagship's hidden 512 at one head) and 2560
(hidden 2560 at one head), bf16 forward 0.02 and gradients 0.03.
"""

import re
from pathlib import Path

import pytest
import torch

from kokoro_tpu_torch.ops import flash_attention as port
from kokoro_tpu_torch.ops import flash_scores as fs
# the head dims at which the crossover is measured
from kokoro_tpu_torch.scripts.probe_flash_scores_tf32 import SAMPLED

HEADER = Path(fs.__file__).resolve().parents[1] / "csrc" / "attention_scores_tc.cuh"
SMEM_LIMIT = 232448  # an H100 CTA's shared memory


def test_bf16_crossover_is_a_sampled_head_dim_at_most_1088():
    assert port.BF16_SCORES_FROM in SAMPLED and port.BF16_SCORES_FROM <= 1088
    # the packed kernels' head dims never move
    assert not port.scores_path(64, torch.bfloat16) and not port.scores_path(128, torch.bfloat16)


def _constants():
    text = HEADER.read_text()
    return {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}, text


def test_header_sizes():
    """A chunk of 64 bf16 is 128 bytes (one row of the 128-byte swizzle); a
    CTA holds a 128 x 128 tile (two warpgroups of 64 rows, m64n128k16
    products with both operands in shared memory, K-major or MN-major by the
    transpose bits); the ring's stages of an A and a B box, 1 KB of
    alignment and the barriers fit a CTA."""
    c, text = _constants()
    assert (c["kTile"], c["kChunk"]) == (fs.TILE, fs.BF16_CHUNK) == (128, 64)
    assert c["kChunk"] * 2 == 128
    assert c["kConsumers"] * 64 == c["kTile"] == fs.cta_rows(torch.bfloat16)
    assert c["kChunk"] == 16 * c["kSteps"]
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in text
    # the three layouts: over the head dim both K-major, over keys B MN-major,
    # over queries both MN-major
    for bits in ("wgmma<0, 0>", "wgmma<0, 1>", "wgmma<1, 1>"):
        assert bits in text
    stage = 2 * c["kTile"] * c["kChunk"] * 2  # an A and a B box of 128 x 64 bf16
    assert 1024 + c["kStages"] * stage + 2 * c["kStages"] * 8 <= SMEM_LIMIT
    assert c["kStages"] >= 3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("Dh", [512, 1536, 2560])
def test_grid_and_contractions_at_the_models_shape(Dh, dtype):
    """B=12 T=1408 causal at one head: 66 score tiles a head, one CTA each,
    11 row tiles of 128 a product, Dh / 128 strips; the products over keys
    contract each query tile up to its diagonal and those over queries each
    key tile from its first key on, in whole chunks of the dtype's 128
    bytes (22 chunks of 64 bf16, 44 of 32 f32, for the longest)."""
    chunk = fs.chunk_of(dtype)
    assert chunk * (2 if dtype == torch.bfloat16 else 4) == 128
    assert fs.grid(1408, 1408, Dh, True, dtype) == {
        "score_tiles": 66, "ctas_a_tile": 1, "query_rows": 11, "key_rows": 11,
        "strips": Dh // 128, "chunk": chunk}
    for i in range(11):
        r0 = 128 * i
        assert fs.apply_range(r0, 128, 1408, 1408, True, False, chunk) == (0, r0 + 128)
        assert fs.apply_range(r0, 128, 1408, 1408, True, True, chunk) == (r0, 1408)
    assert fs.apply_range(1280, 128, 1408, 1408, True, False, chunk)[1] // chunk == 1408 // chunk
    # a ragged T: the last tile's contraction rounded up to a whole chunk
    k0, k1 = fs.apply_range(1408, 128, 1433, 1433, True, False, chunk)
    assert (k0, k1) == (0, -(-1433 // chunk) * chunk) and k1 <= fs.padded(1433)


# -- the bf16 path against the JAX package (plain versions on the CPU) ------------
@pytest.mark.parametrize("Dh,causal,masks", [
    (512, True, "suffix"),
    (2560, False, "interior"),
])
def test_bf16_path_matches_library(Dh, causal, masks):
    """Head dims the wrappers give the bf16 scores kernels: the port's plain
    versions (what a CPU tensor runs) against the JAX package's
    ``_flash_attention`` at B=1, H=1, T=1024, forward bf16 0.02 and
    gradients 0.03."""
    from tests.test_torch_flash import hold_plain_against_library

    assert port.scores_path(Dh, torch.bfloat16)
    hold_plain_against_library(1024, Dh, "bfloat16", causal, masks, B=1, H=1)
