"""K4's f32 scores path on wgmma (``csrc/attention_scores_tf32.cuh``) on the
CPU: the wrappers' route per dtype (``scores_path``), the header's sizes,
a numpy emulation of its 3xTF32 split and accumulation, and the f32 path
held against the JAX package's ``_flash_attention`` through the plain
versions at the crossover ``F32_SCORES_FROM`` and past head dim 2048.

The emulation: TF32 is an f32 with its low 13 bits masked; big is x
rounded to TF32 (nearest, ties away), small is x - big truncated to TF32,
as the kernels' ``split``; a product is three products a k-step of 8
(big.small, small.big, big.big), each chunk of 32 summed into a fresh
accumulator (its additions truncated toward zero, a pessimistic model of
the tensor cores' own accumulation) and added to the sum in f32.  Its error
over a 2560-long contraction stays inside the f32 forward tolerance, 2e-5
abs and rel (docs/attention_numerics_tpu.json ``tolerances``), and a row
whose one visible key makes O its key's V row (P~ = 1) gets its delta
(dO . O) equal to its dP (dO . V) bit for bit, so its dS is exactly 0.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kokoro_tpu_torch.ops import flash_attention as port
from kokoro_tpu_torch.ops import flash_scores as fs

HEADER = Path(fs.__file__).resolve().parents[1] / "csrc" / "attention_scores_tf32.cuh"
# the head dims at which chip_smoke.py measures the crossover
SAMPLED = (192, 256, 320, 384, 512, 768, 1024, 1088, 1536, 2048)
F32_TOL = 2e-5
SMEM_LIMIT = 232448  # an H100 CTA's shared memory


@pytest.mark.parametrize("Dh", [64, 128, *SAMPLED, 2112, 2560, 4096, 8192])
def test_route_per_dtype(Dh):
    """Each dtype from its crossover on (f32 ``F32_SCORES_FROM``, bf16
    ``BF16_SCORES_FROM``), Dh 64 and 128 (the packed kernels' head dims)
    never."""
    f32, bf16 = port.scores_path(Dh, torch.float32), port.scores_path(Dh, torch.bfloat16)
    assert bf16 == (Dh >= port.BF16_SCORES_FROM)
    assert f32 == (Dh >= port.F32_SCORES_FROM)
    if Dh in (64, 128):
        assert not f32 and not bf16


def test_crossover_is_a_sampled_head_dim_at_most_1088():
    assert port.F32_SCORES_FROM in SAMPLED and port.F32_SCORES_FROM <= 1088


def _constants():
    text = HEADER.read_text()
    return {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}, text


def test_header_sizes():
    """A chunk of 32 f32 is 128 bytes (one row of the 128-byte swizzle); a
    CTA holds a 128 x 128 tile (two warpgroups of 64 rows, m64n128 products);
    each kernel's shared memory (1 KB of alignment, its stages of A raw, B
    and B small, the backward's parked P, the barriers) fits a CTA."""
    c, text = _constants()
    assert (c["kTile"], c["kChunk"]) == (fs.TILE, fs.CHUNK) == (128, 32)
    assert c["kChunk"] * 4 == 128
    assert c["kConsumers"] * 64 == c["kTile"] == fs.cta_rows(torch.float32)
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in text
    stage = 3 * c["kTile"] * c["kChunk"] * 4
    park = c["kConsumers"] * c["kWG"] * 64 * 4
    fwd = 1024 + c["kFwdStages"] * stage + 2 * c["kFwdStages"] * 8
    bwd = 1024 + c["kBwdStages"] * stage + park + 2 * c["kBwdStages"] * 8
    assert max(fwd, bwd) <= SMEM_LIMIT
    assert c["kFwdStages"] >= 3 and c["kBwdStages"] >= 2


@pytest.mark.parametrize("Dh", [1536, 2560])
def test_grid_at_the_models_shape(Dh):
    """B=12 T=1408 causal at one head: 66 score tiles a head, one CTA each,
    11 row tiles of 128 a product, a strip of 128 head-dim columns each."""
    assert fs.grid(1408, 1408, Dh, True, torch.float32) == {
        "score_tiles": 66, "ctas_a_tile": 1, "query_rows": 11, "key_rows": 11,
        "strips": Dh // 128, "chunk": 32}


# -- the split, emulated ---------------------------------------------------------
MASK = np.uint32(0xFFFFE000)


def split(x):
    """(big, small) of f32 ``x`` as the kernels' ``split``."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    big = ((bits + np.uint32(0x1000)) & MASK).view(np.float32)
    small = ((np.asarray(x, np.float32) - big).view(np.uint32) & MASK).view(np.float32)
    return big, small


def _trunc32(x):
    """float64 -> float32 toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def product(a, b, chunk=32, step=8):
    """sum_k a[..., k] b[..., k] (rows of a against rows of b) as the
    kernels take it: 3xTF32 a k-step, a fresh accumulator a chunk whose
    additions truncate, the chunks added in f32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for c0 in range(0, a.shape[1], chunk):
        part = np.zeros_like(acc)
        for k0 in range(c0, c0 + chunk, step):
            sl = slice(k0, k0 + step)
            for x, y in ((ab, bs), (as_, bb), (ab, bb)):
                terms = x[:, None, sl].astype(np.float64) * y[None, :, sl].astype(np.float64)
                part = _trunc32(part.astype(np.float64) + terms.sum(-1))
        acc = acc + part
    return acc


def test_split_gives_big_and_small_back():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(200_000).astype(np.float32) * np.exp2(rng.integers(-20, 20, 200_000))
    x = x.astype(np.float32)
    # ties of the rounding (low 13 bits exactly 0x1000) and values just
    # below a power of two, whose big rounds into the next binade
    x[:1000] = (x[:1000].view(np.uint32) & MASK | np.uint32(0x1000)).view(np.float32)
    x[1000:2000] = np.nextafter(np.exp2(rng.integers(-5, 5, 1000)).astype(np.float32),
                                np.float32(0))
    big, small = split(x)
    assert not np.any(big.view(np.uint32) & ~MASK) and not np.any(small.view(np.uint32) & ~MASK)
    o = big + small  # exact in f32
    assert np.array_equal(o.astype(np.float64), big.astype(np.float64) + small)
    big2, small2 = split(o)
    assert np.array_equal(big2.view(np.uint32), big.view(np.uint32))
    assert np.array_equal(small2.view(np.uint32), small.view(np.uint32))


def test_emulated_product_over_2560_within_the_f32_tolerance():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 2560)).astype(np.float32)
    b = rng.standard_normal((16, 2560)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64).T
    got = product(a, b).astype(np.float64)
    assert np.all(np.abs(got - ref) <= F32_TOL + F32_TOL * np.abs(ref))
    # and a scaled score (1 / sqrt(Dh)), as the kernels' logits
    assert np.max(np.abs(got - ref)) / np.sqrt(2560) < F32_TOL


def test_one_key_row_delta_equals_its_dp_bit_for_bit():
    """O = P~ V with P~ = 1 at the one visible key: O's row is big + small
    of that key's V row; the delta dO . O then takes dP's very split and
    products, so dP - delta is exactly 0."""
    rng = np.random.default_rng(2)
    Dh = 2560
    v = (rng.standard_normal((8, Dh)) * np.exp2(rng.integers(-8, 8, (8, Dh)))).astype(np.float32)
    do = rng.standard_normal((8, Dh)).astype(np.float32)
    p = np.eye(8, dtype=np.float32)  # each row's one visible key
    # O^T = V^T P~^T (A the head-dim operand, B the weights, as the kernel
    # takes it): row i of O sums over keys, one of them weight 1
    o = product(v.T.copy(), p).T
    big, small = split(v)
    assert np.array_equal(o, big + small)
    dp = product(do, v)
    delta = product(do, o)
    assert np.array_equal(np.diag(dp).view(np.uint32), np.diag(delta).view(np.uint32))


# -- the f32 path against the JAX package (plain versions on the CPU) -------------
@pytest.mark.parametrize("Dh,causal,masks", [
    (port.F32_SCORES_FROM, True, "suffix"),
    (3072, False, "interior"),
])
def test_f32_path_matches_library(Dh, causal, masks):
    """The head dims the wrappers give the f32 scores kernels: the port's
    plain versions (what a CPU tensor runs) against the JAX package's
    ``_flash_attention`` at B=1, H=1, T=1024, forward f32 2e-5 and
    gradients 1e-4."""
    from tests.test_torch_flash import hold_plain_against_library

    assert port.scores_path(Dh, torch.float32)
    hold_plain_against_library(1024, Dh, "float32", causal, masks, B=1, H=1)
