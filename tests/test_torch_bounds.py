"""The visible-pair count behind ``chip_smoke.py``'s bounds and TFLOP/s.

``chip_smoke.visible_pairs`` counts the (query, key) pairs an attention call
computes from its shapes, kv lengths or segment ids; the bound and the
achieved TFLOP/s of every timed kernel rest on it.  Here it is held against
the plain versions' own masks, counted by brute force: with q = k = 0 every
visible weight is exactly 1 (or 1/T for a packed row of kv length 0, which
averages every key) and every masked one exactly 0.

Also the readings ``hold_recorded`` adds to each check: ``allclose_ratio``
(what ``close_or_raise``'s allclose decides on) and ``float64_control``
(where an f32 backward's error against the float64 recompute sits).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from kokoro_tpu_torch.ops import flash_attention as flash
from kokoro_tpu_torch.ops import fused_attention as port


def _packed_pairs(B, T, causal, lens):
    """Nonzero weights of the plain packed forward, summed over the batch
    (one head)."""
    z = torch.zeros(B, T, 64)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    p, _ = port._probs_and_keep(z, z, 1, 0.125, causal, kv, 0.0, None)
    return int((p > 0).sum())


def _flash_pairs(B, T, causal, q_seg, kv_seg):
    """Nonzero weights of the plain flash forward (one head)."""
    z = torch.zeros(B, 1, T, 64)
    s, row_visible = flash._logits(z, z, 0.125, causal, q_seg, kv_seg)
    p, _ = flash._weights(s, row_visible)
    return int((p > 0).sum())


@pytest.mark.parametrize("T", [1, 63, 100, 433])
@pytest.mark.parametrize("lens", ["causal", "none", "full", "mixed"])
def test_packed_pairs_match_the_plain_mask(T, lens):
    B = 4
    causal = lens == "causal"
    kv = {"causal": None, "none": None, "full": [T] * B,
          "mixed": [T, max(1, T - 37), T // 2, 0]}[lens]
    assert chip_smoke.visible_pairs(B, T, causal, kv) == _packed_pairs(B, T, causal, kv)


@pytest.mark.parametrize("T", [63, 200])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kind", ["suffix", "interior", "no_visible_key"])
def test_flash_pairs_match_the_plain_mask(T, causal, kind):
    B = 2
    g = torch.Generator().manual_seed(T)
    q_seg = torch.ones(B, T, dtype=torch.int32)
    kv_seg = q_seg.clone()
    if kind == "suffix":
        q_seg[1, T - 17:] = 0
        kv_seg[1, T - 17:] = 0
    elif kind == "interior":
        kv_seg = (torch.rand(B, T, generator=g) > 0.3).to(torch.int32)
    else:  # the first queries of row 1 see only keys of another segment
        kv_seg[1, : T // 3] = 0
    want = _flash_pairs(B, T, causal, q_seg, kv_seg)
    assert chip_smoke.visible_pairs(B, T, causal, segments=(q_seg, kv_seg)) == want
    if kind == "no_visible_key" and causal:
        assert want < chip_smoke.visible_pairs(B, T, causal)  # those rows count nothing


def test_bound_counts_operations_per_pair():
    """4 Dh operations a pair forward and 10 Dh backward, per head; the bound
    is the larger of the bytes' and the operations' times."""
    B, T, H, Dh = 2, 100, 3, 64
    lens = [T, 0]
    pairs = chip_smoke.visible_pairs(B, T, False, lens)
    assert pairs == 2 * T * T  # the length-0 row averages every key
    fwd = chip_smoke.attention_bound(B, T, H, Dh, "bfloat16", False, lens)
    bwd = chip_smoke.attention_bound(B, T, H, Dh, "bfloat16", False, lens, backward=True)
    assert fwd["ops"] == 4 * Dh * H * pairs and bwd["ops"] == 10 * Dh * H * pairs
    for bound, tensors in ((fwd, 4), (bwd, 8)):
        nbytes = tensors * B * T * H * Dh * 2 + (4 * B * H * T if tensors == 8 else 0) + 4 * B
        t_bytes = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        t_ops = bound["ops"] / chip_smoke.PEAK_OPS["bfloat16"] * 1e3
        assert bound["bound_ms"] == pytest.approx(max(t_bytes, t_ops))
        assert bound["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
    row = chip_smoke.timed_row(fwd, 2 * fwd["bound_ms"], plain_ms=1.0)
    assert row["bound_share"] == pytest.approx(0.5)
    assert row["tflops"] == pytest.approx(fwd["ops"] / (row["ms"] * 1e-3) / 1e12)


def test_allclose_ratio_is_what_allclose_decides():
    tol = 1e-4
    ref = torch.tensor([1.0, -50.0, 0.0], dtype=torch.float64)
    out = ref + torch.tensor([1.5e-4, 4e-3, 5e-5], dtype=torch.float64)
    # the worst element is the large one: 4e-3 against 1e-4 + 5e-3
    assert chip_smoke.allclose_ratio(out, ref, tol) == pytest.approx(4e-3 / 5.1e-3)
    assert torch.allclose(out, ref, rtol=tol, atol=tol)
    out[2] = 2e-4  # twice the bound at a zero reference
    assert chip_smoke.allclose_ratio(out, ref, tol) == pytest.approx(2.0)
    assert not torch.allclose(out, ref, rtol=tol, atol=tol)


def test_float64_control_finds_the_one_key_rows_dv():
    """The f32 plain kv-length backward against its float64 recompute on
    ``mixed_lengths``: the largest error sits in dV of a row of kv length 1,
    at its one key, which sums every query's dO (|dV| is tens); that is the
    element ``hold_recorded``'s f32 readings at the bench shapes come from."""
    B, T, H, Dh = 6, 384, 2, 32
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, T, H * Dh)).astype(np.float32))
                   for _ in range(4))
    lens = chip_smoke.mixed_lengths(B, T)
    kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=torch.tensor(lens, dtype=torch.int32))
    plain = port.packed_attention_bwd_reference(q, k, v, do, causal=False, **kw)
    exact = chip_smoke.packed_bwd_float64(q, k, v, do, causal=False, **kw)
    control = chip_smoke.float64_control(plain, plain, exact, lens)
    worst = control["worst"]
    assert (worst["grad"], worst["kv_length"], worst["token"]) == ("dv", 1, 0)
    assert abs(worst["value"]) > 10
    assert control["plain_f32"]["dv"] == worst["abs_err"] < 1e-4
    assert max(control["plain_f32"]["dq"], control["plain_f32"]["dk"]) < 1e-5
