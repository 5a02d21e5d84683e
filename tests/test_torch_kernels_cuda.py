"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so it runs on the machine with the
card:  python -m pytest tests/test_torch_kernels_cuda.py -q
Every test here is marked ``cuda`` and skips where CUDA is missing.
Tolerances: forward f32 2e-5 and bf16 2e-2, gradients f32 1e-4 and bf16
3e-2, abs/rel, the reference's own tolerances
(docs/attention_numerics_tpu.json ``tolerances``); the plain version runs
with TF32 off.
"""

import ctypes
import json
import os
import subprocess
import sys

import pytest
import torch

from kokoro_tpu_torch.ops import flash_attention as flash
from kokoro_tpu_torch.ops import flash_scores
from kokoro_tpu_torch.ops import fused_attention as port

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, T, H, Dh, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(B, T, H * Dh, generator=g).to(device, dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [1, 63, 128, 200, 432, 433])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "kvlen"])
def test_packed_attention_kernel_matches_plain(cuda, dtype, Dh, T, causal):
    B, H = 3, 2
    q, k, v = _qkv(B, T, H, Dh, dtype, cuda, seed=T + Dh)
    lens = torch.tensor([max(1, T // 3), T, max(1, T - 5)], dtype=torch.int32, device=cuda)
    kw = dict(num_heads=H, scale=Dh ** -0.5, causal=causal,
              kv_lengths=None if causal else lens)
    before = port.total_launches()
    out = port.packed_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert port.total_launches() == before + 1
    ref = port.packed_attention_reference(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_all_masked_rows_average_uniformly(cuda):
    q, k, v = _qkv(2, 100, 1, 64, torch.float32, cuda, seed=5)
    lens = torch.tensor([0, 100], dtype=torch.int32, device=cuda)
    out = port.packed_attention(q, k, v, num_heads=1, scale=0.125, causal=False, kv_lengths=lens)
    ref = port.packed_attention_reference(q, k, v, num_heads=1, scale=0.125, causal=False,
                                          kv_lengths=lens)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


def test_kernel_refuses_non_contiguous(cuda):
    q = torch.zeros(1, 128, 256, device=cuda)[:, :, :128]
    with pytest.raises(ValueError, match="contiguous"):
        port.packed_attention_causal(q, q, q, num_heads=2, scale=1.0)


GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [1, 63, 200, 432, 433])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "kvlen"])
def test_backward_kernel_matches_plain(cuda, causal, T, Dh, dtype, rate):
    """Forward (with its lse) and backward kernels through the autograd
    Function against the plain forward and backward, a length-0 row included."""
    B, H = 3, 2
    q, k, v = _qkv(B, T, H, Dh, dtype, cuda, seed=2 * T + Dh)
    do = torch.randn(B, T, H * Dh, generator=torch.Generator().manual_seed(T)).to(cuda, dtype)
    lens = torch.tensor([max(1, T // 3), T, 0], dtype=torch.int32, device=cuda)
    kw = dict(num_heads=H, scale=Dh ** -0.5, causal=causal, kv_lengths=None if causal else lens,
              dropout_rate=rate, seed=77 if rate else None)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = [kern.launches for kern in port.KERNELS]
    out = port.packed_attention(*leaves, **kw)
    out.backward(do)
    torch.cuda.synchronize()
    fwd, bwd = (0, 2) if causal else (1, 3)
    assert [kern.launches - b for kern, b in zip(port.KERNELS, before)] == [
        int(i in (fwd, bwd)) for i in range(len(port.KERNELS))]
    ref = port.packed_attention_reference(q, k, v, **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    grads = port.packed_attention_bwd_reference(q, k, v, do, **kw)
    tol = GRAD_TOL[dtype]
    for name, a, b in zip("qkv", grads, leaves):
        assert b.grad.dtype == dtype
        torch.testing.assert_close(b.grad.float(), a.float(), rtol=tol, atol=tol, msg=f"d{name}")


def _assert_dropout_mask_is_the_plain_mask(device, dtype, data_seed, seed):
    """Identity-block values read out the forward kernel's dropped weights;
    their pattern is the plain Philox mask, and the same seed repeats it."""
    B, H, T, Dh, rate = 2, 2, 128, 64, 0.1
    q, k, _ = (x * 0.1 for x in _qkv(B, T, H, Dh, dtype, device, seed=data_seed))
    kw = dict(num_heads=H, scale=Dh ** -0.5, causal=False, dropout_rate=rate, seed=seed)
    blocks = []
    for j0 in range(0, T, Dh):
        blk = torch.zeros(B, T, H * Dh, device=device, dtype=dtype)
        for h in range(H):
            blk[:, j0:j0 + Dh, h * Dh:(h + 1) * Dh] = torch.eye(Dh, device=device, dtype=dtype)
        out = port.packed_attention(q, k, blk, **kw)
        assert torch.equal(out, port.packed_attention(q, k, blk, **kw))
        blocks.append(out.reshape(B, T, H, Dh))
    pd = torch.cat(blocks, -1).permute(0, 2, 1, 3)
    from kokoro_tpu_torch.ops.philox import attention_keep_mask

    assert torch.equal(pd != 0, attention_keep_mask(seed, B, H, T, rate, device=device))


def test_dropout_mask_is_the_plain_mask(cuda):
    _assert_dropout_mask_is_the_plain_mask(cuda, torch.float32, data_seed=4, seed=2 ** 40 + 5)


@pytest.mark.parametrize("masks", ["none", "suffix"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [1, 63, 200, 433, 1024])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_kernels_match_plain(cuda, causal, T, Dh, dtype, masks):
    """K4 forward and backward through the autograd Function against the
    plain forward and backward."""
    B, H = 2, 2
    g = torch.Generator().manual_seed(3 * T + Dh)
    q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(cuda, dtype) for _ in range(4))
    valid = None
    if masks == "suffix":
        valid = torch.arange(T, device=cuda)[None, :] < torch.tensor(
            [[T], [max(1, T - 17)]], device=cuda)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = [kern.launches for kern in flash.KERNELS]
    out = flash.flash_attention(*leaves, causal=causal, scale=Dh ** -0.5, q_valid=valid,
                                kv_valid=valid)
    out.backward(do)
    torch.cuda.synchronize()
    assert [kern.launches - b for kern, b in zip(flash.KERNELS, before)] == [1, 1]
    q_seg, kv_seg = flash.segment_ids(q, k, valid, valid)
    kw = dict(causal=causal, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    ref = flash.flash_attention_reference(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    grads = flash.flash_attention_bwd_reference(q, k, v, out.detach(), do, **kw)
    for name, a, b in zip("qkv", grads, leaves):
        torch.testing.assert_close(b.grad.float(), a.float(), rtol=GRAD_TOL[dtype],
                                   atol=GRAD_TOL[dtype], msg=f"d{name}")


def _wide_flash_inputs(cuda, T, Dh, dtype, masks, seed):
    """(q, k, v, do, q_valid, kv_valid) of a K4 case at B=2, H=2: suffix
    padding on both sides, or interior padding on the keys with every query
    valid."""
    B, H = 2, 2
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(cuda, dtype) for _ in range(4))
    if masks == "suffix":
        q_valid = kv_valid = torch.arange(T, device=cuda)[None, :] < torch.tensor(
            [[T], [T - 301]], device=cuda)
    else:
        kv_valid = torch.rand(B, T, generator=g) > 0.3
        kv_valid[:, 0] = True
        kv_valid = kv_valid.to(cuda)
        q_valid = torch.ones(B, T, dtype=torch.bool, device=cuda)
    return q, k, v, do, q_valid, kv_valid


def _hold_flash_against_plain(q, k, v, do, q_valid, kv_valid, causal=True):
    """One forward and one backward kernel launch through the autograd
    Function, against the plain forward and backward."""
    dtype, Dh = q.dtype, q.shape[-1]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = [kern.launches for kern in flash.KERNELS]
    out = flash.flash_attention(*leaves, causal=causal, scale=Dh ** -0.5, q_valid=q_valid,
                                kv_valid=kv_valid)
    out.backward(do)
    torch.cuda.synchronize()
    assert [kern.launches - b for kern, b in zip(flash.KERNELS, before)] == [1, 1]
    q_seg, kv_seg = flash.segment_ids(q, k, q_valid, kv_valid)
    kw = dict(causal=causal, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    ref = flash.flash_attention_reference(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    grads = flash.flash_attention_bwd_reference(q, k, v, out.detach(), do, **kw)
    for name, a, b in zip("qkv", grads, leaves):
        torch.testing.assert_close(b.grad.float(), a.float(), rtol=GRAD_TOL[dtype],
                                   atol=GRAD_TOL[dtype], msg=f"d{name}")


@pytest.mark.parametrize("masks", ["suffix", "interior"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", [192, 256])
@pytest.mark.parametrize("T", [1024, 1408, 1433])
def test_flash_kernels_at_head_dims_192_and_256_match_plain(cuda, T, Dh, dtype, masks):
    """K4 at the head dims past the packed kernels' (causal, the long path's
    regime) against the plain forward and backward."""
    _hold_flash_against_plain(*_wide_flash_inputs(cuda, T, Dh, dtype, masks, 5 * T + Dh))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", [192, 256])
@pytest.mark.parametrize("T", [1, 100, 1100])
def test_flash_kernels_at_head_dims_192_and_256_noncausal(cuda, T, Dh, dtype):
    """K4 at Dh 192 and 256 without the causal mask, at lengths inside one
    streamed tile and past a ragged last one, against the plain forward and
    backward."""
    _hold_flash_against_plain(*_wide_flash_inputs(cuda, T, Dh, dtype, "suffix" if T > 301 else
                                                  "interior", 11 * T + Dh), causal=False)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("Dh", [192, 256])
def test_f32_flash_one_key_rows_at_head_dims_192_and_256(cuda, Dh, causal):
    """Rows that see exactly one key (segment ids of their own, shared with
    that key alone; at and beside the 32-row tile edges): the forward's lse
    gives the backward's recompute the key's weight 1 exactly and the row's
    delta equals its dPd exactly, so its dS is exactly 0 and its dQ row is
    exactly zero; O and every gradient, the key's dK and dV included, within
    the f32 tolerances of the plain version."""
    B, H, T = 2, 2, 1433
    g = torch.Generator().manual_seed(Dh + causal)
    q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(cuda, F32) for _ in range(4))
    rows = [0, 31, 32, 47, 700, T - 1]
    q_seg = torch.ones(B, T, dtype=torch.int32, device=cuda)
    for i, r in enumerate(rows):
        q_seg[:, r] = 2 + i
    kv_seg = q_seg.clone()  # key r alone shares row r's segment
    kw = dict(causal=causal, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    dq, dk, dv = flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq[:, :, rows], torch.zeros_like(dq[:, :, rows]))
    torch.testing.assert_close(o, flash.flash_attention_reference(q, k, v, **kw), rtol=TOL[F32],
                               atol=TOL[F32])
    ref = flash.flash_attention_bwd_reference(q, k, v, o, do, **kw)
    for name, a, b in zip("qkv", ref, (dq, dk, dv)):
        torch.testing.assert_close(b, a, rtol=GRAD_TOL[F32], atol=GRAD_TOL[F32], msg=f"d{name}")
    # the one-key rows' keys take their gradient from their own row alone
    for name, a, b in zip("kv", ref[1:], (dk, dv)):
        torch.testing.assert_close(b[:, :, rows], a[:, :, rows], rtol=GRAD_TOL[F32],
                                   atol=GRAD_TOL[F32], msg=f"d{name} at the one-key rows' keys")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("Dh", [192, 256])
def test_bf16_flash_rows_with_zero_or_one_key_at_head_dims_192_and_256(cuda, Dh, causal):
    """bf16 K4 at Dh 192 and 256 (csrc/attention_tc_wide.cuh) with segment
    ids that leave rows seeing one key (a segment shared with that key
    alone, at and beside the 64- and 128-row tile edges) and rows seeing none
    (a segment no key has): O and every gradient against the plain version;
    a row with no key has O = 0, lse = +inf and dQ = 0; two calls bit for bit
    equal."""
    B, H, T = 2, 2, 1433
    g = torch.Generator().manual_seed(3 * Dh + causal)
    q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(cuda, BF16) for _ in range(4))
    one, none = [0, 63, 64, 127, 128, 700, T - 1], [5, 200, 1300]
    q_seg = torch.ones(B, T, dtype=torch.int32, device=cuda)
    for i, r in enumerate(one):
        q_seg[:, r] = 2 + i
    kv_seg = q_seg.clone()  # key r alone shares row r's segment
    for r in none:
        q_seg[:, r] = 100 + r  # no key's segment
    kw = dict(causal=causal, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    runs = []
    for _ in range(2):
        o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        runs.append((o, lse, *flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name
    o, lse, dq, dk, dv = runs[0]
    assert torch.equal(o[:, :, none], torch.zeros_like(o[:, :, none]))
    assert torch.isinf(lse[:, :, none]).all() and torch.isfinite(lse[:, :, one]).all()
    assert torch.equal(dq[:, :, none], torch.zeros_like(dq[:, :, none]))
    torch.testing.assert_close(o.float(), flash.flash_attention_reference(q, k, v, **kw).float(),
                               rtol=TOL[BF16], atol=TOL[BF16])
    ref = flash.flash_attention_bwd_reference(q, k, v, o, do, **kw)
    for name, a, b in zip("qkv", ref, (dq, dk, dv)):
        torch.testing.assert_close(b.float(), a.float(), rtol=GRAD_TOL[BF16],
                                   atol=GRAD_TOL[BF16], msg=f"d{name}")


def test_kernel_outputs_bit_for_bit_the_parents(cuda):
    """With ``KOKORO_PARENT_TREE`` naming a checkout of an earlier tree:
    ``probe_flash_tf32_wide --digests`` builds both trees' kernels and hashes
    every kernel's outputs (packed, folded, flash at Dh 64-1024, bf16 and
    f32, the head dims both trees take); every case is the earlier tree's
    bit for bit (the cluster exchange's slots are sized for clusters of up
    to 16, and its sums are the same rank-order sums).  The wrappers'
    outputs at the digests' head dims from each dtype's crossover on (f32
    ``F32_SCORES_FROM``, bf16 ``BF16_SCORES_FROM``) are not compared: the
    wrappers take the scores path there, whose kernels
    (``csrc/attention_scores_tf32.cuh``, ``csrc/attention_scores_tc.cuh``)
    sum in another order than the on-chip kernels; those on-chip kernels are
    compared there instead, called directly (``flash_onchip``)."""
    parent = os.environ.get("KOKORO_PARENT_TREE")
    if not parent:
        pytest.skip("set KOKORO_PARENT_TREE to a checkout of the tree to compare with")
    proc = subprocess.run([sys.executable, "-m", "kokoro_tpu_torch.scripts.probe_flash_tf32_wide",
                           "--digests", "--parent", parent], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["cases"] == len(result["equal"]) + len(result["differ"])
    assert result["differ"] == [], result["differ"]
    from kokoro_tpu_torch.scripts.probe_flash_tf32_wide import DIGEST_HEAD_DIMS

    onchip = {f"flash_onchip/{str(dtype).split('.')[1]}/Dh={Dh}/causal={c}"
              for dtype in (F32, BF16) for Dh in DIGEST_HEAD_DIMS for c in (True, False)
              if flash.scores_path(Dh, dtype)}
    assert onchip <= set(result["equal"]), sorted(onchip - set(result["equal"]))


# one head dim of every cluster size past the portable 8: 9 CTAs (1088, its
# last slice ragged) to 16 (2048)
PAST_1024 = [1088, 1152, 1280, 1408, 1536, 1664, 1792, 1920, 2048]


@pytest.mark.parametrize("masks", ["suffix", "interior"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", [320, 384, 512, 640, 768, 896, 1024, *PAST_1024])
@pytest.mark.parametrize("T", [1024, 1433])
def test_flash_kernels_past_head_dim_256_match_plain(cuda, T, Dh, dtype, masks):
    """K4 where a cluster of ceil(Dh / 128) CTAs splits the head dim by
    columns (the last slice ragged at 320, 896 and 1088; clusters of 5, 6
    and 7 CTAs at 640, 768 and 896, whose exchanged tiles split unevenly;
    past 1024 clusters of 9 to 16, larger than the portable 8; f32 from
    ``F32_SCORES_FROM`` on through the scores path), causal, against the
    plain forward and backward."""
    _hold_flash_against_plain(*_wide_flash_inputs(cuda, T, Dh, dtype, masks, 7 * T + Dh))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", [448, 640, 768, 896, *PAST_1024])
def test_flash_cluster_kernels_noncausal_and_bitwise(cuda, Dh, dtype):
    """The cluster kernels (f32 from ``F32_SCORES_FROM`` on: the scores
    path) without the causal mask at a ragged T, against the plain
    versions, and two calls bit for bit equal (each CTA sums the cluster's
    partials in rank order)."""
    q, k, v, do, q_valid, kv_valid = _wide_flash_inputs(cuda, 1100, Dh, dtype, "suffix", Dh)
    _hold_flash_against_plain(q, k, v, do, q_valid, kv_valid, causal=False)
    q_seg, kv_seg = flash.segment_ids(q, k, q_valid, kv_valid)
    kw = dict(causal=False, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    runs = []
    for _ in range(2):
        o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        runs.append((o, lse, *flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)))
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("Dh", [2080, 96])
def test_flash_kernels_refuse_head_dims_past_1024_or_off_64(cuda, Dh):
    """At a head dim that is not a multiple of 64 (past 2048 as below it:
    every multiple of 64 has its kernels) the kernels take nothing: the
    wrappers raise, and nothing launches."""
    x = torch.zeros(1, 2, 1024, Dh, device=cuda)
    before = [kern.launches for kern in flash.KERNELS]
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention(x, x, x, causal=True, scale=Dh ** -0.5)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention_fwd(x, x, x, causal=True, scale=Dh ** -0.5)
    lse = torch.zeros(1, 2, 1024, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention_bwd(x, x, x, x, x, lse, causal=True, scale=Dh ** -0.5)
    assert [kern.launches for kern in flash.KERNELS] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_card_holds_every_cluster_size(cuda, dtype):
    """Each of K4's cluster kernels fits at least one cluster of every size
    from 3 to 16 CTAs on the card, and a size outside 3-16 is refused."""
    for c in range(3, flash.MAX_CLUSTER_CTAS + 1):
        fits = flash.cluster_fits(dtype, c)
        assert set(fits) == {"fwd", "dq", "dkdv"} and min(fits.values()) >= 1, (c, fits)
    for c in (2, flash.MAX_CLUSTER_CTAS + 1):
        with pytest.raises(ValueError, match="CTAs"):
            flash.cluster_fits(dtype, c)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 63, 200, 432])
def test_folded_kernels_match_plain_and_equal_packed(cuda, T, dtype, rate):
    """K3 (the packed kernels on the folded view) against the plain version,
    and bit for bit equal to the packed layout with the same seed."""
    B, H, Dh = 2, 2, 64
    g = torch.Generator().manual_seed(T + 9)
    q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(cuda, dtype) for _ in range(4))
    kw = dict(scale=Dh ** -0.5, dropout_rate=rate, seed=91 if rate else None)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = [kern.launches for kern in port.FOLDED_KERNELS]
    out = port.fused_attention(*leaves, **kw)
    out.backward(do)
    torch.cuda.synchronize()
    assert [kern.launches - b for kern, b in zip(port.FOLDED_KERNELS, before)] == [1, 1]
    fold = lambda x: x.reshape(B * H, T, Dh)  # noqa: E731
    pkw = dict(kw, num_heads=1, causal=True)
    ref = port.packed_attention_reference(fold(q), fold(k), fold(v), **pkw)
    torch.testing.assert_close(fold(out).float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype])
    grads = port.packed_attention_bwd_reference(fold(q), fold(k), fold(v), fold(do), **pkw)
    for name, a, b in zip("qkv", grads, leaves):
        torch.testing.assert_close(fold(b.grad).float(), a.float(), rtol=GRAD_TOL[dtype],
                                   atol=GRAD_TOL[dtype], msg=f"d{name}")
    pack = lambda x: x.transpose(1, 2).reshape(B, T, H * Dh).contiguous()  # noqa: E731
    packed = [pack(x).requires_grad_(True) for x in (q, k, v)]
    out_p = port.packed_attention(*packed, num_heads=H, **kw)
    out_p.backward(pack(do))
    assert torch.equal(pack(out.detach()), out_p.detach())
    for a, b in zip(leaves, packed):
        assert torch.equal(pack(a.grad), b.grad)


# -- the bf16 tensor-core kernels (csrc/attention_tc.cuh) -------------------
BF16 = torch.bfloat16


def test_bf16_kv_length_zero_row_averages_uniformly(cuda):
    """A packed row of kv length 0 averages V uniformly, forward and
    backward, in the tensor-core kernels."""
    q, k, v = _qkv(2, 100, 2, 64, BF16, cuda, seed=6)
    do = torch.randn(2, 100, 128, generator=torch.Generator().manual_seed(6)).to(cuda, BF16)
    lens = torch.tensor([0, 100], dtype=torch.int32, device=cuda)
    kw = dict(num_heads=2, scale=0.125, causal=False, kv_lengths=lens)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = port.packed_attention(*leaves, **kw)
    out.backward(do)
    mean_v = v[0].float().mean(0, keepdim=True).expand(100, -1)
    torch.testing.assert_close(out[0].float(), mean_v, rtol=TOL[BF16], atol=TOL[BF16])
    torch.testing.assert_close(out.float(), port.packed_attention_reference(q, k, v, **kw).float(),
                               rtol=TOL[BF16], atol=TOL[BF16])
    for name, a, b in zip("qkv", port.packed_attention_bwd_reference(q, k, v, do, **kw), leaves):
        torch.testing.assert_close(b.grad.float(), a.float(), rtol=GRAD_TOL[BF16],
                                   atol=GRAD_TOL[BF16], msg=f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_bf16_one_key_rows_backward_matches_plain(cuda, rate):
    """Rows of kv length 1 at the quality run's T and heads: every query's
    dS at the one key sums into its dK, so each row's delta must be the
    plain version's sum of p * dp (at rate 0.2 a kept weight is 1.25 v,
    whose bf16 rounding in O put 0.12 into dK through rowsum(dO * O))."""
    B, T, H, Dh = 4, 384, 8, 64
    q, k, v = _qkv(B, T, H, Dh, BF16, cuda, seed=21)
    do = torch.randn(B, T, H * Dh, generator=torch.Generator().manual_seed(21)).to(cuda, BF16)
    lens = torch.tensor([1, T, 1, T // 2], dtype=torch.int32, device=cuda)
    kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=lens, dropout_rate=rate,
              seed=91 if rate else None)
    o, lse, res = port.packed_attention_kvlen(q, k, v, for_backward=True, **kw)
    grads = port.packed_attention_bwd_kvlen(q, k, v, o, do, lse, res, **kw)
    for name, a, b in zip("qkv", port.packed_attention_bwd_reference(q, k, v, do, causal=False,
                                                                      **kw), grads):
        err = (b.float() - a.float()).abs().max().item()
        assert err <= GRAD_TOL[BF16], (name, err)


def test_bf16_flash_row_without_visible_key(cuda):
    """Causal flash attention where the first queries of batch 1 see only
    keys of another segment: O = 0 and lse = +inf on those rows, and no
    gradient flows through them."""
    B, H, T, Dh = 2, 2, 200, 64
    g = torch.Generator().manual_seed(8)
    q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(cuda, BF16) for _ in range(4))
    q_seg = torch.ones(B, T, dtype=torch.int32, device=cuda)
    kv_seg = q_seg.clone()
    kv_seg[1, :70] = 0  # queries 0..69 of batch 1 (segment 1) see no key
    kw = dict(causal=True, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    assert torch.equal(o[1, :, :70], torch.zeros_like(o[1, :, :70]))
    assert torch.isinf(lse[1, :, :70]).all() and torch.isfinite(lse[:, :, 70:]).all()
    torch.testing.assert_close(o.float(), flash.flash_attention_reference(q, k, v, **kw).float(),
                               rtol=TOL[BF16], atol=TOL[BF16])
    dq, dk, dv = flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert torch.equal(dq[1, :, :70], torch.zeros_like(dq[1, :, :70]))
    for name, a, b in zip("qkv", flash.flash_attention_bwd_reference(q, k, v, o, do, **kw),
                          (dq, dk, dv)):
        torch.testing.assert_close(b.float(), a.float(), rtol=GRAD_TOL[BF16],
                                   atol=GRAD_TOL[BF16], msg=f"d{name}")


def test_bf16_dropout_mask_is_the_plain_mask(cuda):
    """At rate 0.1 the bf16 tensor-core forward drops exactly the weights of
    the plain Philox mask."""
    _assert_dropout_mask_is_the_plain_mask(cuda, BF16, data_seed=14, seed=2 ** 33 + 7)


# -- the warp-specialised backward (the residual delta, determinism) --------
def _packed_grads(q, k, v, do, kern_fwd, kern_bwd, **kw):
    o, lse, res = kern_fwd(q, k, v, for_backward=True, **kw)
    return kern_bwd(q, k, v, o, do, lse, res, **kw)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "kvlen"])
def test_bf16_packed_backward_is_bitwise_deterministic(cuda, causal, rate):
    """Two calls on the same inputs and seed give the same dQ, dK and dV bit
    for bit: every gradient element is summed by one thread in one order."""
    B, T, H, Dh = 4, 433, 4, 64
    q, k, v = _qkv(B, T, H, Dh, BF16, cuda, seed=31)
    do = torch.randn(B, T, H * Dh, generator=torch.Generator().manual_seed(31)).to(cuda, BF16)
    lens = torch.tensor([T, 1, 0, T // 2], dtype=torch.int32, device=cuda)
    kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=None if causal else lens,
              dropout_rate=rate, seed=17 if rate else None)
    fwd, bwd = ((port.packed_attention_causal, port.packed_attention_bwd_causal) if causal
                else (port.packed_attention_kvlen, port.packed_attention_bwd_kvlen))
    first = _packed_grads(q, k, v, do, fwd, bwd, **kw)
    second = _packed_grads(q, k, v, do, fwd, bwd, **kw)
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), f"d{name}"


@pytest.mark.parametrize("segments", [False, True], ids=["plain", "segments"])
def test_bf16_flash_backward_is_bitwise_deterministic(cuda, segments):
    """K4's backward, with and without segment ids, twice: bit for bit equal."""
    B, H, T, Dh = 2, 4, 1433, 64
    g = torch.Generator().manual_seed(12)
    q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(cuda, BF16) for _ in range(4))
    q_seg = kv_seg = None
    if segments:
        q_seg = torch.ones(B, T, dtype=torch.int32, device=cuda)
        q_seg[:, T // 2:] = 2
        kv_seg = q_seg.clone()
    kw = dict(causal=True, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    first = flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    second = flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), f"d{name}"


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("T", [433, 1433])
def test_bf16_dh128_backward_with_empty_and_one_key_rows(cuda, T, rate):
    """Dh = 128 at ragged T, kv lengths 0 and 1 beside full and half rows:
    the packed forward and backward against their plain versions."""
    B, H, Dh = 4, 2, 128
    q, k, v = _qkv(B, T, H, Dh, BF16, cuda, seed=T)
    do = torch.randn(B, T, H * Dh, generator=torch.Generator().manual_seed(T)).to(cuda, BF16)
    lens = torch.tensor([0, 1, T, T // 2], dtype=torch.int32, device=cuda)
    kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=lens, dropout_rate=rate,
              seed=5 if rate else None)
    o, lse, res = port.packed_attention_kvlen(q, k, v, for_backward=True, **kw)
    torch.testing.assert_close(o.float(), port.packed_attention_reference(
        q, k, v, causal=False, **kw).float(), rtol=TOL[BF16], atol=TOL[BF16])
    grads = port.packed_attention_bwd_kvlen(q, k, v, o, do, lse, res, **kw)
    ref = port.packed_attention_bwd_reference(q, k, v, do, causal=False, **kw)
    for name, a, b in zip("qkv", ref, grads):
        torch.testing.assert_close(b.float(), a.float(), rtol=GRAD_TOL[BF16],
                                   atol=GRAD_TOL[BF16], msg=f"d{name}")


def test_bf16_forward_residual_is_the_rounding_of_o(cuda):
    """Under grad the packed forward writes bf16(O32 - bf16(O32)): O plus
    the residual is the plain version's f32 O to well within one bf16 ulp,
    and the forward without grad gives the same O."""
    B, T, H, Dh = 2, 200, 2, 64
    q, k, v = _qkv(B, T, H, Dh, BF16, cuda, seed=3)
    kw = dict(num_heads=H, scale=Dh ** -0.5)
    o, lse, res = port.packed_attention_causal(q, k, v, for_backward=True, **kw)
    assert res.dtype == BF16 and res.shape == o.shape and lse.dtype == torch.float32
    assert torch.equal(o, port.packed_attention_causal(q, k, v, **kw))
    # the residual is below half an ulp of O
    assert (res.float().abs() <= o.float().abs() * 2.0 ** -8 + 1e-30).all()
    o_plain, _, res_plain = port.packed_attention_reference(q, k, v, causal=True,
                                                            for_backward=True, **kw)
    torch.testing.assert_close((o.float() + res.float()),
                               (o_plain.float() + res_plain.float()), rtol=TOL[BF16],
                               atol=TOL[BF16])


def test_length_regulator_backward_is_bitwise_deterministic(cuda):
    """The variance adaptor's frame expansion on the card: two backward
    passes give the same token gradient bit for bit (``torch.gather``'s own
    backward adds with atomics in no fixed order)."""
    from kokoro_tpu_torch.ops.lengths import expand_tokens

    g = torch.Generator().manual_seed(2)
    tokens = torch.randn(8, 96, 512, generator=g).to(cuda).requires_grad_(True)
    durations = torch.randint(0, 12, (8, 96), generator=g).to(cuda)
    grad = torch.randn(8, 512, 512, generator=g).to(cuda)
    first, second = (torch.autograd.grad(expand_tokens(tokens, durations, 512,
                                                       stop_gradient=False), tokens, grad)[0]
                     for _ in range(2))
    assert torch.equal(first, second)


def test_variance_predictor_backward_is_bitwise_deterministic(cuda):
    """A variance predictor's convolutions on the card (cuDNN's
    deterministic backward): two backward passes give the same input and
    weight gradients bit for bit."""
    from kokoro_tpu_torch.models.variance import VariancePredictor

    torch.manual_seed(3)
    predictor = VariancePredictor(hidden_dim=512, filter_size=256, dropout=0.0).to(cuda)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 512, 512, generator=g).to(cuda).requires_grad_(True)
    leaves = [x] + list(predictor.parameters())
    first, second = (torch.autograd.grad(predictor(x).square().sum(), leaves)
                     for _ in range(2))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# -- the warp-specialised forward (packed K1/K2/K3 and flash K4) -------------
def _forward_case(policy, B, T, H, Dh, device, seed, rate=0.0, dtype=BF16, with_lse=False):
    """The forward kernel's wrapper and its plain version for one mask
    policy: packed causal (K1), packed kv lengths (K2: a full row, one that
    ends inside a tile, one that ends on a tile edge, and a row of length 1
    beside one of length 0 when B allows), flash causal (K4) with two
    segments a row.  The wrapper returns O and the lse first; the plain
    version O, or with ``with_lse`` O and the plain row log-sum-exp."""
    g = torch.Generator().manual_seed(seed)
    if policy == "flash":
        q, k, v = (torch.randn(B, H, T, Dh, generator=g).to(device, dtype) for _ in range(3))
        seg = torch.ones(B, T, dtype=torch.int32, device=device)
        seg[:, (2 * T) // 3:] = 2
        kw = dict(causal=True, scale=Dh ** -0.5, q_seg=seg, kv_seg=seg.clone())

        def plain_flash():
            o = flash.flash_attention_reference(q, k, v, **kw)
            if not with_lse:
                return o
            s, _ = flash._logits(q, k, kw["scale"], True, kw["q_seg"], kw["kv_seg"])
            return o, torch.logsumexp(s, dim=-1)

        return lambda: flash.flash_attention_fwd(q, k, v, return_lse=True, **kw), plain_flash
    q, k, v = _qkv(B, T, H, Dh, dtype, device, seed=seed)
    edge = max(1, (T // 64) * 64)
    lens = torch.tensor([T, max(1, T - 37), edge, 1, 0][:B], dtype=torch.int32, device=device)
    causal = policy == "causal"
    kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=None if causal else lens,
              dropout_rate=rate, seed=seed if rate else None)
    kern = port.packed_attention_causal if causal else port.packed_attention_kvlen

    def plain_packed():
        out = port.packed_attention_reference(q, k, v, causal=causal, for_backward=with_lse, **kw)
        return out[:2] if with_lse else out

    return lambda: kern(q, k, v, for_backward=True, **kw), plain_packed


@pytest.mark.parametrize("policy", ["causal", "kvlen", "flash"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [64, 65, 433, 1433])
def test_bf16_forward_matches_plain_across_tile_edges(cuda, policy, Dh, T):
    """Interior tiles (below the diagonal, below the kv length) take the
    unmasked path beside the masked edge tiles, at T on and just past a tile
    edge and ragged T; both consumers of a CTA, one of them past T."""
    kern, plain = _forward_case(policy, 5, T, 2, Dh, cuda, seed=T + Dh)
    out = kern()[0]
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain().float(), rtol=TOL[BF16], atol=TOL[BF16])


@pytest.mark.parametrize("policy", ["causal", "kvlen", "flash"])
@pytest.mark.parametrize("T", [65, 1433])
def test_bf16_forward_heaviest_first_order_one_head(cuda, policy, T):
    """B = 1 and H = 1: the 1-D grid's query tiles, the heaviest first,
    still cover every row once."""
    kern, plain = _forward_case(policy, 1, T, 1, 64, cuda, seed=7 * T)
    out = kern()[0]
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain().float(), rtol=TOL[BF16], atol=TOL[BF16])


@pytest.mark.parametrize("policy, rate", [("causal", 0.0), ("causal", 0.1), ("kvlen", 0.0),
                                          ("kvlen", 0.1), ("flash", 0.0)])
def test_bf16_forward_is_bitwise_deterministic(cuda, policy, rate):
    """Two forward calls on the same inputs and seed: O, lse and (packed)
    the residual bit for bit equal (the flash forward has no dropout)."""
    kern, _ = _forward_case(policy, 4, 1433, 2, 64, cuda, seed=19, rate=rate)
    first, second = kern(), kern()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["causal", "kvlen"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [433, 1433])
def test_bf16_forward_at_rate_matches_plain(cuda, policy, Dh, T):
    """At rate 0.1 the forward (its flags drawn in registers) against the
    plain version under the same seed."""
    kern, plain = _forward_case(policy, 4, T, 2, Dh, cuda, seed=T + 2 * Dh, rate=0.1)
    out = kern()[0]
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain().float(), rtol=TOL[BF16], atol=TOL[BF16])


@pytest.mark.parametrize("policy", ["causal", "kvlen", "flash"])
def test_bf16_forward_persistent_ctas_take_many_items(cuda, policy):
    """More work items than the card has SMs (B=5, H=8, T=1100: 9 query
    tiles of 128 rows a head, 360 items), so each persistent CTA takes
    several items in turn, heavy and light, through one ring."""
    kern, plain = _forward_case(policy, 5, 1100, 8, 64, cuda, seed=23,
                                rate=0.0 if policy == "flash" else 0.1)
    out = kern()[0]
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), plain().float(), rtol=TOL[BF16], atol=TOL[BF16])


# -- the f32 backward on the tensor cores in 3xTF32 (csrc/attention_tf32.cuh)
F32 = torch.float32


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "kvlen"])
def test_f32_dh128_backward_at_ragged_t(cuda, causal, rate):
    """Dh = 128 at T = 1433, kv lengths [T, 1, 0, T - 37] (or causal), at
    rates 0 and 0.2: the packed backward against its plain version under the
    same mask, to the f32 gradient tolerance."""
    B, T, H, Dh = 4, 1433, 2, 128
    q, k, v = _qkv(B, T, H, Dh, F32, cuda, seed=41)
    do = torch.randn(B, T, H * Dh, generator=torch.Generator().manual_seed(41)).to(cuda, F32)
    lens = torch.tensor([T, 1, 0, T - 37], dtype=torch.int32, device=cuda)
    kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=None if causal else lens,
              dropout_rate=rate, seed=29 if rate else None)
    fwd, bwd = ((port.packed_attention_causal, port.packed_attention_bwd_causal) if causal
                else (port.packed_attention_kvlen, port.packed_attention_bwd_kvlen))
    grads = _packed_grads(q, k, v, do, fwd, bwd, **kw)
    torch.cuda.synchronize()
    ref = port.packed_attention_bwd_reference(q, k, v, do, causal=causal, **kw)
    for name, a, b in zip("qkv", ref, grads):
        torch.testing.assert_close(b, a, rtol=GRAD_TOL[F32], atol=GRAD_TOL[F32], msg=f"d{name}")


def test_f32_flash_row_without_visible_key(cuda):
    """K4 in f32 with segment ids where the first queries of batch 1 see
    only keys of another segment: those rows get zero dQ, and every gradient
    matches the plain version."""
    B, H, T, Dh = 2, 2, 200, 64
    g = torch.Generator().manual_seed(9)
    q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(cuda, F32) for _ in range(4))
    q_seg = torch.ones(B, T, dtype=torch.int32, device=cuda)
    kv_seg = q_seg.clone()
    kv_seg[1, :70] = 0  # queries 0..69 of batch 1 (segment 1) see no key
    kw = dict(causal=True, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    dq, dk, dv = flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq[1, :, :70], torch.zeros_like(dq[1, :, :70]))
    for name, a, b in zip("qkv", flash.flash_attention_bwd_reference(q, k, v, o, do, **kw),
                          (dq, dk, dv)):
        torch.testing.assert_close(b, a, rtol=GRAD_TOL[F32], atol=GRAD_TOL[F32], msg=f"d{name}")


def _f32_backward_case(policy, device):
    """A backward call of ``policy`` (causal, kvlen at rate 0.2, flash with
    segment ids; flash_192 and flash_256 at those head dims) on fixed f32
    inputs, as a function of no arguments."""
    B, H, T, Dh = 4, 2, 433, 64
    g = torch.Generator().manual_seed(43)
    if policy.startswith("flash"):
        Dh = int(policy.split("_")[1]) if "_" in policy else Dh
        q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(device, F32) for _ in range(4))
        q_seg = torch.ones(B, T, dtype=torch.int32, device=device)
        q_seg[:, T // 3:] = 2
        kw = dict(causal=True, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=q_seg.clone())
        o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        return lambda: flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    q, k, v, do = (torch.randn(B, T, H * Dh, generator=g).to(device, F32) for _ in range(4))
    causal = policy == "causal"
    lens = torch.tensor([T, 1, 0, T - 37], dtype=torch.int32, device=device)
    kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=None if causal else lens,
              dropout_rate=0.0 if causal else 0.2, seed=None if causal else 3)
    fwd, bwd = ((port.packed_attention_causal, port.packed_attention_bwd_causal) if causal
                else (port.packed_attention_kvlen, port.packed_attention_bwd_kvlen))
    o, lse, res = fwd(q, k, v, for_backward=True, **kw)
    return lambda: bwd(q, k, v, o, do, lse, res, **kw)


@pytest.mark.parametrize("policy", ["causal", "kvlen", "flash", "flash_192", "flash_256"])
def test_f32_backward_is_bitwise_deterministic_whatever_allow_tf32(cuda, policy):
    """Two calls give the same dQ, dK and dV bit for bit, and so does a call
    with ``torch.backends.cuda.matmul.allow_tf32`` on: the 3xTF32 kernels do
    not read the flag."""
    call = _f32_backward_case(policy, cuda)
    first, second = call(), call()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        third = call()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    for name, a, b, c in zip("qkv", first, second, third):
        assert torch.equal(a, b) and torch.equal(a, c), f"d{name}"


# -- the f32 forward on the tensor cores in 3xTF32 (csrc/attention_tf32.cuh)
def _assert_forward_close(kern, plain):
    """The kernel's O and lse against the plain version's, to the f32
    forward tolerance."""
    out, lse = kern()[:2]
    torch.cuda.synchronize()
    ref, ref_lse = plain()
    torch.testing.assert_close(out, ref, rtol=TOL[F32], atol=TOL[F32])
    torch.testing.assert_close(lse, ref_lse, rtol=TOL[F32], atol=TOL[F32])


@pytest.mark.parametrize("policy", ["causal", "kvlen", "flash"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [1, 63, 65, 127, 129, 433, 1433])
def test_f32_forward_matches_plain_across_tile_edges(cuda, policy, Dh, T):
    """O and lse at T on and just past the edges of the forward's key tiles
    (64 keys at Dh 64, 32 at Dh 128) and query tiles (128 and 64 rows), its
    interior tiles unmasked beside the masked edge tiles."""
    _assert_forward_close(*_forward_case(policy, 5, T, 2, Dh, cuda, seed=T + Dh, dtype=F32,
                                         with_lse=True))


@pytest.mark.parametrize("policy", ["causal", "kvlen", "flash"])
@pytest.mark.parametrize("T", [65, 1433])
def test_f32_forward_heaviest_first_order_one_head(cuda, policy, T):
    """B = 1 and H = 1: the causal grid's query tiles, the heaviest first,
    still cover every row once."""
    _assert_forward_close(*_forward_case(policy, 1, T, 1, 64, cuda, seed=7 * T, dtype=F32,
                                         with_lse=True))


@pytest.mark.parametrize("policy", ["causal", "kvlen"])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [433, 1433])
def test_f32_forward_at_rate_matches_plain(cuda, policy, Dh, T):
    """At rate 0.2 the forward (its flags drawn in registers at the score
    accumulators' positions) against the plain version under the same mask."""
    _assert_forward_close(*_forward_case(policy, 4, T, 2, Dh, cuda, seed=T + 3 * Dh, rate=0.2,
                                         dtype=F32, with_lse=True))


@pytest.mark.parametrize("policy, rate", [("causal", 0.0), ("causal", 0.2), ("kvlen", 0.0),
                                          ("kvlen", 0.2), ("flash", 0.0), ("flash_192", 0.0),
                                          ("flash_256", 0.0)])
def test_f32_forward_is_bitwise_deterministic_whatever_allow_tf32(cuda, policy, rate):
    """Two calls give the same O and lse bit for bit, and so does a call with
    ``torch.backends.cuda.matmul.allow_tf32`` on: the 3xTF32 forward does
    not read the flag (flash_192 and flash_256: K4 at those head dims)."""
    Dh = int(policy.split("_")[1]) if "_" in policy else 64
    policy = policy.split("_")[0]
    kern, _ = _forward_case(policy, 4, 1433, 2, Dh, cuda, seed=31, rate=rate, dtype=F32)
    first, second = kern()[:2], kern()[:2]
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        third = kern()[:2]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    for name, a, b, c in zip(("o", "lse"), first, second, third):
        assert torch.equal(a, b) and torch.equal(a, c), name


def test_f32_kv_length_zero_row_averages_uniformly(cuda):
    """A packed row of kv length 0 averages V uniformly in the 3xTF32
    forward, and its backward matches the plain version."""
    q, k, v = _qkv(2, 100, 2, 64, F32, cuda, seed=16)
    do = torch.randn(2, 100, 128, generator=torch.Generator().manual_seed(16)).to(cuda, F32)
    lens = torch.tensor([0, 100], dtype=torch.int32, device=cuda)
    kw = dict(num_heads=2, scale=0.125, causal=False, kv_lengths=lens)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = port.packed_attention(*leaves, **kw)
    out.backward(do)
    mean_v = v[0].mean(0, keepdim=True).expand(100, -1)
    torch.testing.assert_close(out[0].detach(), mean_v, rtol=TOL[F32], atol=TOL[F32])
    torch.testing.assert_close(out.detach(), port.packed_attention_reference(q, k, v, **kw),
                               rtol=TOL[F32], atol=TOL[F32])
    for name, a, b in zip("qkv", port.packed_attention_bwd_reference(q, k, v, do, **kw), leaves):
        torch.testing.assert_close(b.grad, a, rtol=GRAD_TOL[F32], atol=GRAD_TOL[F32],
                                   msg=f"d{name}")


def test_f32_flash_forward_row_without_visible_key(cuda):
    """K4's f32 forward where the first queries of batch 1 see only keys of
    another segment: O = 0 and lse = +inf on those rows, the plain version's
    O elsewhere."""
    B, H, T, Dh = 2, 2, 200, 128
    g = torch.Generator().manual_seed(10)
    q, k, v = (torch.randn(B, H, T, Dh, generator=g).to(cuda, F32) for _ in range(3))
    q_seg = torch.ones(B, T, dtype=torch.int32, device=cuda)
    kv_seg = q_seg.clone()
    kv_seg[1, :70] = 0  # queries 0..69 of batch 1 (segment 1) see no key
    kw = dict(causal=True, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o[1, :, :70], torch.zeros_like(o[1, :, :70]))
    assert torch.isinf(lse[1, :, :70]).all() and (lse[1, :, :70] > 0).all()
    assert torch.isfinite(lse[:, :, 70:]).all() and torch.isfinite(lse[0]).all()
    torch.testing.assert_close(o, flash.flash_attention_reference(q, k, v, **kw),
                               rtol=TOL[F32], atol=TOL[F32])


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_f32_forward_then_backward_with_empty_and_one_key_rows(cuda, rate):
    """Dh = 64 at T = 1433, kv lengths [T, 1, 0, T - 37]: the forward to the
    f32 forward tolerance, and the f32 backward on its O and lse within the
    f32 gradient tolerance of the plain version (a one-key row's weight is
    exactly 1 when the forward's lse and the backward's recompute take S by
    the same products)."""
    B, T, H, Dh = 4, 1433, 2, 64
    q, k, v = _qkv(B, T, H, Dh, F32, cuda, seed=47)
    do = torch.randn(B, T, H * Dh, generator=torch.Generator().manual_seed(47)).to(cuda, F32)
    lens = torch.tensor([T, 1, 0, T - 37], dtype=torch.int32, device=cuda)
    kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=lens, dropout_rate=rate,
              seed=37 if rate else None)
    o, lse, res = port.packed_attention_kvlen(q, k, v, for_backward=True, **kw)
    grads = port.packed_attention_bwd_kvlen(q, k, v, o, do, lse, res, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, port.packed_attention_reference(q, k, v, causal=False, **kw),
                               rtol=TOL[F32], atol=TOL[F32])
    ref = port.packed_attention_bwd_reference(q, k, v, do, causal=False, **kw)
    for name, a, b in zip("qkv", ref, grads):
        torch.testing.assert_close(b, a, rtol=GRAD_TOL[F32], atol=GRAD_TOL[F32], msg=f"d{name}")


# -- K4 past Dh 2048: the scores in device memory (csrc/attention_scores.cuh)
# 2112: a ragged 64-column last strip; 2560: the model of phase long's hidden
# 2560 at one head; 4096
PAST_2048 = [2112, 2560, 4096]


@pytest.mark.parametrize("masks", ["suffix", "interior"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", PAST_2048)
@pytest.mark.parametrize("T", [1024, 1433])
def test_flash_kernels_past_head_dim_2048_match_plain(cuda, T, Dh, dtype, masks):
    """K4 past Dh 2048, causal, through the autograd Function: one launch of
    each wrapper a call, O and every gradient against the plain versions."""
    _hold_flash_against_plain(*_wide_flash_inputs(cuda, T, Dh, dtype, masks, 13 * T + Dh))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", PAST_2048)
def test_flash_scores_kernels_noncausal_and_bitwise(cuda, Dh, dtype):
    """Past Dh 2048 without the causal mask (every score tile launched, a
    ragged T of 1100) against the plain versions, and two calls bit for bit
    equal (no atomics: each output element summed by one thread in a fixed
    order)."""
    q, k, v, do, q_valid, kv_valid = _wide_flash_inputs(cuda, 1100, Dh, dtype, "suffix", Dh + 1)
    _hold_flash_against_plain(q, k, v, do, q_valid, kv_valid, causal=False)
    q_seg, kv_seg = flash.segment_ids(q, k, q_valid, kv_valid)
    kw = dict(causal=False, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    runs = []
    for _ in range(2):
        o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        runs.append((o, lse, *flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)))
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", [2112, 2560])
def test_flash_scores_rows_with_zero_or_one_key(cuda, Dh, dtype, causal):
    """Rows that see one key (a segment shared with that key alone, at and
    beside the 64- and 128-row tile edges) and rows that see none (a segment
    no key has): a one-key row's dQ is exactly 0 (its delta is taken by its
    dP's own products, so dP - delta is 0), a no-key row's O and dQ are 0
    and its lse +inf; O and every gradient, the one-key rows' keys' dK and
    dV included, within the tolerances of the plain version."""
    B, H, T = 2, 1, 1433
    g = torch.Generator().manual_seed(Dh + 2 * causal + (dtype == BF16))
    q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(cuda, dtype) for _ in range(4))
    one, none = [0, 63, 64, 127, 128, 700, T - 1], [5, 200, 1300]
    q_seg = torch.ones(B, T, dtype=torch.int32, device=cuda)
    for i, r in enumerate(one):
        q_seg[:, r] = 2 + i
    kv_seg = q_seg.clone()  # key r alone shares row r's segment
    for r in none:
        q_seg[:, r] = 100 + r  # no key's segment
    kw = dict(causal=causal, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    dq, dk, dv = flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dq[:, :, one], torch.zeros_like(dq[:, :, one]))
    assert torch.equal(o[:, :, none], torch.zeros_like(o[:, :, none]))
    assert torch.equal(dq[:, :, none], torch.zeros_like(dq[:, :, none]))
    assert torch.isinf(lse[:, :, none]).all() and torch.isfinite(lse[:, :, one]).all()
    torch.testing.assert_close(o.float(), flash.flash_attention_reference(q, k, v, **kw).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    ref = flash.flash_attention_bwd_reference(q, k, v, o, do, **kw)
    for name, a, b in zip("qkv", ref, (dq, dk, dv)):
        torch.testing.assert_close(b.float(), a.float(), rtol=GRAD_TOL[dtype],
                                   atol=GRAD_TOL[dtype], msg=f"d{name}")
    for name, a, b in zip("kv", ref[1:], (dk, dv)):
        torch.testing.assert_close(b[:, :, one].float(), a[:, :, one].float(),
                                   rtol=GRAD_TOL[dtype], atol=GRAD_TOL[dtype],
                                   msg=f"d{name} at the one-key rows' keys")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("Dh", [1536, 2048])
def test_flash_scores_path_at_cluster_head_dims_matches_plain(cuda, Dh, dtype):
    """The scores-in-memory kernels called directly where the wrappers take
    the cluster kernels (they take any multiple of 64): against the plain
    versions, and no wrapper counts a launch."""
    q, k, v, do, q_valid, kv_valid = _wide_flash_inputs(cuda, 1433, Dh, dtype, "interior", Dh)
    q_seg, kv_seg = flash.segment_ids(q, k, q_valid, kv_valid)
    kw = dict(causal=True, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    before = [kern.launches for kern in flash.KERNELS]
    o, lse = flash.flash_attention_fwd_scores(q, k, v, return_lse=True, **kw)
    grads = flash.flash_attention_bwd_scores(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert [kern.launches for kern in flash.KERNELS] == before
    torch.testing.assert_close(o.float(), flash.flash_attention_reference(q, k, v, **kw).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    ref = flash.flash_attention_bwd_reference(q, k, v, o, do, **kw)
    for name, a, b in zip("qkv", ref, grads):
        torch.testing.assert_close(b.float(), a.float(), rtol=GRAD_TOL[dtype],
                                   atol=GRAD_TOL[dtype], msg=f"d{name}")


# -- K4's f32 scores path on wgmma (csrc/attention_scores_tf32.cuh): the
# crossover, 1088 (a ragged 64-column last strip), 1536 (phase long's hidden
# 1536 at one head), 2048, 2560, 4096, 8192
F32_SCORES = sorted({flash.F32_SCORES_FROM, 1088, 1536, 2048, 2560, 4096, 8192})


@pytest.mark.parametrize("masks", ["suffix", "interior"])
@pytest.mark.parametrize("Dh", F32_SCORES)
def test_f32_wrappers_take_the_scores_kernels_and_match_plain(cuda, Dh, masks):
    """The f32 wrappers from the crossover on, causal, T=1433, through the
    autograd Function: one launch of each wrapper, counted as a scores-path
    launch, its outputs bit for bit those of the scores kernels called
    directly, and O and every gradient against the plain versions."""
    q, k, v, do, q_valid, kv_valid = _wide_flash_inputs(cuda, 1433, Dh, F32, masks, 17 * Dh)
    assert flash.scores_path(Dh, F32)
    before = [kern.scores_launches for kern in flash.KERNELS]
    _hold_flash_against_plain(q, k, v, do, q_valid, kv_valid)
    assert [kern.scores_launches - b for kern, b in zip(flash.KERNELS, before)] == [1, 1]
    q_seg, kv_seg = flash.segment_ids(q, k, q_valid, kv_valid)
    kw = dict(causal=True, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    grads = flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    o2, lse2 = flash.flash_attention_fwd_scores(q, k, v, return_lse=True, **kw)
    grads2 = flash.flash_attention_bwd_scores(q, k, v, o2, do, lse2, **kw)
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads), (o2, lse2, *grads2)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("Dh", sorted({flash.F32_SCORES_FROM, 1088, 1536}))
def test_f32_scores_rows_with_zero_or_one_key_and_bitwise(cuda, Dh, causal):
    """The f32 scores path at the crossover and at the cluster head dims it
    took over: rows that see one key have dQ exactly 0 (their dP - delta,
    hence dS, is exactly 0), rows that see none O and dQ 0 and lse +inf,
    every output within the plain version's tolerances, and two calls bit
    for bit equal."""
    B, H, T = 2, 1, 1433
    g = torch.Generator().manual_seed(5 * Dh + causal)
    q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(cuda, F32) for _ in range(4))
    one, none = [0, 63, 64, 127, 128, 700, T - 1], [5, 200, 1300]
    q_seg = torch.ones(B, T, dtype=torch.int32, device=cuda)
    for i, r in enumerate(one):
        q_seg[:, r] = 2 + i
    kv_seg = q_seg.clone()  # key r alone shares row r's segment
    for r in none:
        q_seg[:, r] = 100 + r  # no key's segment
    kw = dict(causal=causal, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    runs = []
    for _ in range(2):
        o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        runs.append((o, lse, *flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name
    o, lse, dq, dk, dv = runs[0]
    assert torch.equal(dq[:, :, one], torch.zeros_like(dq[:, :, one]))
    assert torch.equal(o[:, :, none], torch.zeros_like(o[:, :, none]))
    assert torch.equal(dq[:, :, none], torch.zeros_like(dq[:, :, none]))
    assert torch.isinf(lse[:, :, none]).all() and torch.isfinite(lse[:, :, one]).all()
    torch.testing.assert_close(o, flash.flash_attention_reference(q, k, v, **kw), rtol=TOL[F32],
                               atol=TOL[F32])
    ref = flash.flash_attention_bwd_reference(q, k, v, o, do, **kw)
    for name, a, b in zip("qkv", ref, (dq, dk, dv)):
        torch.testing.assert_close(b, a, rtol=GRAD_TOL[F32], atol=GRAD_TOL[F32], msg=f"d{name}")


# the f32 head dims of the on-chip kernels (Dh 192 to 2048) that the
# wrappers no longer reach: called directly, against the plain versions
F32_ONCHIP_UNREACHED = [Dh for Dh in (192, 256, 320, 384, 512, 768, 1024, 1088, 1536, 2048)
                        if flash.scores_path(Dh, F32)]


@pytest.mark.parametrize("Dh", F32_ONCHIP_UNREACHED)
def test_f32_onchip_kernels_the_route_no_longer_reaches_match_plain(cuda, Dh):
    """The f32 on-chip kernels (``csrc/attention_tf32{,_wide}.cuh``, past Dh
    256 over clusters) called directly where the wrappers take the scores
    path: O and every gradient against the plain versions, no wrapper
    counting a launch."""
    q, k, v, do, q_valid, kv_valid = _wide_flash_inputs(cuda, 1433, Dh, F32, "suffix", 19 * Dh)
    q_seg, kv_seg = flash.segment_ids(q, k, q_valid, kv_valid)
    kw = dict(causal=True, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    before = [kern.launches for kern in flash.KERNELS]
    o, lse = flash.flash_attention_fwd_onchip(q, k, v, return_lse=True, **kw)
    grads = flash.flash_attention_bwd_onchip(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert [kern.launches for kern in flash.KERNELS] == before
    torch.testing.assert_close(o, flash.flash_attention_reference(q, k, v, **kw), rtol=TOL[F32],
                               atol=TOL[F32])
    ref = flash.flash_attention_bwd_reference(q, k, v, o, do, **kw)
    for name, a, b in zip("qkv", ref, grads):
        torch.testing.assert_close(b, a, rtol=GRAD_TOL[F32], atol=GRAD_TOL[F32], msg=f"d{name}")


# -- K4's bf16 scores path on wgmma (csrc/attention_scores_tc.cuh): the
# crossover, 384, 512 (the flagship's hidden 512 at one head), 1088 (a
# ragged 64-column last strip), 1536 (hidden 1536 at one head), 2048, 2560,
# 4096, 8192
BF16_SCORES = sorted({flash.BF16_SCORES_FROM, 384, 512, 1088, 1536, 2048, 2560, 4096, 8192})


@pytest.mark.parametrize("masks", ["suffix", "interior"])
@pytest.mark.parametrize("Dh", BF16_SCORES)
def test_bf16_wrappers_take_the_scores_kernels_and_match_plain(cuda, Dh, masks):
    """The bf16 wrappers from the crossover on, causal, T=1433, through the
    autograd Function: one launch of each wrapper, counted as a scores-path
    launch, its outputs bit for bit those of the scores kernels called
    directly, and O and every gradient against the plain versions."""
    q, k, v, do, q_valid, kv_valid = _wide_flash_inputs(cuda, 1433, Dh, BF16, masks, 23 * Dh)
    assert flash.scores_path(Dh, BF16)
    before = [kern.scores_launches for kern in flash.KERNELS]
    _hold_flash_against_plain(q, k, v, do, q_valid, kv_valid)
    assert [kern.scores_launches - b for kern, b in zip(flash.KERNELS, before)] == [1, 1]
    q_seg, kv_seg = flash.segment_ids(q, k, q_valid, kv_valid)
    kw = dict(causal=True, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    grads = flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    o2, lse2 = flash.flash_attention_fwd_scores(q, k, v, return_lse=True, **kw)
    grads2 = flash.flash_attention_bwd_scores(q, k, v, o2, do, lse2, **kw)
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads), (o2, lse2, *grads2)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("Dh", sorted({flash.BF16_SCORES_FROM, 512, 1088, 1536}))
def test_bf16_scores_rows_with_zero_or_one_key_and_bitwise(cuda, Dh, causal):
    """The bf16 scores path at the crossover and at the cluster head dims it
    took over: rows that see one key have dQ exactly 0 (their delta is taken
    by dP's own products, chunk order and accumulation, so dP - delta, hence
    dS, is exactly 0), rows that see none O and dQ 0 and lse +inf, every
    output within the plain version's tolerances, and two calls bit for bit
    equal."""
    B, H, T = 2, 1, 1433
    g = torch.Generator().manual_seed(7 * Dh + causal)
    q, k, v, do = (torch.randn(B, H, T, Dh, generator=g).to(cuda, BF16) for _ in range(4))
    one, none = [0, 63, 64, 127, 128, 700, T - 1], [5, 200, 1300]
    q_seg = torch.ones(B, T, dtype=torch.int32, device=cuda)
    for i, r in enumerate(one):
        q_seg[:, r] = 2 + i
    kv_seg = q_seg.clone()  # key r alone shares row r's segment
    for r in none:
        q_seg[:, r] = 100 + r  # no key's segment
    kw = dict(causal=causal, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    runs = []
    for _ in range(2):
        o, lse = flash.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        runs.append((o, lse, *flash.flash_attention_bwd(q, k, v, o, do, lse, **kw)))
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name
    o, lse, dq, dk, dv = runs[0]
    assert torch.equal(dq[:, :, one], torch.zeros_like(dq[:, :, one]))
    assert torch.equal(o[:, :, none], torch.zeros_like(o[:, :, none]))
    assert torch.equal(dq[:, :, none], torch.zeros_like(dq[:, :, none]))
    assert torch.isinf(lse[:, :, none]).all() and torch.isfinite(lse[:, :, one]).all()
    torch.testing.assert_close(o.float(), flash.flash_attention_reference(q, k, v, **kw).float(),
                               rtol=TOL[BF16], atol=TOL[BF16])
    ref = flash.flash_attention_bwd_reference(q, k, v, o, do, **kw)
    for name, a, b in zip("qkv", ref, (dq, dk, dv)):
        torch.testing.assert_close(b.float(), a.float(), rtol=GRAD_TOL[BF16],
                                   atol=GRAD_TOL[BF16], msg=f"d{name}")


# the bf16 head dims of the on-chip kernels (Dh 192 to 2048) that the
# wrappers no longer reach: called directly, against the plain versions
BF16_ONCHIP_UNREACHED = [Dh for Dh in (192, 256, 320, 384, 512, 768, 1024, 1088, 1536, 2048)
                         if flash.scores_path(Dh, BF16)]


@pytest.mark.parametrize("Dh", BF16_ONCHIP_UNREACHED)
def test_bf16_onchip_kernels_the_route_no_longer_reaches_match_plain(cuda, Dh):
    """The bf16 on-chip kernels (``csrc/attention_tc.cuh``, past Dh 256 over
    clusters) called directly where the wrappers take the scores path: O and
    every gradient against the plain versions, no wrapper counting a
    launch."""
    q, k, v, do, q_valid, kv_valid = _wide_flash_inputs(cuda, 1433, Dh, BF16, "suffix", 29 * Dh)
    q_seg, kv_seg = flash.segment_ids(q, k, q_valid, kv_valid)
    kw = dict(causal=True, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
    before = [kern.launches for kern in flash.KERNELS]
    o, lse = flash.flash_attention_fwd_onchip(q, k, v, return_lse=True, **kw)
    grads = flash.flash_attention_bwd_onchip(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert [kern.launches for kern in flash.KERNELS] == before
    torch.testing.assert_close(o.float(), flash.flash_attention_reference(q, k, v, **kw).float(),
                               rtol=TOL[BF16], atol=TOL[BF16])
    ref = flash.flash_attention_bwd_reference(q, k, v, o, do, **kw)
    for name, a, b in zip("qkv", ref, grads):
        torch.testing.assert_close(b.float(), a.float(), rtol=GRAD_TOL[BF16],
                                   atol=GRAD_TOL[BF16], msg=f"d{name}")


@pytest.mark.parametrize("Tq,Tk,Dh,causal", [(1433, 1433, 2112, True), (1408, 1408, 2560, True),
                                             (1024, 1024, 8192, False), (300, 1000, 4096, True),
                                             (1408, 1408, 512, True), (1433, 1433, 1088, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_scores_grid_is_the_launchers(cuda, Tq, Tk, Dh, causal, dtype):
    """The compiled launcher's grid (``kokoro_flash_attention_scores_grid``)
    is ``ops/flash_scores.py``'s, each dtype's chunk included, which the CPU
    tests hold against the visible pairs."""
    assert flash_scores.launch_grid(Tq, Tk, Dh, causal, dtype) == \
        flash_scores.grid(Tq, Tk, Dh, causal, dtype)


def test_flash_scores_refused_launch_raises(cuda, monkeypatch):
    """A launch the library refuses raises, naming the wrapper's kernel and
    the head dim, counts nothing and falls back to nothing; the library
    refuses a grid past its z limit (B H > 65535) itself."""
    Dh = 2560
    x = torch.zeros(1, 1, 1024, Dh, device=cuda)
    lse = torch.zeros(1, 1, 1024, device=cuda)
    before = [kern.launches for kern in flash.KERNELS]

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 98  # cudaErrorInvalidDeviceFunction

    from kokoro_tpu_torch.ops import kernels

    with monkeypatch.context() as m:
        m.setattr(kernels, "load", lambda name: Refusing())
        with pytest.raises(RuntimeError, match="flash_attention_fwd.*head_dim 2560"):
            flash.flash_attention_fwd(x, x, x, causal=True, scale=Dh ** -0.5)
        with pytest.raises(RuntimeError, match="flash_attention_bwd.*head_dim 2560"):
            flash.flash_attention_bwd(x, x, x, x, x, lse, causal=True, scale=Dh ** -0.5)
    assert [kern.launches for kern in flash.KERNELS] == before
    lib = kernels.load("flash_attention")
    y = torch.zeros(1, 1, 1, Dh, device=cuda)
    ws = torch.zeros(1, 128, 128, device=cuda)
    err = lib.kokoro_flash_attention_fwd_scores(
        y.data_ptr(), y.data_ptr(), y.data_ptr(), y.data_ptr(), None, None, None,
        ws.data_ptr(), ws.data_ptr(), ws.data_ptr(), 2, 65535, 1, 1, Dh,
        ctypes.c_float(1.0), 1, 0, torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue, before any launch
