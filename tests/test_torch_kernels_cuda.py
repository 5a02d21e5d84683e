"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so it runs on the machine with the
card:  python -m pytest tests/test_torch_kernels_cuda.py -q
Every test here is marked ``cuda`` and skips where CUDA is missing.
Tolerances: forward f32 2e-5 and bf16 2e-2, gradients f32 1e-4 and bf16
3e-2, abs/rel, the reference's own tolerances
(docs/attention_numerics_tpu.json ``tolerances``); the plain version runs
with TF32 off.
"""

import pytest
import torch

from kokoro_tpu_torch.ops import flash_attention as flash
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
