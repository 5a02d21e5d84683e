"""Port's K4 (kokoro_tpu_torch/ops/flash_attention.py) against the JAX
package's ``_flash_attention`` (the library Pallas flash attention, forward
and its two-kernel backward) run in the Pallas TPU interpreter on the CPU
(``pltpu.force_tpu_interpret_mode()``), plus the dispatcher's refusals and
``MultiHeadAttention``'s routing.  At Dh 192 and 320, which the library's
kernel refuses (a head_dim above 128 must be a multiple of 128 there), the
JAX side is the library's own plain reference, ``mha_reference_no_custom_vjp``.

Tolerances (docs/attention_numerics_tpu.json ``tolerances``): forward f32
2e-5 / bf16 2e-2, gradients f32 1e-4 / bf16 3e-2, abs and rel.  Rows without
a visible key are outside the library's contract (the port returns 0 there):
their cotangent is 0 on both sides and their outputs are not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as library

from kokoro_tpu.models.blocks import _flash_attention
from kokoro_tpu_torch.models.blocks import MultiHeadAttention
from kokoro_tpu_torch.ops import flash_attention as port
from kokoro_tpu_torch.ops import fused_attention as packed
from tests.torch_parity import n, t

FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _masks(kind, B, T, rng):
    """(q_valid, kv_valid) as bool numpy, or (None, None)."""
    if kind == "none":
        return None, None
    if kind == "suffix":  # right padding, as collate makes it
        lens = np.asarray([T - 200, T - 37][:B])
        valid = np.arange(T)[None, :] < lens[:, None]
        return valid, valid
    # interior: padding inside the sequence on both sides, queries all valid
    valid = rng.random((B, T)) > 0.3
    valid[:, 0] = True
    return np.ones((B, T), bool), valid


def _visible_rows(q_valid, kv_valid, B, T, causal):
    """(B, T) rows with at least one visible key."""
    if q_valid is None:
        return np.ones((B, T), bool)
    same = q_valid[:, :, None] == kv_valid[:, None, :]
    if causal:
        same &= np.tril(np.ones((T, T), bool))[None]
    return same.any(-1)


# each value of T, Dh, dtype, causal and mask kind at least once; Dh 192,
# 256, 384 and 512 in both dtypes, with and without masks; Dh 320 (a ragged
# last 128-column slice in the port's cluster kernels); Dh 768 and 1024 (the
# port's clusters of 6 and 8 CTAs)
CASES = [
    (1024, 64, "float32", True, "none"),
    (1024, 64, "float32", True, "suffix"),
    (1152, 128, "float32", False, "interior"),
    (1024, 128, "bfloat16", True, "none"),
    (1152, 64, "bfloat16", True, "interior"),
    (1024, 64, "bfloat16", False, "suffix"),
    (1024, 192, "float32", True, "none"),
    (1152, 192, "bfloat16", False, "interior"),
    (1024, 192, "bfloat16", True, "suffix"),
    (1024, 256, "float32", True, "suffix"),
    (1152, 256, "float32", False, "interior"),
    (1024, 256, "bfloat16", True, "none"),
    (1024, 384, "float32", True, "suffix"),
    (1024, 384, "bfloat16", True, "none"),
    (1024, 512, "float32", True, "none"),
    (1024, 512, "bfloat16", True, "interior"),
    (1024, 320, "float32", True, "interior"),
    (1024, 768, "float32", True, "suffix"),
    (1024, 1024, "bfloat16", True, "none"),
]


def _library_reference(q, k, v, causal, scale, q_valid, kv_valid):
    """The library's own plain reference (``mha_reference_no_custom_vjp``,
    the jnp attention its kernel is tested against, differentiated by JAX) with ``_flash_attention``'s
    segment ids, in f32 on the dtype-rounded inputs: the library's kernel
    refuses a head_dim above 128 that is not a multiple of 128 (Dh 192: its
    ``NotImplementedError``), so there the reference's flash branch has no
    kernel to hold the port to."""
    B, _, Tq, _ = q.shape
    Tk = k.shape[2]
    segment_ids = None
    if q_valid is not None or kv_valid is not None:
        q_seg = jnp.ones((B, Tq), jnp.int32) if q_valid is None else q_valid.astype(jnp.int32)
        kv_seg = jnp.ones((B, Tk), jnp.int32) if kv_valid is None else kv_valid.astype(jnp.int32)
        segment_ids = library.SegmentIds(q=q_seg, kv=kv_seg)
    f32 = [x.astype(jnp.float32) for x in (q, k, v)]
    out = library.mha_reference_no_custom_vjp(*f32, None, segment_ids, causal=causal,
                                              sm_scale=scale)
    return out.astype(q.dtype)


@pytest.mark.parametrize("T,Dh,dname,causal,masks", CASES)
def test_plain_matches_library_kernel_in_interpret_mode(T, Dh, dname, causal, masks):
    hold_plain_against_library(T, Dh, dname, causal, masks)


def hold_plain_against_library(T, Dh, dname, causal, masks, B=2, H=2):
    """The port's K4 (plain on the CPU) against the reference's
    ``_flash_attention`` with the library kernel in the Pallas TPU
    interpreter, or, at a head dim above 128 that is not a multiple of 128,
    against the library's plain reference: forward and gradients at
    ``FWD_TOL`` / ``GRAD_TOL``, inputs from a numpy seed."""
    rng = np.random.default_rng(T + Dh)
    q, k, v, do = (rng.standard_normal((B, H, T, Dh)).astype(np.float32) for _ in range(4))
    q_valid, kv_valid = _masks(masks, B, T, rng)
    rows = _visible_rows(q_valid, kv_valid, B, T, causal)
    do = do * rows[:, None, :, None]
    scale = 1.0 / np.sqrt(Dh)
    jdt = JNP[dname]

    @jax.jit
    def ref_fn(q, k, v, do, q_valid, kv_valid):
        def f(q, k, v):
            if Dh > 128 and Dh % 128:
                return _library_reference(q, k, v, causal, scale, q_valid, kv_valid)
            return _flash_attention(q, k, v, causal=causal, scale=scale,
                                    q_valid=q_valid, kv_valid=kv_valid)

        out, vjp = jax.vjp(f, q.astype(jdt), k.astype(jdt), v.astype(jdt))
        return out, vjp(do.astype(jdt))

    with pltpu.force_tpu_interpret_mode():
        out_j, grads_j = ref_fn(q, k, v, do, q_valid, kv_valid)

    # the port gets the inputs already rounded to the dtype, as JAX does
    tq, tk, tv = (t(x).to(TORCH[dname]).requires_grad_(True) for x in (q, k, v))
    out_t = port.flash_attention(
        tq, tk, tv, causal=causal, scale=scale,
        q_valid=None if q_valid is None else t(q_valid),
        kv_valid=None if kv_valid is None else t(kv_valid))
    grads_t = torch.autograd.grad(out_t, (tq, tk, tv), t(do).to(TORCH[dname]))

    tol, gtol = FWD_TOL[dname], GRAD_TOL[dname]
    keep = rows[:, None, :, None]
    np.testing.assert_allclose(np.where(keep, n(out_t.float()), 0.0),
                               np.where(keep, np.asarray(out_j, np.float32), 0.0),
                               rtol=tol, atol=tol)
    for name, gt, gj in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(n(gt.float()), np.asarray(gj, np.float32),
                                   rtol=gtol, atol=gtol, err_msg=f"d{name}")


def test_row_without_visible_key_is_zero_with_zero_gradient():
    """Queries marked padding with every key valid see no key: 0 out, no
    gradient through them (the port's definition outside the contract)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 128, 64, generator=g, requires_grad=True) for _ in range(3))
    q_valid = torch.arange(128)[None] < 100
    out = port.flash_attention(q, k, v, causal=True, scale=0.125, q_valid=q_valid,
                               kv_valid=torch.ones(1, 128, dtype=torch.bool))
    assert torch.equal(out[:, :, 100:], torch.zeros_like(out[:, :, 100:]))
    (dq,) = torch.autograd.grad(out.sum(), (q,))
    assert torch.equal(dq[:, :, 100:], torch.zeros_like(dq[:, :, 100:]))


def test_plain_backward_matches_autograd_of_plain_forward():
    """The plain backward is the gradient of the plain forward (f32, 1e-5)."""
    g = torch.Generator().manual_seed(1)
    q, k, v, do = (torch.randn(2, 2, 160, 64, generator=g) for _ in range(4))
    valid = torch.arange(160)[None] < torch.tensor([[160], [117]])
    q_seg, kv_seg = port.segment_ids(q, k, valid, valid)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = port.flash_attention_reference(*leaves, causal=True, scale=0.125, q_seg=q_seg,
                                         kv_seg=kv_seg)
    auto = torch.autograd.grad(out, leaves, do)
    manual = port.flash_attention_bwd_reference(q, k, v, out.detach(), do, causal=True,
                                                scale=0.125, q_seg=q_seg, kv_seg=kv_seg)
    for a, b in zip(auto, manual):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_dispatcher_refusals():
    x = torch.zeros(1, 2, 128, 64)
    with pytest.raises(TypeError):
        port.flash_attention(x.half(), x.half(), x.half(), causal=True, scale=1.0)
    y = torch.zeros(1, 2, 128, 32)
    with pytest.raises(ValueError, match="head_dim"):
        port.flash_attention(y, y, y, causal=True, scale=1.0)
    with pytest.raises(ValueError):
        port.flash_attention(x, torch.zeros(1, 3, 128, 64), torch.zeros(1, 3, 128, 64),
                             causal=True, scale=1.0)
    with pytest.raises(ValueError, match="padding mask"):
        port.flash_attention(x, x, x, causal=True, scale=1.0,
                             q_valid=torch.ones(1, 100, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        port.flash_attention_fwd(x, x, x, causal=True, scale=1.0)


def test_flash_gate_is_the_references_without_its_backend_clause():
    assert port.flash_supported(1024, 1024, 64)
    assert port.flash_supported(1408, 1408, 128)
    assert not port.flash_supported(1000, 1000, 64)   # not a multiple of 128
    assert not port.flash_supported(896, 896, 64)     # below 1024
    assert not port.flash_supported(1024, 1024, 32)   # Dh % 64
    assert not port.flash_supported(1024, 1024, 64, causal=False)
    assert port.flash_supported(1024, 1024, 192)
    assert port.flash_supported(1408, 1408, 256)
    assert port.flash_supported(1024, 1024, 320)
    assert port.flash_supported(1408, 1408, 384)
    assert port.flash_supported(1408, 1408, 512)
    assert port.flash_supported(1024, 1024, 1024)
    assert not port.flash_supported(1024, 1024, 96)   # Dh % 64
    assert not port.flash_supported(896, 896, 512)    # below 1024
    # past 1024 a cluster of 9 to 16 CTAs (larger than the portable 8)
    assert port.flash_supported(1024, 1024, 1088)
    assert port.flash_supported(1408, 1408, 1536)
    assert port.flash_supported(1024, 1024, 2048)
    # past 2048 (more columns than a cluster of 16 CTAs holds) the kernels
    # keep the scores in device memory: every multiple of 64, as the reference
    assert port.flash_supported(1024, 1024, 2112)
    assert port.flash_supported(1408, 1408, 2560)
    assert port.flash_supported(1024, 1024, 8192)
    assert not port.flash_supported(1024, 1024, 2080)   # Dh % 64
    assert not port.flash_supported(1024, 1024, 4100)   # Dh % 64


def _route(T, training, rate, key_given=False, d_model=128, n_heads=2):
    """Launch counts each wrapper WOULD have made: the CPU runs the plain
    versions, so the routes are read from spies on the dispatch functions.
    head_dim is d_model / n_heads."""
    calls = []
    mha = MultiHeadAttention(d_model, n_heads, rate, use_rope=True, qk_norm=True, use_flash=True)
    cross = MultiHeadAttention(d_model, n_heads, rate, qk_norm=True, use_flash=True)
    mha.train(training)
    cross.train(training)
    x = torch.randn(1, T, d_model, generator=torch.Generator().manual_seed(T))
    from kokoro_tpu_torch.models import blocks
    from kokoro_tpu_torch.models.rng import Rng

    real = (blocks.flash_attention, blocks.fused_attention, blocks.packed_attention)

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name if name != "packed" else
                         ("K1" if kw.get("causal", True) else "K2"))
            return fn(*a, **kw)
        return wrapped

    blocks.flash_attention = spy("K4", real[0])
    blocks.fused_attention = spy("K3", real[1])
    blocks.packed_attention = spy("packed", real[2])
    try:
        rng = Rng(7) if training else None
        with torch.no_grad():
            if key_given:
                mha(x, x, causal=True, rng=rng)
            else:
                mha(x, causal=True, rng=rng)
            cross(x, x, rng=rng)  # cross-attention, q_len == kv_len
    finally:
        blocks.flash_attention, blocks.fused_attention, blocks.packed_attention = real
    return calls


@pytest.mark.parametrize("T,training,rate,expected", [
    (1024, False, 0.1, ["K4", "K2"]),   # eval: dropout inactive
    (1408, True, 0.0, ["K4", "K2"]),    # attention_weight_dropout=False
    (1408, True, 0.1, ["K1", "K2"]),    # dropout on: the packed kernel draws it
    (1000, False, 0.0, ["K1", "K2"]),   # not a multiple of 128
])
def test_routing_follows_the_reference(T, training, rate, expected):
    assert _route(T, training, rate) == expected


def test_routing_head_split_causal_takes_k3_and_k4():
    assert _route(512, True, 0.1, key_given=True) == ["K3", "K2"]
    assert _route(1024, False, 0.0, key_given=True) == ["K4", "K2"]


@pytest.mark.parametrize("d_model,T,key_given,expected", [
    (512, 1024, False, ["K4"]),   # Dh 256: K4, the cross-attention on einsum
    (512, 1408, True, ["K4"]),    # a key given: K4 on the head-split path
    (512, 896, False, []),        # below 1024: einsum, as K1 takes Dh 64 and 128
    (384, 1024, False, ["K4"]),   # Dh 192
    (384, 1000, False, []),       # not a multiple of 128
    (640, 1024, False, ["K4"]),   # Dh 320: the cluster kernels
    (2176, 1024, False, ["K4"]),  # Dh 1088: a cluster of 9 CTAs
    (4224, 1024, False, ["K4"]),  # Dh 2112: the scores in device memory
])
def test_routing_at_head_dims_192_and_256(d_model, T, key_given, expected):
    """K4 takes its own head dims, the packed kernels (K1, K2, K3) theirs:
    past Dh 128 (192, 256, from 320 to 2048 over a cluster of CTAs, and
    past 2048 with the scores in device memory) the long causal
    self-attention takes K4 and every other site stays on einsum, as in the
    reference."""
    assert _route(T, False, 0.0, key_given=key_given, d_model=d_model) == expected


@pytest.mark.parametrize("T,key_given,expected", [
    (1408, False, ["K4"]),   # Dh 512: the flagship's widths at one head
    (1408, True, ["K4"]),    # a key given: K4 on the head-split path
    (896, False, []),        # below 1024: einsum
])
def test_routing_at_one_head_of_512(T, key_given, expected):
    """At hidden 512 and n_heads=1 (Dh 512) only the long causal
    self-attention takes K4; the cross-attention stays on einsum."""
    assert _route(T, False, 0.0, key_given=key_given, d_model=512, n_heads=1) == expected


def test_cpu_routes_launch_no_kernel():
    before = packed.total_launches() + sum(k.launches for k in port.KERNELS)
    _route(1024, False, 0.0)
    assert packed.total_launches() + sum(k.launches for k in port.KERNELS) == before
