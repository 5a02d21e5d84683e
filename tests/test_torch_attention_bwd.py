"""The port's packed-attention backward and dropout
(kokoro_tpu_torch/ops/fused_attention.py, ops/philox.py) on the CPU.

* The plain backward against ``jax.vjp`` of the JAX package's
  ``fused_attention_packed``, whose Pallas backward runs in interpret mode on
  the CPU, at rate 0 (the TPU's dropout bits cannot be reproduced): causal and
  kv-length (a length-0 row included), f32 at 1e-4 and bf16 at 3e-2, the
  reference's own grad tolerances (docs/attention_numerics_tpu.json
  ``tolerances``).
* The plain backward against torch autograd through the plain forward, rates
  0 and 0.1 with one seed, at 1e-5.  Rows with visible keys only: for a
  length-0 row the reference kernel back-propagates dS = p (dp - rowsum)
  through the -1e9 logits too, which autograd of the mask does not; the
  comparison with the Pallas backward covers that row.
* The autograd Function on CPU tensors, Philox's published known-answer
  vector, and the plain dropout's keep rate, survivor scale and determinism.
* The backward's delta from the forward's O and its bf16 rounding residual
  (``rowsum(dO * (O + residual))``, the kernels' way, one pass over the keys):
  against the Pallas backward's ``jnp.sum(dp * p)`` at rate 0 in bf16 (rows
  of kv length 1, T and T/2) and against the plain ``p * dP`` sum with the
  Philox masks at rate 0.2, where the delta from the bf16 O alone misses the
  0.03 limit on dK at one-key rows; and what the Function saves for the
  backward, by name and dtype (the CUDA path saves the same).
"""

import jax
import numpy as np
import pytest
import torch

from kokoro_tpu.ops.fused_attention import fused_attention_packed
from kokoro_tpu_torch.ops import fused_attention as port
from kokoro_tpu_torch.ops.philox import attention_keep_mask, keep_threshold, philox4x32_10
from tests.torch_parity import n, t

GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(B, T, H, Dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H * Dh)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "kvlen"])
def test_plain_backward_matches_pallas_backward(causal, dtype):
    B, T, H, Dh = 2, 128, 2, 64
    q, k, v, do = _inputs(B, T, H, Dh, seed=7 + causal)
    scale = Dh ** -0.5
    lens = None if causal else np.asarray([0, T - 37], np.int32)  # a length-0 row
    jdt = jax.numpy.dtype(dtype)
    qj, kj, vj, doj = (jax.numpy.asarray(x, jdt) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: fused_attention_packed(
        a, b, c, num_heads=H, scale=scale, causal=causal, kv_lengths=lens), qj, kj, vj)
    ref = vjp(doj)
    tdt = getattr(torch, dtype)
    qt, kt, vt, dot = (t(np.asarray(x, np.float32)).to(tdt) for x in (qj, kj, vj, doj))
    out = port.packed_attention_bwd_reference(
        qt, kt, vt, dot, num_heads=H, scale=scale, causal=causal,
        kv_lengths=None if lens is None else t(lens))
    tol = GRAD_TOL[dtype]
    for name, a, b in zip("qkv", out, ref):
        assert a.dtype == tdt
        np.testing.assert_allclose(n(a.float()), np.asarray(b, np.float32), rtol=tol, atol=tol,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "kvlen"])
def test_plain_backward_matches_autograd_of_plain_forward(causal, rate):
    B, T, H, Dh = 2, 72, 2, 64
    q, k, v, do = (t(x) for x in _inputs(B, T, H, Dh, seed=11))
    lens = None if causal else torch.tensor([72, 50], dtype=torch.int32)
    kw = dict(num_heads=H, scale=Dh ** -0.5, causal=causal, kv_lengths=lens,
              dropout_rate=rate, seed=1234 if rate else None)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    torch.autograd.backward(port.packed_attention_reference(*leaves, **kw), do)
    out = port.packed_attention_bwd_reference(q, k, v, do, **kw)
    for name, a, b in zip("qkv", out, leaves):
        torch.testing.assert_close(a, b.grad, rtol=1e-5, atol=1e-5, msg=f"d{name}")


def test_function_on_cpu_runs_plain_versions_and_launches_nothing():
    B, T, H, Dh = 2, 80, 2, 64
    q, k, v, do = (t(x) for x in _inputs(B, T, H, Dh, seed=3))
    lens = torch.tensor([80, 33], dtype=torch.int32)
    kw = dict(num_heads=H, scale=0.125, dropout_rate=0.2, seed=99)
    before = port.total_launches()
    for causal in (True, False):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = port.packed_attention(*leaves, causal=causal, kv_lengths=lens, **kw)
        out.backward(do.transpose(0, 1).contiguous().transpose(0, 1))  # non-contiguous dO
        ref_lens = None if causal else lens
        torch.testing.assert_close(out, port.packed_attention_reference(
            q, k, v, causal=causal, kv_lengths=ref_lens, **kw), rtol=0, atol=0)
        # the Function's backward takes each row's delta from the saved O, as the
        # kernels do (f32: no residual)
        grads = port.packed_attention_bwd_reference(q, k, v, do, causal=causal,
                                                    kv_lengths=ref_lens, o=out.detach(), **kw)
        for a, b in zip(grads, leaves):
            torch.testing.assert_close(b.grad, a, rtol=0, atol=0)
    assert port.total_launches() == before


def test_philox_known_answer():
    """Random123's published Philox4x32-10 vector: counter 0, key 0."""
    zero = torch.zeros((), dtype=torch.int64)
    words = philox4x32_10((zero, zero, zero, zero), 0)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_plain_dropout_keep_rate_scale_and_determinism():
    rate, B, T, H, Dh = 0.1, 2, 128, 2, 64
    q, k, v, _ = (t(x) * 0.1 for x in _inputs(B, T, H, Dh, seed=5))
    assert keep_threshold(rate) == int(0.9 * 2 ** 32)
    mask = attention_keep_mask(41, B, H, T, rate)
    assert abs(mask.float().mean().item() - (1 - rate)) < 0.01
    assert torch.equal(mask, attention_keep_mask(41, B, H, T, rate))
    assert not torch.equal(mask, attention_keep_mask(42, B, H, T, rate))
    # identity-block values read out the dropped weights Pd (non-causal, all keys)
    kw = dict(num_heads=H, scale=Dh ** -0.5, causal=False)
    eye = torch.zeros(B, T, H * Dh)
    pd, p = [], []
    for j0 in range(0, T, Dh):
        blk = eye.clone()
        for h in range(H):
            blk[:, j0:j0 + Dh, h * Dh:(h + 1) * Dh] = torch.eye(Dh)
        pd.append(port.packed_attention_reference(q, k, blk, dropout_rate=rate, seed=41, **kw))
        p.append(port.packed_attention_reference(q, k, blk, **kw))
    # (B, T, H, Dh) blocks -> (B, H, T, T)
    pd = torch.cat([x.reshape(B, T, H, Dh) for x in pd], -1).permute(0, 2, 1, 3)
    p = torch.cat([x.reshape(B, T, H, Dh) for x in p], -1).permute(0, 2, 1, 3)
    torch.testing.assert_close(pd != 0, mask)
    kept = mask & (p > 1e-8)
    scale_err = ((pd[kept] - p[kept] / (1 - rate)).abs() / (p[kept] / (1 - rate))).max()
    assert scale_err < 1e-3


def _bf16(xs):
    return [t(x).to(torch.bfloat16) for x in xs]


def test_residual_delta_matches_pallas_backward():
    """Rate 0, bf16, rows of kv length 1, T and T/2: the plain backward with
    each row's delta taken as rowsum(dO * (O + residual)) from the plain
    forward against the Pallas backward (its delta ``jnp.sum(dp * p)``), and
    that delta against the plain sum of p * dp in f32."""
    B, T, H, Dh = 3, 128, 2, 64
    q, k, v, do = _inputs(B, T, H, Dh, seed=19)
    scale, lens = Dh ** -0.5, np.asarray([1, T, T // 2], np.int32)
    qj, kj, vj, doj = (jax.numpy.asarray(x, jax.numpy.bfloat16) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: fused_attention_packed(
        a, b, c, num_heads=H, scale=scale, causal=False, kv_lengths=lens), qj, kj, vj)
    ref = vjp(doj)
    qt, kt, vt, dot = (t(np.asarray(x, np.float32)).to(torch.bfloat16)
                       for x in (qj, kj, vj, doj))
    kw = dict(num_heads=H, scale=scale, causal=False, kv_lengths=t(lens))
    o, lse, res = port.packed_attention_reference(qt, kt, vt, for_backward=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T) and res.dtype == torch.bfloat16
    out = port.packed_attention_bwd_reference(qt, kt, vt, dot, o=o, residual=res, **kw)
    for name, a, b in zip("qkv", out, ref):
        np.testing.assert_allclose(n(a.float()), np.asarray(b, np.float32),
                                   rtol=GRAD_TOL["bfloat16"], atol=GRAD_TOL["bfloat16"],
                                   err_msg=f"d{name}")
    # the deltas themselves: (B, H, T) in f32
    p, _ = port._probs_and_keep(qt, kt, H, scale, False, t(lens), 0.0, None)
    do_h, v_h = port._heads(dot, H), port._heads(vt, H)
    exact = (p * (do_h @ v_h.transpose(-1, -2))).sum(-1)
    delta = (do_h * port._heads(o.float() + res.float(), H)).sum(-1)
    torch.testing.assert_close(delta, exact, rtol=2e-2, atol=2e-2)


def test_residual_delta_holds_one_key_rows_at_rate_02():
    """At rate 0.2 a kept weight of a one-key row is 1.25 v: the delta from
    the bf16 O alone rounds it, and the rounding of every query sums into
    the key's dK past the 0.03 limit; O + residual holds the plain p * dP
    backward (the Philox masks) within it."""
    B, T, H, Dh, rate = 4, 384, 8, 64, 0.2
    q, k, v, do = _bf16(_inputs(B, T, H, Dh, seed=21))
    kw = dict(num_heads=H, scale=Dh ** -0.5, causal=False, dropout_rate=rate, seed=91,
              kv_lengths=torch.tensor([1, T, 1, T // 2], dtype=torch.int32))
    o, _, res = port.packed_attention_reference(q, k, v, for_backward=True, **kw)
    exact = port.packed_attention_bwd_reference(q, k, v, do, **kw)
    with_residual = port.packed_attention_bwd_reference(q, k, v, do, o=o, residual=res, **kw)
    bf16_o = port.packed_attention_bwd_reference(q, k, v, do, o=o, **kw)
    limit = GRAD_TOL["bfloat16"]
    for name, a, b in zip("qkv", with_residual, exact):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= limit, (f"d{name}", err)
    miss = (bf16_o[1].float() - exact[1].float()).abs().max().item()
    assert miss > limit, miss


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_function_saves_what_the_cuda_path_saves(dtype):
    """Under grad the Function on CPU tensors saves, by name and dtype, what
    its CUDA path saves: q, k, v, o, the f32 lse (B, H, T), O's bf16
    rounding residual (None for f32) and the kv lengths; without grad,
    neither lse nor residual."""
    B, T, H, Dh = 2, 48, 2, 64
    q, k, v, _ = (t(x).to(dtype) for x in _inputs(B, T, H, Dh, seed=4))
    lens = torch.tensor([48, 1], dtype=torch.int32)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = port.packed_attention(*leaves, num_heads=H, scale=0.125, causal=False,
                                kv_lengths=lens)
    saved = dict(zip(port.SAVED, out.grad_fn.saved_tensors))
    assert list(saved) == ["q", "k", "v", "o", "lse", "residual", "kv_lengths"]
    for name in ("q", "k", "v", "o"):
        assert saved[name].dtype == dtype and saved[name].shape == q.shape
    assert saved["lse"].dtype == torch.float32 and saved["lse"].shape == (B, H, T)
    if dtype == torch.bfloat16:
        assert saved["residual"].dtype == dtype and saved["residual"].shape == q.shape
    else:
        assert saved["residual"] is None
    assert saved["kv_lengths"].dtype == torch.int32
    # without grad the forward is asked for o alone
    asked = []
    reference = port.packed_attention_reference

    def recording(*args, **kwargs):
        asked.append(kwargs["for_backward"])
        return reference(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port, "packed_attention_reference", recording)
        port.packed_attention(q, k, v, num_heads=H, scale=0.125, causal=False, kv_lengths=lens)
        port.packed_attention(*leaves, num_heads=H, scale=0.125, causal=False, kv_lengths=lens)
    assert asked == [False, True]
