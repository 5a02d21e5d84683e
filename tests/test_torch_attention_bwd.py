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
        grads = port.packed_attention_bwd_reference(q, k, v, do, causal=causal,
                                                    kv_lengths=ref_lens, **kw)
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
