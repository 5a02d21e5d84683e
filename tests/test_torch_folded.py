"""Port's K3 (``fused_attention`` in kokoro_tpu_torch/ops/fused_attention.py)
against the JAX package's ``fused_attention`` run in the Pallas interpreter
on the CPU (rate 0, forward and ``jax.vjp``), and the folded layout against
the packed one (mirrors ``tests/unit/test_fused_attention.py::TestPackedLayout``).

Tolerances: forward f32 2e-5, gradients f32 1e-4 (docs/attention_numerics_tpu.json
``tolerances``); folded against packed at rate 0.1: exactly equal, the
dropout masks included (the Philox counter b*H + h is the same in both
layouts).
"""

import jax
import numpy as np
import pytest
import torch

from kokoro_tpu.ops.fused_attention import fused_attention as jax_fused_attention
from kokoro_tpu_torch.ops import fused_attention as port
from tests.torch_parity import n, t

F32_FWD, F32_GRAD = 2e-5, 1e-4


@pytest.mark.parametrize("T,H,Dh", [(128, 2, 64), (432, 1, 128)])
def test_plain_matches_pallas_kernel_fwd_and_grads(T, H, Dh):
    B = 2
    rng = np.random.default_rng(T + H)
    q, k, v, do = (rng.standard_normal((B, H, T, Dh)).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(Dh)

    @jax.jit
    def ref_fn(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, scale=scale), q, k, v)
        return out, vjp(do)

    out_j, grads_j = ref_fn(q, k, v, do)
    leaves = [t(x).requires_grad_(True) for x in (q, k, v)]
    out_t = port.fused_attention(*leaves, scale=scale)
    grads_t = torch.autograd.grad(out_t, leaves, t(do))
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), rtol=F32_FWD, atol=F32_FWD)
    for name, gt, gj in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(n(gt), np.asarray(gj), rtol=F32_GRAD, atol=F32_GRAD,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("T,H,Dh", [(128, 2, 64), (200, 4, 64), (128, 1, 128)])
def test_folded_equals_packed_layout_with_dropout(T, H, Dh):
    B, rate, seed = 2, 0.1, 1234
    rng = np.random.default_rng(T * H)
    q, k, v, do = (rng.standard_normal((B, H, T, Dh)).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(Dh)

    def pack(x):
        return x.transpose(1, 2).reshape(B, T, H * Dh)

    fl = [t(x).requires_grad_(True) for x in (q, k, v)]
    out_f = port.fused_attention(*fl, scale=scale, dropout_rate=rate, seed=seed)
    grads_f = torch.autograd.grad(out_f, fl, t(do))
    pk = [pack(t(x)).requires_grad_(True) for x in (q, k, v)]
    out_p = port.packed_attention(*pk, num_heads=H, scale=scale, dropout_rate=rate, seed=seed)
    grads_p = torch.autograd.grad(out_p, pk, pack(t(do)))
    assert torch.equal(pack(out_f), out_p)
    for gf, gp in zip(grads_f, grads_p):
        assert torch.equal(pack(gf), gp)
    # the mask is live: another seed drops other weights
    other = port.fused_attention(*(x.detach() for x in fl), scale=scale, dropout_rate=rate,
                                 seed=seed + 1)
    assert not torch.equal(other, out_f.detach())


def test_folded_dispatch_counts_nothing_on_the_cpu_and_refuses_bad_shapes():
    before = port.total_launches()
    x = torch.randn(1, 2, 64, 64)
    port.fused_attention(x, x, x, scale=0.125)
    assert port.total_launches() == before
    with pytest.raises(ValueError):
        port.fused_attention(x, x, torch.randn(1, 2, 32, 64), scale=0.125)
    with pytest.raises(ValueError, match="head_dim"):
        y = torch.randn(1, 2, 64, 32)
        port.fused_attention(y, y, y, scale=0.125)
    assert port.folded_attention_fwd.replaces.endswith(":153 (_call_fwd)")
    assert port.folded_attention_bwd.replaces.endswith(":179 (_call_bwd)")
