"""Port's packed attention (kokoro_tpu_torch/ops/fused_attention.py) against
the JAX package's Pallas kernel, run as its own tests run it on the CPU (the
Pallas interpreter, rate 0), plus the dispatcher's contract.

Tolerance: f32 2e-5 abs/rel, the reference's own f32 forward tolerance
(docs/attention_numerics_tpu.json ``tolerances.f32_fwd``).
"""

import numpy as np
import pytest
import torch

from kokoro_tpu.ops.fused_attention import fused_attention_packed
from kokoro_tpu_torch.ops import fused_attention as port
from tests.torch_parity import n, t

F32_FWD = 2e-5


def _inputs(B, T, H, Dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H * Dh)).astype(np.float32) for _ in range(3))
    return q, k, v


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "kvlen"])
# every value of T, H and Dh, each pair of values once (not the full product)
@pytest.mark.parametrize("H,Dh,T", [(2, 64, 128), (4, 32, 128), (2, 32, 144), (4, 64, 144)])
def test_plain_matches_pallas_kernel(causal, T, H, Dh):
    B = 2
    q, k, v = _inputs(B, T, H, Dh, seed=T + 10 * H + Dh)
    scale = 1.0 / np.sqrt(Dh)
    lens = None if causal else np.asarray([T - 37, T], np.int32)  # ragged
    ref = fused_attention_packed(
        q, k, v, num_heads=H, scale=scale, causal=causal,
        kv_lengths=None if lens is None else np.asarray(lens),
    )
    out = port.packed_attention_reference(
        t(q), t(k), t(v), num_heads=H, scale=scale, causal=causal,
        kv_lengths=None if lens is None else t(lens),
    )
    np.testing.assert_allclose(n(out), np.asarray(ref), rtol=F32_FWD, atol=F32_FWD)


def test_cpu_dispatch_takes_plain_version_and_launches_nothing():
    q, k, v = (t(x) for x in _inputs(2, 100, 2, 64, seed=1))
    lens = torch.tensor([60, 100], dtype=torch.int32)
    before = port.total_launches()
    for causal in (True, False):
        out = port.packed_attention(q, k, v, num_heads=2, scale=0.125, causal=causal,
                                    kv_lengths=lens)
        ref = port.packed_attention_reference(q, k, v, num_heads=2, scale=0.125,
                                              causal=causal, kv_lengths=None if causal else lens)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert port.total_launches() == before


def test_all_masked_row_averages_values_uniformly():
    """kv_lengths 0 masks every key at -1e9: the softmax is uniform, as in the
    reference (the -1e9 constant, not -inf)."""
    q, k, v = (t(x) for x in _inputs(1, 70, 1, 64, seed=2))
    out = port.packed_attention(q, k, v, num_heads=1, scale=0.125, causal=False,
                                kv_lengths=torch.tensor([0], dtype=torch.int32))
    torch.testing.assert_close(out[0], v[0].mean(0, keepdim=True).expand(70, 64),
                               rtol=1e-5, atol=1e-6)


def test_dispatcher_refuses_dropout():
    """dropout_rate > 0 without a seed raises, as the reference's
    ``dropout_requires_rng``."""
    q = torch.zeros(1, 128, 128)
    with pytest.raises(ValueError, match="seed"):
        port.packed_attention(q, q, q, num_heads=2, scale=1.0, dropout_rate=0.1)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_dispatcher_refuses_dtypes(dtype):
    q = torch.zeros(1, 128, 128, dtype=dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        port.packed_attention(q, q, q, num_heads=2, scale=1.0)


def test_dispatcher_refuses_mixed_dtypes_shapes_and_head_dims():
    q = torch.zeros(1, 128, 128)
    with pytest.raises(TypeError):
        port.packed_attention(q, q, q.bfloat16(), num_heads=2, scale=1.0)
    with pytest.raises(ValueError, match="shape"):
        port.packed_attention(q, q[:, :64], q, num_heads=2, scale=1.0)
    with pytest.raises(ValueError, match="head_dim"):
        port.packed_attention(q, q, q, num_heads=4, scale=1.0)  # Dh 32
    with pytest.raises(ValueError, match="kv_lengths"):
        port.packed_attention(q, q, q, num_heads=2, scale=1.0, causal=False,
                              kv_lengths=torch.tensor([1, 2]))


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 128, 128)
    before = port.total_launches()
    with pytest.raises(ValueError, match="CUDA"):
        port.packed_attention_causal(q, q, q, num_heads=2, scale=1.0)
    assert port.total_launches() == before
