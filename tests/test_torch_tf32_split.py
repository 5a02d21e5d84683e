"""Why the f32 attention kernels take three TF32 products per product.

The f32 kernels (``kokoro_tpu_torch/csrc/attention_tf32.cuh``) run the
forward's two products and the backward's five on the tensor cores in
3xTF32: each operand x split into big = tf32(x) and small = tf32(x - big),
each product big.big' + big.small' + small.big' with f32 sums.  Here that
arithmetic is emulated in plain PyTorch on the CPU (TF32 rounding to
nearest, ties away from zero, on the bit pattern; a product of two TF32
values is exact in f32) inside the plain versions themselves
(``ops/fused_attention.py::packed_attention_reference`` and
``packed_attention_bwd_reference``, their ``torch.matmul`` swapped for the
emulation) and held against the same functions in float64 (the backward's
recompute: ``chip_smoke.packed_bwd_float64``): three products stay within
the f32 forward and gradient tolerances and within 4x of plain f32's own
error; one TF32 product does not stay within them.  No kernel runs here.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from kokoro_tpu_torch.ops import fused_attention as port

GRAD_TOL = 1e-4  # f32 gradients, docs/attention_numerics_tpu.json
FWD_TOL = 2e-5  # the f32 forward, the same file
_matmul = torch.matmul


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10-bit mantissa), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def three_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return (_matmul(a_big, b_small) + _matmul(a_small, b_big)) + _matmul(a_big, b_big)


def one_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _matmul(tf32(a), tf32(b))


def _case(T, Dh):
    rng = np.random.default_rng(T + Dh)
    B, H = 2, 2
    args = [torch.from_numpy(rng.standard_normal((B, T, H * Dh)).astype(np.float32))
            for _ in range(4)]
    kw = dict(num_heads=H, scale=Dh ** -0.5, causal=False,
              kv_lengths=torch.tensor([T, T // 2 + 1], dtype=torch.int32))
    return args, kw


def _error(monkeypatch, product, args, kw) -> float:
    """The plain backward's largest gradient error against float64, with its
    products taken by ``product`` (None: plain f32)."""
    with monkeypatch.context() as m:
        if product is not None:
            m.setattr(torch, "matmul", product)
        grads = port.packed_attention_bwd_reference(*args, **kw)
    return chip_smoke.max_abs_diff(grads, chip_smoke.packed_bwd_float64(*args, **kw))


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [128, 433])
def test_three_tf32_products_are_as_accurate_as_f32(monkeypatch, T, Dh):
    args, kw = _case(T, Dh)
    f32 = _error(monkeypatch, None, args, kw)
    three = _error(monkeypatch, three_tf32, args, kw)
    assert three <= GRAD_TOL, three
    assert three <= 4 * f32, (three, f32)


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [128, 433])
def test_one_tf32_product_misses_the_f32_tolerance(monkeypatch, T, Dh):
    args, kw = _case(T, Dh)
    assert _error(monkeypatch, one_tf32, args, kw) > GRAD_TOL


def _forward_case(T, Dh):
    """Causal attention on standard-normal inputs, B=2, H=2."""
    rng = np.random.default_rng(2 * T + Dh)
    B, H = 2, 2
    args = [torch.from_numpy(rng.standard_normal((B, T, H * Dh)).astype(np.float32))
            for _ in range(3)]
    return args, dict(num_heads=H, scale=Dh ** -0.5, causal=True)


def _forward_float64(q, k, v, *, num_heads, scale, causal):
    """The causal forward in float64."""
    B, T, D = q.shape
    heads = lambda x: x.reshape(B, T, num_heads, D // num_heads).transpose(1, 2).double()
    s = heads(q) @ heads(k).transpose(-1, -2) * scale
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), float("-inf"))
    return (torch.softmax(s, dim=-1) @ heads(v)).transpose(1, 2).reshape(B, T, D)


def _forward_error(monkeypatch, product, args, kw) -> float:
    """The plain forward's largest error against float64, with both its
    products (S = Q K^T, P V) taken by ``product`` (None: plain f32)."""
    with monkeypatch.context() as m:
        if product is not None:
            m.setattr(torch, "matmul", product)
        out = port.packed_attention_reference(*args, **kw)
    return (out.double() - _forward_float64(*args, **kw)).abs().max().item()


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [128, 433, 1433])
def test_three_tf32_forward_products_are_as_accurate_as_f32(monkeypatch, T, Dh):
    args, kw = _forward_case(T, Dh)
    f32 = _forward_error(monkeypatch, None, args, kw)
    three = _forward_error(monkeypatch, three_tf32, args, kw)
    assert three <= FWD_TOL, three
    assert three <= 4 * f32, (three, f32)


@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("T", [128, 433, 1433])
def test_one_tf32_forward_product_misses_the_f32_tolerance(monkeypatch, T, Dh):
    args, kw = _forward_case(T, Dh)
    assert _forward_error(monkeypatch, one_tf32, args, kw) > FWD_TOL
