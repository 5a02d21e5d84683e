"""Port's length regulation and variance stack against the JAX package:
``token_to_frame_map``, ``expand_tokens``, ``length_regulate`` (exact for
integers), ``VariancePredictor``, ``VarianceAdaptor`` and
``SimpleDurationAdaptor`` (2e-5 for floats, exact for masks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kokoro_tpu.models import variance as ref_var
from kokoro_tpu.ops import lengths as ref_len
from kokoro_tpu_torch.models import variance as port_var
from kokoro_tpu_torch.ops import lengths as port_len
from tests.torch_parity import apply_flax, init_flax, load_torch, n, perturbed_params, t

TOL = 2e-5
HID, FILT = 32, 24


def close(a, b, tol=TOL):
    np.testing.assert_allclose(n(a), n(b), rtol=tol, atol=tol)


def _durations(seed, B=3, L=9, high=5):
    d = np.random.default_rng(seed).integers(-1, high, size=(B, L)).astype(np.int32)
    d[0, -3:] = 0
    return d


@pytest.mark.parametrize("max_len", [1, 17, 40])
def test_token_to_frame_map_exact(max_len):
    d = _durations(0)
    ref = ref_len.token_to_frame_map(jnp.asarray(d), max_len)
    out = port_len.token_to_frame_map(t(d), max_len)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(n(a), np.asarray(b))


@pytest.mark.parametrize("rank", [2, 3])
def test_expand_tokens_exact(rank):
    rng = np.random.default_rng(1)
    d = _durations(2)
    shape = (3, 9) if rank == 2 else (3, 9, 4)
    tokens = rng.standard_normal(shape).astype(np.float32)
    ref = ref_len.expand_tokens(jnp.asarray(tokens), jnp.asarray(d), 30)
    np.testing.assert_array_equal(n(port_len.expand_tokens(t(tokens), t(d), 30)), np.asarray(ref))


def test_length_regulate_exact():
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((3, 9, 5)).astype(np.float32)
    d = rng.uniform(-1, 4, size=(3, 9)).astype(np.float32)
    pad = np.arange(9)[None, :] >= np.asarray([9, 6, 2])[:, None]
    ref = ref_len.length_regulate(jnp.asarray(enc), jnp.asarray(d), jnp.asarray(pad), 25)
    out = port_len.length_regulate(t(enc), t(d), t(pad), 25)
    np.testing.assert_array_equal(n(out[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(n(out[1]), np.asarray(ref[1]))


def test_quantize_boundaries_match():
    values = np.concatenate([np.linspace(0, 1, 1001), [0.0, 1.0, 0.5]]).astype(np.float32)
    ref = jnp.searchsorted(jnp.linspace(0.0, 1.0, 255), jnp.asarray(values), side="left")
    out = port_var.VarianceAdaptor(hidden_dim=HID, filter_size=FILT).quantize(t(values))
    np.testing.assert_array_equal(n(out), np.asarray(ref))


@pytest.mark.parametrize("masked", [True, False])
def test_variance_predictor(masked):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, HID)).astype(np.float32)
    mask = (np.arange(11)[None, :] >= np.asarray([11, 7])[:, None]) if masked else None
    jm = ref_var.VariancePredictor(hidden_dim=HID, filter_size=FILT, output_bias=0.3)
    variables, flat = perturbed_params(init_flax(jm, x, mask), 5)
    tm = load_torch(port_var.VariancePredictor(hidden_dim=HID, filter_size=FILT, output_bias=0.3), flat)
    with torch.no_grad():
        out = tm(t(x), None if mask is None else t(mask))
    close(out, apply_flax(jm, variables, x, mask))


@pytest.mark.parametrize("targets", [True, False], ids=["teacher", "predicted"])
def test_variance_adaptor(targets):
    rng = np.random.default_rng(6)
    B, L, T = 2, 8, 30
    enc = rng.standard_normal((B, L, HID)).astype(np.float32)
    mask = np.arange(L)[None, :] >= np.asarray([8, 5])[:, None]
    kw = {}
    if targets:
        kw = dict(
            duration_target=jnp.asarray(rng.integers(0, 5, (B, L)).astype(np.int32)),
            pitch_target=jnp.asarray(rng.uniform(80, 300, (B, T - 3)).astype(np.float32)),
            energy_target=jnp.asarray(rng.uniform(0, 1, (B, T + 4)).astype(np.float32)),
        )
    jm = ref_var.VarianceAdaptor(hidden_dim=HID, filter_size=FILT, n_bins=64)
    variables, flat = perturbed_params(init_flax(jm, enc, T, mask, **kw), 7)
    tm = load_torch(port_var.VarianceAdaptor(hidden_dim=HID, filter_size=FILT, n_bins=64), flat)
    ref = apply_flax(jm, variables, enc, T, mask, **kw)
    with torch.no_grad():
        out = tm(t(enc), T, t(mask), **{k: t(np.asarray(v)) for k, v in kw.items()})
    for a, b in zip(out[:4], ref[:4]):
        close(a, b)
    np.testing.assert_array_equal(n(out[4]), np.asarray(ref[4]))


@pytest.mark.parametrize("targets", [True, False], ids=["teacher", "predicted"])
def test_simple_duration_adaptor(targets):
    rng = np.random.default_rng(8)
    B, L, T = 2, 8, 40
    enc = rng.standard_normal((B, L, HID)).astype(np.float32)
    mask = np.arange(L)[None, :] >= np.asarray([8, 6])[:, None]
    dur = rng.integers(0, 5, (B, L)).astype(np.int32) if targets else None
    jm = ref_var.SimpleDurationAdaptor(hidden_dim=HID)
    variables, flat = perturbed_params(init_flax(jm, enc, T, mask), 9, scale=0.3)
    tm = load_torch(port_var.SimpleDurationAdaptor(hidden_dim=HID), flat)
    ref = apply_flax(jm, variables, enc, T, mask, duration_target=dur)
    with torch.no_grad():
        out = tm(t(enc), T, t(mask), duration_target=None if dur is None else t(dur))
    close(out[0], ref[0])
    close(out[1], ref[1])
    assert out[2] is None and out[3] is None
    np.testing.assert_array_equal(n(out[4]), np.asarray(ref[4]))


def test_expand_frames_is_gather_forward_and_backward():
    """The length regulator's gather (``ops/lengths.py::_ExpandFrames``,
    whose backward sums each token's frames in a fixed order) against
    ``torch.gather`` and its autograd, exactly, in float64 on the CPU:
    tokens of zero duration and frames past the total included."""
    g = torch.Generator().manual_seed(0)
    tokens = torch.randn(3, 7, 5, generator=g, dtype=torch.float64, requires_grad=True)
    durations = torch.tensor([[1, 2, 0, 3, 1, 0, 0], [2] * 7, [0, 0, 1, 0, 0, 0, 9]])
    frame_to_token, _, _ = port_len.token_to_frame_map(durations, 12)
    out = port_len._ExpandFrames.apply(tokens, frame_to_token)
    ref = torch.gather(tokens, 1, frame_to_token[:, :, None].expand(-1, -1, 5))
    assert torch.equal(out, ref)
    grad = torch.randn(3, 12, 5, generator=g, dtype=torch.float64)
    (a,) = torch.autograd.grad(out, tokens, grad)
    (b,) = torch.autograd.grad(ref, tokens, grad)
    assert torch.equal(a, b)


def test_deterministic_conv1d_is_conv1d_forward_and_backward():
    """The variance predictors' convolution
    (``models/variance.py::_DeterministicConv1d``, cuDNN's deterministic
    backward algorithms) against ``F.conv1d`` and its autograd, exactly, in
    float64 on the CPU, with and without a bias and at dilation 2."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 8, 20, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(5, 8, 3, generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(5, generator=g, dtype=torch.float64, requires_grad=True)
    for bias, padding, dilation in ((b, 1, 1), (None, 2, 2)):
        out = port_var._DeterministicConv1d.apply(x, w, bias, padding, dilation)
        ref = F.conv1d(x, w, bias, padding=padding, dilation=dilation)
        assert torch.equal(out, ref)
        grad = torch.randn(ref.shape, generator=g, dtype=torch.float64)
        leaves = (x, w) if bias is None else (x, w, bias)
        for a, r in zip(torch.autograd.grad(out, leaves, grad),
                        torch.autograd.grad(ref, leaves, grad)):
            assert torch.equal(a, r)
