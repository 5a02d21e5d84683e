"""Port's transformer blocks (kokoro_tpu_torch/models/blocks.py) against the
JAX package's flax modules on one set of parameters, f32, tolerance 3e-5.

Covers the plain (einsum) attention path with RoPE, ALiBi (including its
bidirectional quirk), q/k/v RMSNorm and key padding; the cached decode step
with its write frontier; precomputed cross K/V; the GLU FFN; encoder and
decoder blocks, full-sequence and cached.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kokoro_tpu.models import blocks as ref
from kokoro_tpu_torch.models import blocks as port
from tests.torch_parity import apply_flax, init_flax, load_torch, n, perturbed_params, t

TOL = 3e-5
D, H, FF = 64, 4, 96


def close(a, b, tol=TOL):
    np.testing.assert_allclose(n(a), n(b), rtol=tol, atol=tol)


def _x(B, T, seed, d=D):
    return np.random.default_rng(seed).standard_normal((B, T, d)).astype(np.float32)


def _pad(B, T, lens):
    return np.arange(T)[None, :] >= np.asarray(lens)[:, None]


def _mha_pair(seed, **kw):
    x = _x(2, 12, seed)
    jm = ref.MultiHeadAttention(D, H, 0.0, **kw)
    variables, flat = perturbed_params(init_flax(jm, x, causal=True), seed)
    tm = load_torch(port.MultiHeadAttention(D, H, 0.0, **kw), flat)
    return jm, variables, tm


@pytest.mark.parametrize("rel", ["rope", "alibi", "none"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("qk_norm", [True, False], ids=["qknorm", "plain"])
def test_self_attention(rel, causal, qk_norm):
    kw = dict(use_rope=rel == "rope", use_alibi=rel == "alibi", qk_norm=qk_norm)
    jm, variables, tm = _mha_pair(1, **kw)
    x = _x(2, 12, 2)
    pad = _pad(2, 12, [12, 9])
    out_j, _ = apply_flax(jm, variables, x, causal=causal, key_padding_mask=pad)
    with torch.no_grad():
        out_t, _ = tm(t(x), causal=causal, key_padding_mask=t(pad))
    close(out_t, out_j)


def test_cross_attention_with_memory_mask():
    jm, variables, tm = _mha_pair(3, qk_norm=True)
    x, mem = _x(2, 7, 4), _x(2, 11, 5)
    pad = _pad(2, 11, [11, 6])
    out_j, _ = apply_flax(jm, variables, x, mem, mem, key_padding_mask=pad)
    with torch.no_grad():
        out_t, _ = tm(t(x), t(mem), t(mem), key_padding_mask=t(pad))
        kv_t = tm.project_kv(t(mem))
        pre_t, _ = tm(t(x), key_padding_mask=t(pad), precomputed_kv=kv_t)
    close(out_t, out_j)
    kv_j = apply_flax(jm, variables, mem, method=ref.MultiHeadAttention.project_kv)
    close(kv_t[0], kv_j[0])
    close(kv_t[1], kv_j[1])
    close(pre_t, out_j)


@pytest.mark.parametrize("rel", ["rope", "alibi"])
def test_cached_decode_steps(rel):
    kw = dict(use_rope=rel == "rope", use_alibi=rel == "alibi", qk_norm=True)
    jm, variables, tm = _mha_pair(6, **kw)
    B, S, steps = 2, 8, 5
    xs = _x(B, steps, 7)
    cache_j = {"k": jnp.zeros((B, H, S, D // H)), "v": jnp.zeros((B, H, S, D // H)),
               "index": jnp.asarray(0, jnp.int32)}
    cache_t = {"k": torch.zeros(B, H, S, D // H), "v": torch.zeros(B, H, S, D // H), "index": 0}
    step_j = jax.jit(functools.partial(jm.apply, causal=True))
    for i in range(steps):
        out_j, cache_j = step_j(variables, xs[:, i:i + 1], kv_cache=cache_j)
        with torch.no_grad():
            out_t, cache_t = tm(t(xs[:, i:i + 1]), causal=True, kv_cache=cache_t)
        close(out_t, out_j)
        assert cache_t["index"] == int(cache_j["index"]) == i + 1
    close(cache_t["k"], cache_j["k"])
    close(cache_t["v"], cache_j["v"])


@pytest.mark.parametrize("output_norm", [True, False])
def test_glu_feed_forward(output_norm):
    x = _x(2, 9, 8)
    jm = ref.GLUFeedForward(D, FF, 0.0, use_output_norm=output_norm)
    variables, flat = perturbed_params(init_flax(jm, x), 9)
    tm = load_torch(port.GLUFeedForward(D, FF, 0.0, use_output_norm=output_norm), flat)
    with torch.no_grad():
        close(tm(t(x)), apply_flax(jm, variables, x))


@pytest.mark.parametrize("rel", ["rope", "alibi"])
def test_encoder_block(rel):
    kw = dict(qk_norm=True, ffn_output_norm=True, rel_pos_type=rel)
    x = _x(2, 10, 10)
    pad = _pad(2, 10, [10, 7])
    jm = ref.EncoderBlock(D, H, FF, 0.0, **kw)
    variables, flat = perturbed_params(init_flax(jm, x, pad), 11)
    tm = load_torch(port.EncoderBlock(D, H, FF, 0.0, **kw), flat)
    with torch.no_grad():
        close(tm(t(x), t(pad)), apply_flax(jm, variables, x, pad))


def test_decoder_block_full_sequence_and_cached():
    kw = dict(qk_norm=True, ffn_output_norm=True)
    B, T, S = 2, 6, 9
    x, mem = _x(B, T, 12), _x(B, S, 13)
    mem_pad = _pad(B, S, [9, 5])
    jm = ref.DecoderBlock(D, H, FF, 0.0, **kw)
    variables, flat = perturbed_params(init_flax(jm, x, mem, mem_pad), 14)
    tm = load_torch(port.DecoderBlock(D, H, FF, 0.0, **kw), flat)
    full_j, _ = apply_flax(jm, variables, x, mem, mem_pad, None, True)
    with torch.no_grad():
        full_t, _ = tm(t(x), t(mem), t(mem_pad))
    close(full_t, full_j)

    cross_j = apply_flax(jm, variables, mem, method=ref.DecoderBlock.project_cross_kv)
    cache_j = {"k": jnp.zeros((B, H, T, D // H)), "v": jnp.zeros((B, H, T, D // H)),
               "index": jnp.asarray(0, jnp.int32)}
    cache_t = {"k": torch.zeros(B, H, T, D // H), "v": torch.zeros(B, H, T, D // H), "index": 0}
    with torch.no_grad():
        cross_t = tm.project_cross_kv(t(mem))
    step = jax.jit(lambda v, xi, pad, c, kv: jm.apply(v, xi, None, pad, None, True, c, kv))
    for i in range(T):
        step_j, cache_j = step(variables, x[:, i:i + 1], mem_pad, cache_j, cross_j)
        with torch.no_grad():
            step_t, cache_t = tm(t(x[:, i:i + 1]), None, t(mem_pad), None, cache_t, cross_t)
        close(step_t, step_j)
        # the cached step reproduces the full causal sequence row by row
        close(step_t[:, 0], full_t[:, i], tol=1e-4)


def test_norms_use_flax_epsilon_and_statistics():
    x = _x(3, 5, 15) * 1e-3  # small inputs expose the epsilon
    import flax.linen as nn

    for jm, tm in ((nn.LayerNorm(), port.LayerNorm(D)), (nn.RMSNorm(), port.RMSNorm(D))):
        variables, flat = perturbed_params(init_flax(jm, x), 16)
        load_torch(tm, flat)
        with torch.no_grad():
            close(tm(t(x)), apply_flax(jm, variables, x))
