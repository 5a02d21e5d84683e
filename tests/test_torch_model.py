"""Port's KokoroModel against the JAX package's, the slice as a whole.

The teacher-forced forward runs the reference with ``use_flash_attention``
and its CPU test hook on, so its decoder attention goes through the Pallas
packed kernel in interpret mode (asserted by ``FUSED_TRACE_COUNT``); the
port takes its packed dispatcher, which on CPU tensors is the plain version.
The kernel gate of the reference needs head_dim 64/128 and T >= 128, hence
hidden 128 with 2 heads and T in {128, 144}.  Also ``encode_for_inference``,
the cross K/V projection and cached ``decode_step``.  Tolerance 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kokoro_tpu.models.blocks as ref_blocks
from kokoro_tpu.models.kokoro import KokoroModel as RefModel
from kokoro_tpu_torch.config import KokoroConfig
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.ops import fused_attention as port_attn
from tests.torch_parity import apply_flax, init_flax, load_torch, n, perturbed_params, t

TOL = 1e-4
ARCH = dict(vocab_size=59, n_mels=80, hidden_dim=128, n_encoder_layers=2,
            n_decoder_layers=2, n_heads=2, encoder_ff_dim=192, decoder_ff_dim=192,
            variance_filter_size=64)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(n(a), n(b), rtol=tol, atol=tol)


def _batch(T, seed, B=2, L=24):
    rng = np.random.default_rng(seed)
    dur = rng.integers(1, 2 * T // L, size=(B, L)).astype(np.int32)
    dur[1] = np.maximum(dur[1] // 2, 1)  # row 1 ends well before T: ragged memory
    pad = np.zeros((B, L), bool)
    pad[1, L - 5:] = True
    mel_len = np.asarray([T, T - 19])
    return dict(
        phoneme_indices=rng.integers(1, 59, size=(B, L)).astype(np.int32),
        mel_specs=rng.normal(-5.0, 2.0, size=(B, T, 80)).astype(np.float32),
        phoneme_durations=dur,
        stress_indices=rng.integers(0, 3, size=(B, L)).astype(np.int32),
        text_padding_mask=pad,
        mel_padding_mask=np.arange(T)[None, :] >= mel_len[:, None],
    )


@pytest.fixture(scope="module")
def params():
    """One perturbed parameter set (shapes do not depend on T) for every case."""
    batch = _batch(128, seed=0)
    jm = RefModel(**ARCH, gradient_checkpointing=False)
    return perturbed_params(init_flax(jm, **{k: jnp.asarray(v) for k, v in batch.items()}), 0)


def _pair(params, flash):
    variables, flat = params
    jm = RefModel(**ARCH, gradient_checkpointing=False, use_flash_attention=flash)
    tm = load_torch(KokoroModel(KokoroConfig(**ARCH, use_flash_attention=flash)), flat)
    return jm, variables, tm


@pytest.mark.parametrize("T,flash", [(128, True), (144, True), (144, False)],
                         ids=["packed-128", "packed-144", "einsum-144"])
def test_teacher_forced_forward(params, T, flash):
    batch = _batch(T, seed=T)
    jm, variables, tm = _pair(params, flash)
    old, count0 = ref_blocks.FUSED_ON_CPU_FOR_TESTS, ref_blocks.FUSED_TRACE_COUNT
    ref_blocks.FUSED_ON_CPU_FOR_TESTS = True
    try:
        ref = apply_flax(jm, variables, **batch)
    finally:
        ref_blocks.FUSED_ON_CPU_FOR_TESTS = old
    # the reference went through its Pallas packed kernel: self + cross per layer
    expected = 2 * ARCH["n_decoder_layers"] if flash else 0
    assert ref_blocks.FUSED_TRACE_COUNT - count0 == expected
    launches = port_attn.total_launches()
    with torch.no_grad():
        out = tm(**{k: t(v) for k, v in batch.items()})
    assert port_attn.total_launches() == launches  # CPU: plain version
    for key in ("predicted_mel", "predicted_stop_logits", "predicted_log_durations",
                "predicted_pitch", "predicted_energy"):
        close(out[key], ref[key])
    np.testing.assert_array_equal(n(out["frame_padding_mask"]), np.asarray(ref["frame_padding_mask"]))


def test_encode_for_inference_and_decode_steps(params):
    batch = _batch(128, seed=3)
    jm, variables, tm = _pair(params, flash=False)
    ph, st, pad = batch["phoneme_indices"], batch["stress_indices"], batch["text_padding_mask"]
    max_frames, steps = 96, 4
    mem_j, mask_j, exp_j = apply_flax(jm, variables, ph, st, pad, max_frames,
                                      method=RefModel.encode_for_inference)
    with torch.no_grad():
        mem_t, mask_t, exp_t = tm.encode_for_inference(t(ph), t(st), t(pad), max_frames)
    close(mem_t, mem_j)
    np.testing.assert_array_equal(n(mask_t), np.asarray(mask_j))
    np.testing.assert_array_equal(n(exp_t), np.asarray(exp_j))

    cross_j = apply_flax(jm, variables, mem_j, method=RefModel.project_memory_kv)
    with torch.no_grad():
        cross_t = tm.project_memory_kv(mem_t)
    for (kj, vj), (kt, vt) in zip(cross_j, cross_t):
        close(kt, kj)
        close(vt, vj)
    B, Hh, Dh = 2, ARCH["n_heads"], ARCH["hidden_dim"] // ARCH["n_heads"]
    caches_j = [{"k": jnp.zeros((B, Hh, steps, Dh)), "v": jnp.zeros((B, Hh, steps, Dh)),
                 "index": jnp.asarray(0, jnp.int32)} for _ in range(2)]
    caches_t = [{"k": torch.zeros(B, Hh, steps, Dh), "v": torch.zeros(B, Hh, steps, Dh),
                 "index": 0} for _ in range(2)]
    frame = np.zeros((B, 1, 80), np.float32)
    decode_step = jax.jit(functools.partial(jm.apply, method=RefModel.decode_step))
    for step in range(steps):
        mel_j, stop_j, caches_j = decode_step(variables, frame, jnp.asarray(step), caches_j,
                                              cross_j, mask_j)
        with torch.no_grad():
            mel_t, stop_t, caches_t = tm.decode_step(t(frame), step, caches_t, cross_t, mask_t)
        close(mel_t, mel_j)
        close(stop_t, stop_j)
        frame = np.asarray(mel_j)
