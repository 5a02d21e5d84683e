"""The long-utterance regime (T >= 1024, where the port's decoder
self-attention takes K4, ``ops/flash_attention.py``) against the JAX package
on the same parameters, on the CPU.

Small model (hidden 128, 2 heads so head_dim 64, 2+2 layers, ff 256), B=2,
T=1024, every dropout rate 0.  One phoneme lasts 200 frames, so the adaptive
stabilization's ``risk > 1`` branch runs (200 / 150 frames): the loss scale
and the clip differ from their defaults.  The reference runs its einsum path
on the CPU (its flash gate asks for a TPU); one more forward runs the
reference's flash branch itself, with its gate's backend clause dropped and
the Pallas kernel in the TPU interpreter (``FLASH_TRACE_COUNT`` must grow).

The same at head_dim 256 (hidden 512 over 2 heads, 1+1 layers): K4 takes
the decoder self-attention at Dh 192 and 256 too, where the packed kernels'
gate (Dh 64 and 128, as the reference's) leaves the cross-attention and the
encoder on einsum.  And at head_dim 512 (hidden 512 at one head, 1+1
layers, the flagship's widths at n_heads=1): K4 past Dh 256, where the head
axis of the projections and the per-head norms has size 1.  And at head_dim
1536 (hidden 1536 at one head, 1+1 layers, ff 256): K4 past Dh 1024, where
the port's kernels split the head dim over a cluster of 12 CTAs; the
weights reach the port through the converter as at the other widths.

Tolerances: forward outputs 1e-4 (the port's forward parity tolerance,
tests/test_torch_model.py); one f32 train step, metrics 2e-5 relative and
parameters and EMA 4e-6 absolute (tests/test_torch_training.py's).
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import kokoro_tpu.models.blocks as ref_blocks
from kokoro_tpu_torch.models import blocks
from kokoro_tpu_torch.training.train_step import adaptive_stabilization
from tests.test_torch_training import (
    ARCH, Pair, assert_metrics, assert_state, make_batch, torch_batch,
)
from tests.torch_parity import apply_flax, n

T_LONG, L_LONG = 1024, 64
FORWARD_TOL = 1e-4
OUTPUTS = ("predicted_mel", "predicted_stop_logits", "predicted_log_durations",
           "predicted_pitch", "predicted_energy")


def long_batch(seed):
    batch = make_batch(seed, T=T_LONG, L=L_LONG)
    batch["phoneme_durations"][0, 3] = 200
    return batch


# head_dim 256: hidden 512 over the 2 heads, one encoder and one decoder layer
ARCH_DH256 = {**ARCH, "hidden_dim": 512, "n_encoder_layers": 1, "n_decoder_layers": 1}
# head_dim 512: hidden 512 at one head
ARCH_DH512 = {**ARCH_DH256, "n_heads": 1}
# head_dim 1536: hidden 1536 at one head
ARCH_DH1536 = {**ARCH_DH256, "hidden_dim": 1536, "n_heads": 1}


@pytest.fixture(scope="module")
def pair():
    return Pair("float32")


@pytest.fixture(scope="module")
def pair_dh256():
    return Pair("float32", arch=ARCH_DH256)


@pytest.fixture(scope="module")
def pair_dh512():
    return Pair("float32", arch=ARCH_DH512)


@pytest.fixture(scope="module")
def pair_dh1536():
    return Pair("float32", arch=ARCH_DH1536)


def _forward_inputs(batch):
    L = batch["phoneme_indices"].shape[1]
    keys = ("phoneme_indices", "mel_specs", "phoneme_durations", "stress_indices",
            "pitch_targets", "energy_targets")
    out = {k: batch[k] for k in keys}
    out["text_padding_mask"] = np.arange(L)[None, :] >= batch["phoneme_lengths"][:, None]
    return out


def _port_forward(pair, batch):
    model = pair.port_model().eval()
    with torch.no_grad():
        return model(**{k: torch.from_numpy(np.asarray(v)) for k, v in
                        _forward_inputs(batch).items()})


def _assert_outputs(port_out, ref_out, valid):
    for key in OUTPUTS:
        a, b = n(port_out[key]), np.asarray(ref_out[key])
        if a.ndim >= 2 and a.shape[1] == valid.shape[1]:  # frame outputs: valid frames
            a, b = a[valid], b[valid]
        np.testing.assert_allclose(a, b, rtol=FORWARD_TOL, atol=FORWARD_TOL, err_msg=key)


def _forward_takes_k4_and_matches_reference(pair, batch, monkeypatch):
    """The port's forward (K4 once per decoder layer, no packed kernel on the
    self-attention) against the reference's einsum path and its own flash
    branch: its gate without the backend clause, its Pallas kernel in the
    TPU interpreter."""
    calls, real = [], blocks.flash_attention
    packed, real_packed = [], blocks.packed_attention

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    def packed_spy(*args, **kwargs):
        packed.append(kwargs.get("causal"))
        return real_packed(*args, **kwargs)

    monkeypatch.setattr(blocks, "flash_attention", spy)
    monkeypatch.setattr(blocks, "packed_attention", packed_spy)
    port_out = _port_forward(pair, batch)
    assert len(calls) == pair.arch["n_decoder_layers"]  # K4 once per decoder layer
    assert True not in packed  # no decoder self-attention on K1
    ref_out = apply_flax(pair.jm, pair.variables, **_forward_inputs(batch))
    valid = np.arange(T_LONG)[None, :] < batch["mel_lengths"][:, None]
    _assert_outputs(port_out, ref_out, valid)

    def gate(q_len, kv_len, head_dim, causal=True):
        return (causal and q_len % ref_blocks._FLASH_BLOCK == 0
                and kv_len % ref_blocks._FLASH_BLOCK == 0 and head_dim % 64 == 0
                and q_len >= ref_blocks._FLASH_MIN_LEN and kv_len >= ref_blocks._FLASH_MIN_LEN)

    monkeypatch.setattr(ref_blocks, "_flash_supported", gate)
    before = ref_blocks.FLASH_TRACE_COUNT
    with pltpu.force_tpu_interpret_mode():
        flash_out = apply_flax(pair.jm, pair.variables, **_forward_inputs(batch))
    assert ref_blocks.FLASH_TRACE_COUNT > before
    _assert_outputs(port_out, flash_out, valid)
    return packed


def test_long_forward_takes_k4_and_matches_reference(pair, monkeypatch):
    _forward_takes_k4_and_matches_reference(pair, long_batch(1), monkeypatch)


def test_long_forward_at_head_dim_256_takes_k4_and_matches_reference(pair_dh256, monkeypatch):
    assert pair_dh256.arch["hidden_dim"] // pair_dh256.arch["n_heads"] == 256
    packed = _forward_takes_k4_and_matches_reference(pair_dh256, long_batch(1), monkeypatch)
    assert packed == []  # the cross-attention at Dh 256 stays on einsum too


def test_long_forward_at_head_dim_512_one_head_takes_k4_and_matches_reference(
        pair_dh512, monkeypatch):
    assert pair_dh512.arch["hidden_dim"] // pair_dh512.arch["n_heads"] == 512
    packed = _forward_takes_k4_and_matches_reference(pair_dh512, long_batch(4), monkeypatch)
    assert packed == []  # the cross-attention at Dh 512 stays on einsum too


def test_long_forward_at_head_dim_1536_one_head_takes_k4_and_matches_reference(
        pair_dh1536, monkeypatch):
    assert pair_dh1536.arch["hidden_dim"] // pair_dh1536.arch["n_heads"] == 1536
    packed = _forward_takes_k4_and_matches_reference(pair_dh1536, long_batch(6), monkeypatch)
    assert packed == []  # the cross-attention at Dh 1536 stays on einsum too


def test_long_train_step_matches_reference_with_stabilization_live(pair):
    batch = long_batch(2)
    scale, clip = adaptive_stabilization(torch_batch(batch), pair.cfg)
    assert float(scale) < 1.0 and float(clip) < pair.cfg.max_grad_norm  # risk = 200 / 150
    js, jm = pair.run_jax(pair.jax_state(), batch, 0)
    ps = pair.port_state()
    pm = pair.run_port(ps, batch, 0)
    assert pm["stepped"] == 1.0 and pm["loss_scale"] == pytest.approx(float(scale))
    assert_metrics(jm, pm)
    assert_state(js, ps)


def test_long_train_step_at_head_dim_256_matches_reference(pair_dh256):
    batch = long_batch(3)
    js, jm = pair_dh256.run_jax(pair_dh256.jax_state(), batch, 0)
    ps = pair_dh256.port_state()
    pm = pair_dh256.run_port(ps, batch, 0)
    assert pm["stepped"] == 1.0 and pm["loss_scale"] < 1.0
    assert_metrics(jm, pm)
    assert_state(js, ps)


def test_long_train_step_at_head_dim_512_one_head_matches_reference(pair_dh512):
    batch = long_batch(5)
    js, jm = pair_dh512.run_jax(pair_dh512.jax_state(), batch, 0)
    ps = pair_dh512.port_state()
    pm = pair_dh512.run_port(ps, batch, 0)
    assert pm["stepped"] == 1.0 and pm["loss_scale"] < 1.0
    assert_metrics(jm, pm)
    assert_state(js, ps)


def test_long_train_step_at_head_dim_1536_one_head_matches_reference(pair_dh1536):
    batch = long_batch(7)
    js, jm = pair_dh1536.run_jax(pair_dh1536.jax_state(), batch, 0)
    ps = pair_dh1536.port_state()
    pm = pair_dh1536.run_port(ps, batch, 0)
    assert pm["stepped"] == 1.0 and pm["loss_scale"] < 1.0
    assert_metrics(jm, pm)
    assert_state(js, ps)
