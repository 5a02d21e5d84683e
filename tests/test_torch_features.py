"""Port's feature ops (kokoro_tpu_torch/ops/{stft,pitch,energy}.py) against
the JAX package's on the same audio, and against the golden reference
features (``tests/golden/audio_features*.npz``) at the tolerances
``tests/unit/test_golden_parity.py`` holds the JAX package to.

Tolerances: log-mel, port against JAX, 1e-3 rel / 2e-2 abs in the log
domain or 1e-3 rel / 1e-6 abs in the linear one (the golden test's cell
rule; empty mel bins sit at log(1e-9) where float32 FFT noise shows), all
cells; pitch voicing agreement > 0.93 and voiced RMSE < 0.02 (golden
limits); energy 1e-4 (golden limit).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kokoro_tpu.ops.energy import extract_energy_from_mel as jax_energy_mel
from kokoro_tpu.ops.energy import extract_energy_from_waveform as jax_energy_wav
from kokoro_tpu.ops.pitch import _masked_quantile as jax_masked_quantile
from kokoro_tpu.ops.pitch import extract_pitch as jax_pitch
from kokoro_tpu.ops.stft import log_mel_spectrogram as jax_log_mel
from kokoro_tpu_torch.ops.energy import extract_energy_from_mel, extract_energy_from_waveform
from kokoro_tpu_torch.ops.pitch import extract_pitch, masked_quantile
from kokoro_tpu_torch.ops.stft import log_mel_spectrogram
from tests.torch_parity import n, t

GOLDEN = Path(__file__).resolve().parent / "golden"


def _mel_cells_agree(ours, ref):
    close = np.isclose(ours, ref, rtol=1e-3, atol=2e-2)
    lin_close = np.isclose(np.exp(ours), np.exp(ref), rtol=1e-3, atol=1e-6)
    return close | lin_close


def _pitch_agrees(ours, ref, agree_min=0.93, rmse_max=0.02):
    T = min(ours.shape[-1], ref.shape[-1])
    ours, ref = ours[:T], ref[:T]
    assert np.mean((ours > 0) == (ref > 0)) > agree_min
    both = (ours > 0) & (ref > 0)
    if both.sum() > 10:
        assert float(np.sqrt(np.mean((ours[both] - ref[both]) ** 2))) < rmse_max


@pytest.fixture(scope="module")
def speechlike():
    """Two seconds of a harmonic source with word-like pitch moves and noise
    bursts, as the synthetic corpora of the repository are made."""
    rng = np.random.default_rng(3)
    sr = 22050
    pieces = []
    for _ in range(6):
        n_s = int(sr * rng.uniform(0.2, 0.4))
        tt = np.arange(n_s) / sr
        f0 = rng.uniform(100, 200) * (1.0 - 0.1 * tt)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        pieces.append(0.5 * np.sin(phase) + 0.25 * np.sin(2 * phase))
        pieces.append(0.05 * rng.standard_normal(int(sr * 0.05)))
    audio = np.concatenate(pieces)
    return (0.8 * audio / np.abs(audio).max()).astype(np.float32)


def test_log_mel_matches_jax(speechlike):
    ours = n(log_mel_spectrogram(t(speechlike)))
    ref = np.asarray(jax_log_mel(jnp.asarray(speechlike)))
    assert ours.shape == ref.shape
    assert _mel_cells_agree(ours, ref).all()


def test_pitch_and_energy_match_jax(speechlike):
    _pitch_agrees(n(extract_pitch(t(speechlike))), np.asarray(jax_pitch(jnp.asarray(speechlike))))
    # padded audio with the true frame count: the masked percentiles
    padded = np.pad(speechlike, (0, 9000))
    valid = speechlike.shape[0] // 256 + 1
    _pitch_agrees(n(extract_pitch(t(padded), valid_frames=valid)),
                  np.asarray(jax_pitch(jnp.asarray(padded), valid_frames=valid)))
    mel = np.asarray(jax_log_mel(jnp.asarray(speechlike)))
    np.testing.assert_allclose(n(extract_energy_from_mel(t(mel), log_domain=True)),
                               np.asarray(jax_energy_mel(jnp.asarray(mel), log_domain=True)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(extract_energy_from_waveform(t(speechlike))),
                               np.asarray(jax_energy_wav(jnp.asarray(speechlike))),
                               rtol=1e-4, atol=1e-4)


def test_masked_quantile_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 37)).astype(np.float32)
    valid = np.arange(37)[None, :] < np.asarray([[37], [20]])
    for q in (0.05, 0.25, 0.5, 0.95):
        np.testing.assert_allclose(n(masked_quantile(t(x), t(valid), q)),
                                   np.asarray(jax_masked_quantile(x, valid, q)), rtol=1e-6,
                                   atol=1e-6)


def test_golden_features():
    gold = np.load(GOLDEN / "audio_features.npz")
    wav = t(gold["waveform"])
    mel = n(log_mel_spectrogram(
        wav, sample_rate=int(gold["sample_rate"]), n_fft=int(gold["n_fft"]),
        hop_length=int(gold["hop_length"]), win_length=int(gold["win_length"]),
        n_mels=int(gold["n_mels"]), f_min=float(gold["f_min"]), f_max=float(gold["f_max"])))
    assert mel.shape == gold["log_mel"].shape
    assert (~_mel_cells_agree(mel, gold["log_mel"])).mean() < 1e-3
    _pitch_agrees(n(extract_pitch(wav, sample_rate=int(gold["sample_rate"]),
                                  hop_length=int(gold["hop_length"]))), gold["pitch"])
    np.testing.assert_allclose(n(extract_energy_from_mel(t(gold["log_mel"]), log_domain=True)),
                               gold["energy_mel"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(extract_energy_from_mel(t(gold["log_mel"]))),
                               gold["energy_mel"], rtol=1e-4, atol=1e-4)
    ours = n(extract_energy_from_waveform(wav, hop_length=int(gold["hop_length"]),
                                          win_length=int(gold["win_length"])))
    T = min(ours.shape[-1], gold["energy_wav"].shape[-1])
    np.testing.assert_allclose(ours[:T], gold["energy_wav"][:T], rtol=1e-3, atol=1e-4)
    assert (n(extract_pitch(torch.zeros(22050))) == 0.0).all()


@pytest.mark.parametrize("name", ["noise", "near_silence", "am_low_tone"])
def test_golden_audio_classes(name):
    gold = np.load(GOLDEN / "audio_features_extra.npz")
    wav = t(gold[f"{name}__waveform"])
    ref_mel = gold[f"{name}__log_mel"]
    assert (~_mel_cells_agree(n(log_mel_spectrogram(wav)), ref_mel)).mean() < 1e-3
    _pitch_agrees(n(extract_pitch(wav)), gold[f"{name}__pitch"], agree_min=0.9, rmse_max=0.03)
    np.testing.assert_allclose(n(extract_energy_from_mel(t(ref_mel), log_domain=True)),
                               gold[f"{name}__energy_mel"], rtol=1e-3, atol=1e-3)
