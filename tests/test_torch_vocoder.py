"""Port's vocoder against the JAX package: HiFi-GAN at a small config on one
parameter set (1e-4), the committed universal-V1 int8 weights
(docs/hifigan_v1_int8.npz) loaded by both on a 16-frame mel (1e-4), and
Griffin-Lim at 4 iterations from the same initial phases (1e-3)."""

import functools
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kokoro_tpu.inference.vocoder import load_hifigan_npz as ref_load_npz
from kokoro_tpu.models.hifigan import HiFiGANConfig as RefConfig
from kokoro_tpu.models.hifigan import HiFiGANGenerator as RefGenerator
from kokoro_tpu.ops.stft import griffin_lim as ref_griffin_lim
from kokoro_tpu_torch.convert import hifigan_state_dict_from_flax
from kokoro_tpu_torch.inference.vocoder import VocoderManager, load_hifigan_npz
from kokoro_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from kokoro_tpu_torch.ops.stft import griffin_lim
from tests.torch_parity import apply_flax, init_flax, n, perturbed_params, t

NPZ = Path(__file__).resolve().parents[1] / "docs" / "hifigan_v1_int8.npz"


def _mel(T, M, seed):
    return np.random.default_rng(seed).uniform(-9.0, 0.0, (T, M)).astype(np.float32)


def test_hifigan_small_config():
    arch = dict(num_mels=8, upsample_initial_channel=16, upsample_rates=(2, 2),
                upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 5),
                resblock_dilation_sizes=((1, 3), (1, 3)))
    mel = _mel(12, 8, 0)[None].repeat(2, 0)
    jm = RefGenerator(RefConfig(**arch))
    variables, flat = perturbed_params(init_flax(jm, mel), 1, scale=0.1)
    tm = HiFiGANGenerator(HiFiGANConfig(**arch))
    tm.load_state_dict(hifigan_state_dict_from_flax(flat), strict=True)
    with torch.no_grad():
        out = tm(t(mel))
    ref = apply_flax(jm, variables, mel)
    assert out.shape == ref.shape == (2, 12 * 4)
    np.testing.assert_allclose(n(out), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_committed_universal_v1_weights():
    params_j, cfg_j = ref_load_npz(NPZ)
    flat, cfg = load_hifigan_npz(NPZ)
    assert cfg is not None and cfg.upsample_rates == tuple(cfg_j.upsample_rates)
    mel = _mel(16, 80, 2)
    ref = jax.jit(RefGenerator(cfg_j).apply)(params_j, mel[None])[0]
    voc = VocoderManager(vocoder_path=str(NPZ), device="cpu")
    assert voc.vocoder_type == "hifigan"
    out = voc.mel_to_audio(mel)
    assert out.shape == (16 * 256,)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_missing_weights_fall_back_to_griffin_lim(tmp_path):
    voc = VocoderManager(vocoder_path=str(tmp_path / "absent.npz"), device="cpu",
                         griffin_lim_iters=2)
    assert voc.vocoder_type == "griffin_lim"
    audio = voc.mel_to_audio_batch(np.stack([_mel(6, 80, 3)] * 2))
    assert audio.shape == (2, 5 * 256) and np.isfinite(audio).all()


def test_griffin_lim_four_iterations():
    mel = _mel(20, 80, 4)
    ref = jax.jit(functools.partial(ref_griffin_lim, n_iter=4))(jnp.asarray(mel))
    angles = jax.random.uniform(jax.random.PRNGKey(0), (20, 513), minval=-math.pi, maxval=math.pi)
    out = griffin_lim(t(mel), n_iter=4, init_angles=t(np.asarray(angles)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(n(out), np.asarray(ref), rtol=1e-3, atol=1e-3)
