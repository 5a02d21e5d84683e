"""Port's AR ``generate`` against the JAX package's ``make_generate_fn``.

B=1 (scalar length API) and B=3 (per-row stop bookkeeping, ragged phoneme
padding).  The stop head's bias is set to +4 so every row stops by the
stop-token rule at its own ``min_expected`` bound:

* ``natural``: rows stop where the rule fires; lengths must be identical;
* ``forced``: ``min_len_floor`` fixes every length; mel compared at 1e-3
  (the AR feedback loop compounds f32 rounding over the steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from kokoro_tpu.models.generator import make_generate_fn
from kokoro_tpu.models.kokoro import KokoroModel as RefModel
from kokoro_tpu_torch.config import KokoroConfig
from kokoro_tpu_torch.models.generator import generate
from kokoro_tpu_torch.models.kokoro import KokoroModel
from tests.torch_parity import (
    init_flax, load_torch, n, perturbed_params, t, variables_from_flat,
)

ARCH = dict(vocab_size=59, n_mels=80, hidden_dim=64, n_encoder_layers=2,
            n_decoder_layers=2, n_heads=4, encoder_ff_dim=96, decoder_ff_dim=96,
            variance_filter_size=32)
MAX_FRAMES = 64


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    B, L, T = 1, 8, 16
    batch = dict(
        phoneme_indices=jnp.asarray(rng.integers(1, 59, (B, L)), jnp.int32),
        mel_specs=jnp.zeros((B, T, 80)),
        phoneme_durations=jnp.ones((B, L), jnp.int32),
        stress_indices=jnp.asarray(rng.integers(0, 3, (B, L)), jnp.int32),
    )
    jm = RefModel(**ARCH, gradient_checkpointing=False, use_stochastic_depth=False)
    _, flat = perturbed_params(init_flax(jm, **batch), 1)
    flat["stop_token_predictor/bias"] = np.asarray([4.0], np.float32)
    flat["mel_projection_out/bias"] = flat["mel_projection_out/bias"] - 5.0
    tm = load_torch(KokoroModel(KokoroConfig(**ARCH, use_stochastic_depth=False)), flat)
    return jm, variables_from_flat(flat), tm


def _inputs(B, seed):
    rng = np.random.default_rng(seed)
    L = 10
    lens = [10, 7, 4][:B]
    ph = rng.integers(1, 59, (B, L)).astype(np.int32)
    st = rng.integers(0, 3, (B, L)).astype(np.int32)
    pad = np.arange(L)[None, :] >= np.asarray(lens)[:, None]
    return ph, st, pad


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mode", ["natural", "forced"])
def test_generate_matches_reference(models, B, mode):
    jm, variables, tm = models
    ph, st, pad = _inputs(B, seed=B)
    kw = dict(min_len_floor=50 if mode == "forced" else 12)
    mel_j, len_j, exp_j = make_generate_fn(jm, MAX_FRAMES)(
        variables, jnp.asarray(ph), jnp.asarray(st), jnp.asarray(pad), **kw
    )
    mel_t, len_t, exp_t = generate(tm, t(ph), t(st), t(pad), MAX_FRAMES, **kw)
    assert n(len_t).shape == np.asarray(len_j).shape == (() if B == 1 else (B,))
    np.testing.assert_array_equal(n(exp_t), np.asarray(exp_j))
    np.testing.assert_array_equal(n(len_t), np.asarray(len_j))
    lengths = np.atleast_1d(np.asarray(len_j))
    assert lengths.min() > 12
    if mode == "forced":
        assert (lengths == 51).all()
    elif B == 3:
        assert len(set(lengths.tolist())) > 1  # rows stopped at their own bound
    np.testing.assert_allclose(n(mel_t), np.asarray(mel_j), rtol=1e-3, atol=1e-3)
