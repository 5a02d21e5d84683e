"""``inference/vocoder.py::export_hifigan_npz`` of the port against the JAX
package's exporter and loader, on one perturbed parameter set of a small
HiFi-GAN: the f32 file loads in the JAX ``load_hifigan_npz`` to the very
arrays and config; the int8 file holds the JAX exporter's arrays, scales and
config blob, key for key; the port's loader reads both back, and a generator
loaded from the f32 file computes what the exported one does."""

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from kokoro_tpu.inference.vocoder import export_hifigan_npz as ref_export
from kokoro_tpu.inference.vocoder import load_hifigan_npz as ref_load
from kokoro_tpu.models.hifigan import HiFiGANConfig as RefConfig
from kokoro_tpu.models.hifigan import HiFiGANGenerator as RefGenerator
from kokoro_tpu_torch.convert import hifigan_state_dict_from_flax
from kokoro_tpu_torch.inference.vocoder import export_hifigan_npz, load_hifigan_npz
from kokoro_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from tests.torch_parity import init_flax, perturbed_params, t

ARCH = dict(num_mels=8, upsample_initial_channel=16, upsample_rates=(2, 2),
            upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 3)))


@pytest.fixture(scope="module")
def pair():
    mel = np.random.default_rng(0).uniform(-9.0, 0.0, (1, 12, 8)).astype(np.float32)
    variables, flat = perturbed_params(init_flax(RefGenerator(RefConfig(**ARCH)), mel), 2,
                                       scale=0.1)
    gen = HiFiGANGenerator(HiFiGANConfig(**ARCH))
    gen.load_state_dict(hifigan_state_dict_from_flax(flat), strict=True)
    return variables, flat, gen.eval(), mel


def _raw(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_f32_export_loads_in_the_reference(pair, tmp_path):
    variables, flat, gen, _ = pair
    export_hifigan_npz(gen, tmp_path / "v.npz", config=HiFiGANConfig(**ARCH))
    params, cfg = ref_load(tmp_path / "v.npz")
    got = {k: np.asarray(v) for k, v in flatten_dict(params["params"], sep="/").items()}
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        assert np.array_equal(got[k], v), k
    assert cfg == RefConfig(**ARCH)


def test_int8_export_matches_the_reference_exporter(pair, tmp_path):
    variables, _, gen, _ = pair
    export_hifigan_npz(gen, tmp_path / "ours.npz", config=HiFiGANConfig(**ARCH), quantize="int8")
    ref_export(variables, tmp_path / "theirs.npz", config=RefConfig(**ARCH), quantize="int8")
    ours, theirs = _raw(tmp_path / "ours.npz"), _raw(tmp_path / "theirs.npz")
    assert ours.keys() == theirs.keys()
    assert any(k.endswith("::scale") for k in ours) and "__config__" in ours
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_the_ports_loader_round_trips_both_files(pair, tmp_path, quantize):
    variables, flat, gen, mel = pair
    export_hifigan_npz(gen, tmp_path / "v.npz", quantize=quantize)
    params, cfg = load_hifigan_npz(tmp_path / "v.npz")
    assert cfg is None and params.keys() == flat.keys()
    ref_params, _ = ref_load(tmp_path / "v.npz")
    ref_flat = flatten_dict(ref_params["params"], sep="/")
    for k, v in params.items():
        assert v.dtype == np.float32 and np.array_equal(v, np.asarray(ref_flat[k])), k
        if quantize is None:
            assert np.array_equal(v, flat[k]), k
        else:  # symmetric int8 per output channel: within half a step of the weight
            step = np.abs(flat[k]).max(axis=tuple(range(v.ndim - 1)), keepdims=True) / 127
            assert (np.abs(v - flat[k]) <= 0.5 * step + 1e-6).all(), k
    if quantize is None:
        again = HiFiGANGenerator(HiFiGANConfig(**ARCH))
        again.load_state_dict(hifigan_state_dict_from_flax(params), strict=True)
        with torch.no_grad():
            assert torch.equal(again.eval()(t(mel)), gen(t(mel)))


def test_unknown_quantize_mode_raises(pair, tmp_path):
    with pytest.raises(ValueError, match="unknown quantize mode"):
        export_hifigan_npz(pair[2], tmp_path / "v.npz", quantize="int4")
