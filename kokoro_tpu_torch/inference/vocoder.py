"""Vocoder: HiFi-GAN with the Griffin-Lim fallback.

Port of ``kokoro_tpu/inference/vocoder.py``: ``vocoder_type`` 'hifigan' or
'griffin_lim'; HiFi-GAN falls back to Griffin-Lim, with a warning, when its
weights are missing.  Weights come from an ``.npz`` of flax paths
(``docs/hifigan_v1_int8.npz`` is universal V1, int8 with per-channel scales):
a ``__config__`` JSON blob describes a non-universal generator, and a
``<key>::scale`` sibling dequantizes an int8 leaf.  A torch checkpoint
(``.pth`` / ``.pt``; its ``"generator"`` entry when it has one) in the
original HiFi-GAN layout loads too, weight norm folded
(``models/hifigan.py::hifigan_state_dict_from_torch``), into the universal V1
generator, as in the reference; an unknown layout logs an error and falls
back.  ``mel_to_audio_batch`` vocodes a whole group at once,
HiFi-GAN in chunks of 8 rows.  :func:`export_hifigan_npz` writes a torch
generator in that ``.npz`` format, f32 or int8, as the reference's exporter
writes it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from kokoro_tpu_torch.convert import flax_params_from_module, hifigan_state_dict_from_flax
from kokoro_tpu_torch.device import resolve_device
from kokoro_tpu_torch.models.hifigan import (
    HiFiGANConfig, HiFiGANGenerator, hifigan_state_dict_from_torch,
)
from kokoro_tpu_torch.ops.stft import griffin_lim

logger = logging.getLogger(__name__)

HIFIGAN_BATCH_CHUNK = 8


def load_hifigan_npz(path: str | Path) -> Tuple[dict, Optional[HiFiGANConfig]]:
    """``(flat float32 params keyed by flax path, HiFiGANConfig | None)``."""
    with np.load(Path(path), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    config = None
    blob = flat.pop("__config__", None)
    if blob is not None:
        cfg = json.loads(bytes(blob).decode("utf-8"))
        config = HiFiGANConfig(
            num_mels=cfg["num_mels"],
            upsample_initial_channel=cfg["upsample_initial_channel"],
            upsample_rates=tuple(cfg["upsample_rates"]),
            upsample_kernel_sizes=tuple(cfg["upsample_kernel_sizes"]),
            resblock_kernel_sizes=tuple(cfg["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(d) for d in cfg["resblock_dilation_sizes"]),
            sampling_rate=cfg.get("sampling_rate", 22050),
        )
    scales = {k[: -len("::scale")]: flat.pop(k) for k in [k for k in flat if k.endswith("::scale")]}
    params = {}
    for k, v in flat.items():
        if k in scales:
            v = v.astype(np.float32) * scales[k]
        params[k] = np.asarray(v, dtype=np.float32)
    return params, config


def export_hifigan_npz(generator: HiFiGANGenerator, path: str | Path,
                       config: Optional[HiFiGANConfig] = None,
                       quantize: Optional[str] = None) -> None:
    """Write ``generator``'s weights as the flax-path ``.npz`` that
    :func:`load_hifigan_npz` and the reference's loader read (port of
    ``kokoro_tpu/inference/vocoder.py::export_hifigan_npz``).  ``config``
    embeds the architecture as a ``__config__`` JSON blob.
    ``quantize="int8"`` stores every leaf of two or more dimensions as
    symmetric per-output-channel int8 beside a ``<key>::scale`` f32 array
    (absmax / 127 over every axis but the last, plus 1e-12), compressed;
    biases stay f32.  The same weights give the reference's arrays and
    scales."""
    flat = flax_params_from_module(generator)
    if quantize == "int8":
        for k, v in list(flat.items()):
            if v.ndim < 2:
                continue
            absmax = np.abs(v).max(axis=tuple(range(v.ndim - 1)), keepdims=True)
            scale = (absmax / 127.0 + 1e-12).astype(np.float32)
            flat[k] = np.clip(np.round(v / scale), -127, 127).astype(np.int8)
            flat[f"{k}::scale"] = scale
    elif quantize is not None:
        raise ValueError(f"unknown quantize mode: {quantize!r}")
    if config is not None:
        flat["__config__"] = np.frombuffer(
            json.dumps(dataclasses.asdict(config)).encode("utf-8"), dtype=np.uint8)
    save = np.savez_compressed if quantize else np.savez
    save(Path(path), **flat)


class VocoderManager:
    def __init__(
        self,
        vocoder_type: str = "hifigan",
        vocoder_path: Optional[str] = None,
        sample_rate: int = 22050,
        n_fft: int = 1024,
        hop_length: int = 256,
        win_length: int = 1024,
        n_mels: int = 80,
        f_min: float = 0.0,
        f_max: float = 8000.0,
        griffin_lim_iters: int = 60,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.audio = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                          n_mels=n_mels, f_min=f_min, f_max=f_max)
        self.griffin_lim_iters = griffin_lim_iters
        self.vocoder_type = vocoder_type
        self.hifigan: Optional[HiFiGANGenerator] = None
        if vocoder_type == "hifigan":
            self.hifigan = self._load_hifigan(vocoder_path, HiFiGANConfig(num_mels=n_mels))
            if self.hifigan is None:
                logger.warning("HiFi-GAN weights unavailable; falling back to Griffin-Lim")
                self.vocoder_type = "griffin_lim"

    def _load_hifigan(self, path: Optional[str], config: HiFiGANConfig
                      ) -> Optional[HiFiGANGenerator]:
        if path is None:
            return None
        path = Path(path)
        if not path.exists():
            logger.error("HiFi-GAN weights not found: %s", path)
            return None
        if path.suffix == ".npz":
            params, cfg = load_hifigan_npz(path)
            gen = HiFiGANGenerator(cfg or config)
            gen.load_state_dict(hifigan_state_dict_from_flax(params))
            return gen.to(self.device).eval()
        try:  # a torch checkpoint (.pth / .pt / generator file)
            ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
        except Exception as err:
            logger.error("Cannot load torch HiFi-GAN checkpoint: %s", err)
            return None
        state = ckpt.get("generator", ckpt) if isinstance(ckpt, dict) else ckpt
        gen = HiFiGANGenerator(config)
        try:
            gen.load_state_dict(hifigan_state_dict_from_torch(state, gen.state_dict()))
        except (KeyError, RuntimeError, AttributeError) as err:
            logger.error("Unexpected HiFi-GAN checkpoint layout (%s)", err)
            return None
        return gen.to(self.device).eval()

    @torch.no_grad()
    def mel_to_audio_batch(self, log_mels) -> np.ndarray:
        """(B, T, n_mels) log-mels -> (B, samples) waveforms."""
        mels = torch.as_tensor(np.asarray(log_mels, np.float32), device=self.device)
        if self.hifigan is not None:
            outs = [self.hifigan(mels[i : i + HIFIGAN_BATCH_CHUNK])
                    for i in range(0, mels.shape[0], HIFIGAN_BATCH_CHUNK)]
            return torch.cat(outs).cpu().numpy()
        a = self.audio
        return griffin_lim(
            mels, n_fft=a["n_fft"], hop_length=a["hop_length"], win_length=a["win_length"],
            n_iter=self.griffin_lim_iters, sample_rate=self.sample_rate, n_mels=a["n_mels"],
            f_min=a["f_min"], f_max=a["f_max"],
        ).cpu().numpy()

    def mel_to_audio(self, log_mel) -> np.ndarray:
        """(T, n_mels) log-mel -> float waveform."""
        return self.mel_to_audio_batch(np.asarray(log_mel, np.float32)[None])[0]
