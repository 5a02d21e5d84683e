"""Carry weights across from the JAX package, and write/read the port's model
directory.

The JAX package's parameters arrive as numpy arrays keyed by ``/``-joined flax
paths, as ``flax.traverse_util.flatten_dict(params, sep="/")`` gives them
(read an Orbax checkpoint with ``kokoro_tpu`` and ``np.savez`` the flattened
tree; the port itself reads only the ``.npz``).  The mapping:

* a path component ``encoder_layer_i`` / ``decoder_layer_i`` / ``ups_i`` /
  ``resblocks_i`` / ``convs1_i`` / ``convs2_i`` becomes ``<list>.i``;
* Dense ``kernel (in, out)`` -> ``weight (out, in)``;
* Conv ``kernel (k, in, out)`` -> ``weight (out, in, k)``; HiFi-GAN's
  transposed-conv ``kernel`` is already in torch layout ``(in, out, k)``;
* Embed ``embedding`` and norm ``scale`` -> ``weight``; everything else keeps
  its name.

:func:`train_state_from_flax` carries a whole training state across (params,
AdamW moments and count, EMA, the step counters).

A model directory holds ``model.pt`` (the state dict), ``metadata.json``
(``{"model_metadata": {...}}`` with the keys of
``kokoro_tpu/training/checkpoint.py::build_model_metadata`` and the inference
controls) and ``phoneme_processor.json`` (the processor's ``to_dict()``).
:func:`load_model_dir` also reads a port trainer's run directory
(``training/checkpoint.py``), which holds the same processor file.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from kokoro_tpu_torch.config import KokoroConfig

logger = logging.getLogger(__name__)

MODEL_FILE = "model.pt"
METADATA_FILE = "metadata.json"
PROCESSOR_FILE = "phoneme_processor.json"

_LISTS = {
    "encoder_layer": "encoder_layers", "decoder_layer": "decoder_layers",
    "ups": "ups", "resblocks": "resblocks", "convs1": "convs1", "convs2": "convs2",
}
_INDEXED = re.compile(r"^(" + "|".join(_LISTS) + r")_(\d+)$")


def _torch_name(path: str) -> str:
    parts = []
    for comp in path.split("/"):
        m = _INDEXED.match(comp)
        parts.append(f"{_LISTS[m.group(1)]}.{m.group(2)}" if m else comp)
    *head, leaf = parts
    if leaf in ("kernel", "embedding", "scale"):
        leaf = "weight"
    return ".".join(head + [leaf])


def _torch_value(path: str, value: np.ndarray) -> torch.Tensor:
    leaf = path.rsplit("/", 1)[-1]
    arr = np.asarray(value, dtype=np.float32)
    transposed_conv = path.startswith("ups_")
    if leaf == "kernel" and not transposed_conv:
        arr = arr.T if arr.ndim == 2 else arr.transpose(2, 1, 0)
    return torch.from_numpy(np.ascontiguousarray(arr))


def kokoro_state_dict_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``KokoroModel`` state dict from flattened flax params (``/``-joined
    paths, with or without a leading ``params/``)."""
    out = {}
    for path, value in flat.items():
        path = path[len("params/"):] if path.startswith("params/") else path
        out[_torch_name(path)] = _torch_value(path, value)
    return out


def hifigan_state_dict_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``HiFiGANGenerator`` state dict from flattened flax params."""
    return kokoro_state_dict_from_flax(flat)


def model_metadata(config: KokoroConfig) -> Dict[str, Any]:
    """The architecture keys the reference's ``build_model_metadata`` writes."""
    keys = (
        "vocab_size", "n_mels", "hidden_dim", "n_encoder_layers", "n_decoder_layers",
        "n_heads", "encoder_ff_dim", "decoder_ff_dim", "qk_norm", "rel_pos_type",
        "ffn_output_norm", "use_stress_embedding", "use_variance_predictor",
        "variance_filter_size", "n_variance_bins", "max_decoder_seq_len",
        "sample_rate", "hop_length",
    )
    return {k: getattr(config, k) for k in keys}


def save_model_dir(
    path: str | Path,
    state_dict: Mapping[str, torch.Tensor],
    model_metadata: Mapping[str, Any],
    phoneme_processor_dict: Mapping[str, Any],
    inference_controls: Mapping[str, Any] | None = None,
) -> Path:
    """Write ``model.pt``, ``metadata.json`` and ``phoneme_processor.json``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path / MODEL_FILE)
    meta = dict(model_metadata)
    meta["inference_controls"] = dict(
        inference_controls
        or {"max_seq_length": 1800, "stop_token_threshold": 0.5,
            "post_expected_stop_threshold": 0.2}
    )
    (path / METADATA_FILE).write_text(json.dumps({"model_metadata": meta}, indent=2))
    (path / PROCESSOR_FILE).write_text(
        json.dumps(dict(phoneme_processor_dict), ensure_ascii=False, indent=1), encoding="utf-8"
    )
    return path


def load_model_dir(path: str | Path, use_ema_weights: str = "auto"
                   ) -> tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``(state_dict, model_metadata)`` of a model directory, or of a
    trainer's run directory (``training/checkpoint.py::load_inference_weights``,
    which takes ``use_ema_weights``: auto | ema | model).  A model directory
    holds one set of weights, whatever ``use_ema_weights`` asks."""
    path = Path(path)
    if not (path / MODEL_FILE).exists():
        from kokoro_tpu_torch.training.checkpoint import load_inference_weights

        return load_inference_weights(path, use_ema_weights)
    if use_ema_weights != "auto":
        logger.warning("%s holds one set of weights; use_ema_weights=%r does not apply",
                       path, use_ema_weights)
    meta = json.loads((path / METADATA_FILE).read_text())["model_metadata"]
    state = torch.load(path / MODEL_FILE, map_location="cpu", weights_only=True)
    return state, meta


def train_state_from_flax(
    model: torch.nn.Module, config, total_steps: int, *,
    params: Mapping[str, np.ndarray], mu: Mapping[str, np.ndarray],
    nu: Mapping[str, np.ndarray], ema: Mapping[str, np.ndarray], count: int,
    opt_step: int, ema_updates: int, grad_ema: float, grad_ema_steps: int,
    skipped_steps: int,
):
    """The port's ``TrainState`` from the JAX package's ``TrainState``: its
    params, ``FusedAdamWState`` (count, mu, nu), EMA params (each flattened
    to ``/``-joined flax paths, as numpy) and its counters.  ``model`` takes
    the params; ``config`` is the port's ``TrainingConfig``.  A state taken
    mid-training (past warmup, explosion detector live) resumes exactly."""
    from kokoro_tpu_torch.training.train_step import create_train_state

    model.load_state_dict(kokoro_state_dict_from_flax(params), strict=True)
    state = create_train_state(model, config, total_steps)
    mu_t, nu_t, ema_t = (kokoro_state_dict_from_flax(x) for x in (mu, nu, ema))
    opt = state.optimizer
    with torch.no_grad():
        for i, name in enumerate(opt.names):
            opt.mu[i].copy_(mu_t[name])
            opt.nu[i].copy_(nu_t[name])
            state.ema[name].copy_(ema_t[name])
    opt.count = int(count)
    state.opt_step, state.ema_updates = int(opt_step), int(ema_updates)
    state.grad_ema, state.grad_ema_steps = float(grad_ema), int(grad_ema_steps)
    state.skipped_steps = int(skipped_steps)
    return state
