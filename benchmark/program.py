"""The system under test: the port's training step, built from a
configuration file, with weights made on the device from the seed.

This is the only module of the harness that imports ``kokoro_tpu_torch``
(the traffic generator imports its batcher).  It takes from the port the
step as the trainer calls it (``create_train_state``, ``make_train_step``,
``build_preclip_norms``) and nothing else; the attention recorder reads the
shapes at the entries of ``ops/fused_attention.py`` and
``ops/flash_attention.py`` while a trace runs.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Dict, List, Optional

import torch


def configs(spec: dict, overrides: Optional[dict] = None):
    """``(KokoroConfig, TrainingConfig)`` of a configuration file's ``model``
    and ``training`` fields, with ``overrides`` (the mix's batching fields)
    on the training side."""
    from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig

    training = dict(spec["training"], **(overrides or {}))
    for key in ("mel_bucket_sizes", "phoneme_bucket_sizes"):
        if key in training:
            training[key] = tuple(training[key])
    return KokoroConfig(**spec["model"]), TrainingConfig(**training)


def init_scale(name: str, shape, m: dict) -> tuple:
    """(std, mean) of a parameter's draw, following the port's initializers:
    xavier for attention, FFN (gain 0.5 on its output) and convolutions,
    lecun for the projections and predictor heads, N(0, 1/sqrt(d)) for the
    embeddings but the stress embedding's N(0, 0.02), zero biases but the
    duration head's log1p(5), ones for the norm scales."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("bias"):
        return 0.0, math.log1p(5.0) if name.endswith("duration_predictor.linear.bias") else 0.0
    if len(shape) == 1:
        return 0.0, 1.0
    if "embedding" in name:
        return (0.02 if name.startswith("stress") else 1.0 / math.sqrt(shape[1])), 0.0
    fan_out, rf = shape[0], (shape[2] if len(shape) > 2 else 1)
    fan_in = shape[1] * rf
    if len(shape) > 2 or any(k in name for k in ("w_q", "w_k", "w_v", "w_o", "linear")):
        gain = 0.5 if name.endswith("ff.linear2.weight") else 1.0
        return gain * math.sqrt(2.0 / (fan_in + fan_out * rf)), 0.0
    return 1.0 / math.sqrt(fan_in), 0.0


def make_weights(shapes: Dict[str, tuple], m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from one normal draw of a generator on ``device``,
    scaled and shifted per parameter."""
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    stats = torch.tensor([init_scale(n, shapes[n], m) for n in names], device=device)
    counts = torch.tensor(sizes, device=device)
    flat = (flat * stats[:, 0].repeat_interleave(counts)
            + stats[:, 1].repeat_interleave(counts))
    return {n: t.view(shapes[n]) for n, t in zip(names, flat.split(sizes))}


class Program:
    """The port's state and step for one configuration, on ``device``."""

    def __init__(self, spec: dict, overrides: dict, seed: int, device) -> None:
        from kokoro_tpu_torch.models.kokoro import KokoroModel
        from kokoro_tpu_torch.training.optimizer import build_preclip_norms
        from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step

        self.model_cfg, self.train_cfg = configs(spec, overrides)
        run = spec["run"]
        with torch.device(device):
            model = KokoroModel(self.model_cfg)
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        weights = make_weights(shapes, spec["model"], seed, device)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(weights[n])
        del weights
        self.state = create_train_state(model, self.train_cfg, total_steps=run["total_steps"])
        self.step = make_train_step(self.train_cfg,
                                    build_preclip_norms(self.state.names, self.train_cfg),
                                    ema_decay=run["ema_decay"],
                                    spec_augment=self.train_cfg.use_spec_augment)

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.state.model.named_parameters()}

    def first_moment(self) -> Dict[str, torch.Tensor]:
        """The optimizer's first moments, by parameter name."""
        return dict(zip(self.state.optimizer.names, self.state.optimizer.mu))


@contextlib.contextmanager
def attention_recorder(calls: List[dict]):
    """While open, every call of the port's packed and flash attention
    entries appends ``{"kind", "B", "T", "H", "Dh", "dtype", "causal",
    "kv_lengths", "grad"}`` to ``calls``; the original entries are put back
    on close.  The key lengths stay a device tensor until read."""
    from kokoro_tpu_torch.ops import flash_attention as fl, fused_attention as fu

    originals = {"packed": fu.packed_attention, "flash": fl.flash_attention}

    def wrap(kind, fn):
        def recorded(q, k, v, **kw):
            if kind == "packed":
                B, T, D = q.shape
                H = kw["num_heads"]
                causal, lens = kw.get("causal", True), kw.get("kv_lengths")
            else:
                B, H, T, Dh = q.shape
                D, causal, lens = H * Dh, kw.get("causal", True), None
            calls.append({"kind": kind, "B": B, "T": T, "H": H, "Dh": D // H,
                          "dtype": str(q.dtype).replace("torch.", ""), "causal": causal,
                          "kv_lengths": None if causal else lens,
                          "grad": torch.is_grad_enabled() and q.requires_grad})
            return fn(q, k, v, **kw)
        return recorded

    patched = []
    for mod in [m for n, m in list(sys.modules.items())
                if n.split(".")[0] == "kokoro_tpu_torch" and m is not None]:
        for attr, value in list(vars(mod).items()):
            for kind, fn in originals.items():
                if value is fn:
                    setattr(mod, attr, wrap(kind, fn))
                    patched.append((mod, attr, fn))
    try:
        yield calls
    finally:
        for mod, attr, fn in patched:
            setattr(mod, attr, fn)
