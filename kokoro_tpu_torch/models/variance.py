"""FastSpeech-2 style variance stack: duration/pitch/energy predictors and the
variance adaptor.

Port of ``kokoro_tpu/models/variance.py``:

* ``VariancePredictor``: 2 x (Conv1d(k=3, same) -> GroupNorm(1) -> ReLU ->
  Dropout) -> Linear(1); the GroupNorm statistics are taken over VALID frames
  only (eps 1e-5); the duration head's bias starts at log1p(5);
* ``VarianceAdaptor``: durations -> expansion -> frame-level pitch/energy ->
  256-bin bucketize over ``linspace(0, 1, n_bins - 1)`` (``torch.bucketize``
  with ``right=False`` is ``searchsorted(side="left")``) -> embeddings.
  Inference durations are ``clip(round(expm1(pred)), 0)``; ``torch.round``
  rounds half to even, as ``jnp.round`` does;
* ``SimpleDurationAdaptor``: an MLP duration predictor + gradient-preserving
  ``length_regulate``, no pitch/energy (``use_variance_predictor=False``).

Convolutions run on ``(B, C, L)``; the modules keep the reference's
``(B, L, C)`` layout at their interfaces.  Training draws its dropout from the
``rng`` argument (``models/rng.py``); the layers compute in their
``compute_dtype`` as in ``models/blocks.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from kokoro_tpu_torch.models.blocks import Embedding, Linear
from kokoro_tpu_torch.models.rng import Rng, dropout, fold
from kokoro_tpu_torch.ops.lengths import expand_tokens, length_regulate, token_to_frame_map


class _DeterministicConv1d(torch.autograd.Function):
    """A stride-1 ``F.conv1d`` whose backward runs cuDNN's deterministic
    algorithms: the default ones may sum the input and weight gradients with
    atomics, so that two runs of one training step on the card differed in
    every tensor upstream of the variance predictors (phase
    ``parallel_sp_pp`` of ``chip_smoke.py``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding, dilation):
        ctx.save_for_backward(x, weight)
        ctx.conv = (padding, dilation, bias is not None)
        return F.conv1d(x, weight, bias, padding=padding, dilation=dilation)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        padding, dilation, has_bias = ctx.conv
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], has_bias]
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=torch.backends.cudnn.allow_tf32):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad.contiguous(), x, weight, [weight.shape[0]] if has_bias else None,
                [1], [padding], [dilation], False, [0], 1, mask)
        return gx, gw, gb, None, None


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` that computes in ``compute_dtype`` (None: the weight's
    dtype), as a flax ``Conv(dtype=..., param_dtype=...)`` does, with stride 1
    and one group; its backward is bitwise the same run to run
    (:class:`_DeterministicConv1d`)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return _DeterministicConv1d.apply(x.to(dt), self.weight.to(dt), bias,
                                          self.padding[0], self.dilation[0])


def masked_group_norm(x, scale, bias, valid, eps: float = 1e-5):
    """GroupNorm(1) over (L, C) per sample of ``x`` (B, L, C), statistics over
    the frames where ``valid`` (B, L) is True (all frames when None).  The
    result has the promoted type of ``x`` and ``scale``, as in the reference
    (f32 scales lift a bf16 input to f32)."""
    x32 = x.float()
    if valid is None:
        mean = x32.mean(dim=(1, 2), keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    else:
        v = valid[:, :, None].float()
        count = torch.clamp(v.sum(dim=(1, 2), keepdim=True) * x.shape[2], min=1.0)
        mean = (x32 * v).sum(dim=(1, 2), keepdim=True) / count
        var = (((x32 - mean) ** 2) * v).sum(dim=(1, 2), keepdim=True) / count
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(torch.promote_types(x.dtype, scale.dtype))


class VariancePredictor(nn.Module):
    """Conv-stack scalar predictor: (B, L, H) -> (B, L), padding zeroed."""

    def __init__(self, hidden_dim: int = 512, filter_size: int = 256,
                 kernel_size: int = 3, dropout: float = 0.1, num_layers: int = 2,
                 output_bias: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            cin = hidden_dim if i == 0 else filter_size
            self.add_module(f"conv{i}", Conv1d(cin, filter_size, kernel_size,
                                               padding=(kernel_size - 1) // 2))
            self.register_parameter(f"norm{i}_scale", nn.Parameter(torch.ones(filter_size)))
            self.register_parameter(f"norm{i}_bias", nn.Parameter(torch.zeros(filter_size)))
        self.linear = Linear(filter_size, 1)
        self.dropout = dropout
        with torch.no_grad():
            self.linear.bias.fill_(output_bias)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rng: Optional[Rng] = None) -> torch.Tensor:
        valid = None if mask is None else ~mask.to(torch.bool)
        for i in range(self.num_layers):
            x = getattr(self, f"conv{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = masked_group_norm(x, getattr(self, f"norm{i}_scale"),
                                  getattr(self, f"norm{i}_bias"), valid)
            x = dropout(F.relu(x), self.dropout, fold(rng, f"dropout_{i}"), self.training)
            if valid is not None:
                x = torch.where(valid[:, :, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        out = self.linear(x)[..., 0]
        if mask is not None:
            out = torch.where(mask.to(torch.bool), torch.zeros((), dtype=out.dtype, device=out.device), out)
        return out


class SimpleDurationAdaptor(nn.Module):
    """MLP duration predictor + gradient-preserving ``length_regulate``;
    inference durations are ``expm1`` of the prediction clamped to >= 1."""

    def __init__(self, hidden_dim: int = 512, dropout: float = 0.1):
        super().__init__()
        self.linear1 = Linear(hidden_dim, hidden_dim)
        self.linear2 = Linear(hidden_dim, hidden_dim // 2)
        self.linear3 = Linear(hidden_dim // 2, 1)
        self.dropout = dropout

    def forward(self, encoder_output, max_frames: int, mask=None, pitch_target=None,
                energy_target=None, duration_target=None, rng: Optional[Rng] = None):
        h = dropout(F.relu(self.linear1(encoder_output)), self.dropout,
                    fold(rng, "dropout_0"), self.training)
        h = dropout(F.relu(self.linear2(h)), self.dropout, fold(rng, "dropout_1"),
                    self.training)
        dur_pred = self.linear3(h)[..., 0]
        if mask is not None:
            dur_pred = torch.where(mask.to(torch.bool), torch.zeros((), dtype=dur_pred.dtype, device=dur_pred.device), dur_pred)
        if duration_target is not None:
            durations = duration_target.to(torch.int32)
        else:
            durations = torch.clamp(torch.round(torch.expm1(dur_pred)), min=1).to(torch.int32)
        text_pad = (
            mask.to(torch.bool) if mask is not None
            else torch.zeros(encoder_output.shape[:2], dtype=torch.bool, device=encoder_output.device)
        )
        expanded, frame_mask = length_regulate(
            encoder_output, durations, text_pad, max_frames, stop_gradient=False
        )
        return expanded, dur_pred, None, None, frame_mask


class VarianceAdaptor(nn.Module):
    """Duration -> length regulation -> pitch/energy -> embedding adaptor."""

    # the reference model never sets its pitch/energy ranges: [0, 1] both
    PITCH_RANGE = ENERGY_RANGE = (0.0, 1.0)

    def __init__(self, hidden_dim: int = 512, filter_size: int = 256,
                 kernel_size: int = 3, dropout: float = 0.1, n_bins: int = 256,
                 length_regulator_stop_gradient: bool = True):
        super().__init__()
        self.n_bins = n_bins
        self.length_regulator_stop_gradient = length_regulator_stop_gradient
        common = dict(hidden_dim=hidden_dim, filter_size=filter_size,
                      kernel_size=kernel_size, dropout=dropout)
        self.duration_predictor = VariancePredictor(output_bias=math.log1p(5.0), **common)
        self.pitch_predictor = VariancePredictor(**common)
        self.energy_predictor = VariancePredictor(**common)
        self.pitch_embedding = Embedding(n_bins, hidden_dim)
        self.energy_embedding = Embedding(n_bins, hidden_dim)

    def quantize(self, values: torch.Tensor) -> torch.Tensor:
        boundaries = torch.linspace(0.0, 1.0, self.n_bins - 1, device=values.device)
        return torch.bucketize(values.float(), boundaries, right=False)

    @staticmethod
    def _normalize(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
        """Rescale to [0, 1] only when some value falls outside it."""
        out_of_range = (x.max() > 1.0) | (x.min() < 0.0)
        scaled = torch.clamp((x - lo) / (hi - lo + 1e-8), 0.0, 1.0)
        return torch.where(out_of_range, scaled, x)

    @staticmethod
    def _frames(target: torch.Tensor, max_frames: int) -> torch.Tensor:
        t = target[:, :max_frames]
        return F.pad(t, (0, max_frames - t.shape[1])) if t.shape[1] < max_frames else t

    def forward(self, encoder_output, max_frames: int, mask=None, pitch_target=None,
                energy_target=None, duration_target=None, rng: Optional[Rng] = None):
        """Returns (adapted (B,T,H), duration_pred (B,L) log1p-domain,
        pitch_pred (B,T), energy_pred (B,T), frame_mask (B,T) True = padding)."""
        duration_pred = self.duration_predictor(encoder_output, mask,
                                                rng=fold(rng, "duration_predictor"))
        if duration_target is not None:
            durations = duration_target
        else:
            durations = torch.clamp(torch.round(torch.expm1(duration_pred)), min=0)
        durations = torch.clamp(durations.to(torch.int32), min=0)
        if mask is not None:
            durations = torch.where(mask.to(torch.bool), 0, durations)

        x = expand_tokens(encoder_output, durations, max_frames,
                          stop_gradient=self.length_regulator_stop_gradient)
        _, frame_valid, _ = token_to_frame_map(durations, max_frames)
        frame_mask = ~frame_valid

        pitch_pred = self.pitch_predictor(x, frame_mask, rng=fold(rng, "pitch_predictor"))
        energy_pred = self.energy_predictor(x, frame_mask, rng=fold(rng, "energy_predictor"))
        if pitch_target is not None:
            p_val = self._normalize(self._frames(pitch_target, max_frames), *self.PITCH_RANGE)
        else:
            p_val = torch.clamp(pitch_pred, 0.0, 1.0)
        if energy_target is not None:
            e_val = self._normalize(self._frames(energy_target, max_frames), *self.ENERGY_RANGE)
        else:
            e_val = torch.clamp(energy_pred, 0.0, 1.0)

        adapted = (
            x + self.pitch_embedding(self.quantize(p_val))
            + self.energy_embedding(self.quantize(e_val))
        )
        adapted = torch.where(frame_mask[:, :, None], torch.zeros((), dtype=adapted.dtype, device=adapted.device), adapted)
        return adapted, duration_pred, pitch_pred, energy_pred, frame_mask
