"""HiFi-GAN V1 generator (vocoder).

Port of ``kokoro_tpu/models/hifigan.py``: conv_pre (n_mels -> 512, k=7), four
transposed-conv upsample stages (rates 8, 8, 2, 2; kernels 16, 16, 4, 4,
padding (k - s) // 2), each followed by three multi-receptive-field ResBlocks
(k 3/7/11, dilations 1/3/5) whose outputs are averaged, conv_post (-> 1, k=7)
and tanh; leaky-ReLU slope 0.1 throughout.

The interface keeps the reference's layout, mel ``(B, T, n_mels)`` ->
waveform ``(B, T * prod(rates))``; inside, convolutions run on ``(B, C, T)``.
Module names follow the flax tree (``convert.hifigan_state_dict_from_flax``);
:func:`hifigan_state_dict_from_torch` reads the original torch HiFi-GAN
layout (``.pth`` generators, weight-normed or not).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


@dataclass
class HiFiGANConfig:
    """universal_v1 defaults."""

    num_mels: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    sampling_rate: int = 22050


class Conv1d(nn.Module):
    """1-D conv with 'same' padding; the flax tree nests it as ``conv``."""

    def __init__(self, cin: int, cout: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel_size, dilation=dilation,
                              padding=(kernel_size - 1) * dilation // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(Conv1d(channels, channels, kernel_size, d) for d in dilations)
        self.convs2 = nn.ModuleList(Conv1d(channels, channels, kernel_size, 1) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            h = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = x + h
        return x


class HiFiGANGenerator(nn.Module):
    """mel (B, T, n_mels) -> waveform (B, T * prod(rates))."""

    def __init__(self, config: HiFiGANConfig | None = None):
        super().__init__()
        cfg = self.config = config or HiFiGANConfig()
        c0 = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.num_mels, c0, 7)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (rate, kernel) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            cin, cout = c0 // (2 ** i), c0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(cin, cout, kernel, rate, padding=(kernel - rate) // 2))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(cout, rk, tuple(rd)))
        self.conv_post = Conv1d(c0 // (2 ** len(cfg.upsample_rates)), 1, 7)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        n_kernels = len(self.config.resblock_kernel_sizes)
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            acc = None
            for j in range(n_kernels):
                out = self.resblocks[i * n_kernels + j](x)
                acc = out if acc is None else acc + out
            x = acc / n_kernels
        x = self.conv_post(F.leaky_relu(x, LRELU_SLOPE))
        return torch.tanh(x)[:, 0, :]


def fold_weight_norm(state: Mapping[str, torch.Tensor], prefix: str) -> torch.Tensor:
    """The effective conv weight at ``prefix``: ``prefix.weight``, or
    ``g * v / ||v||`` folded in float64 from a weight-normed checkpoint's
    ``weight_g`` / ``weight_v`` (norm over every dimension but the first;
    reference ``models/hifigan.py::_fold_weight_norm``)."""
    if f"{prefix}.weight" in state:
        return state[f"{prefix}.weight"].float()
    g = state[f"{prefix}.weight_g"].double()
    v = state[f"{prefix}.weight_v"].double()
    norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return (g * v / torch.clamp(norm, min=1e-12)).float()


def hifigan_state_dict_from_torch(state: Mapping[str, torch.Tensor],
                                  names: Iterable[str]) -> Dict[str, torch.Tensor]:
    """The state dict of :class:`HiFiGANGenerator` (its parameter ``names``)
    from a torch HiFi-GAN generator's: the same tensors without our
    ``.conv`` level (``conv_pre``, ``ups.i``, ``resblocks.b.convs{1,2}.j``,
    ``conv_post``), weights folded by :func:`fold_weight_norm`.  A missing
    key raises ``KeyError``."""
    out = {}
    for name in names:
        theirs = name.replace(".conv.", ".")
        if theirs.endswith(".weight"):
            out[name] = fold_weight_norm(state, theirs[: -len(".weight")])
        else:
            out[name] = state[theirs].float()
    return out
