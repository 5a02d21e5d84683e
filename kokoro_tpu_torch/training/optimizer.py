"""Optimizer stack: ten-group AdamW with per-group LR schedules, per-tensor
gradient pre-clips, the post-step FFN weight-norm projection, EMA and the
gradient-explosion detector.

Port of ``kokoro_tpu/training/optimizer.py``.  The group labels, pre-clip
ceilings and weight-norm targets are decided here on the port's PARAMETER
NAMES (``encoder_layers.0.ff.linear1.weight``); for every parameter they
give the answer the reference gives on its flax path
(``convert._torch_name`` maps one onto the other: ``kernel``, ``embedding``
and norm ``scale`` are ``weight``; ``encoder_layer_i`` is
``encoder_layers.i``).  Schedules are plain Python functions of the
optimizer step.  :class:`FusedAdamW` runs one ``torch._foreach_*`` pass per
group over the f32 parameters: optax ``scale_by_adam`` bias correction,
decoupled weight decay, the LR evaluated at the pre-increment count.  The
parameters, moments and EMA are updated in place.  Under tensor parallelism
(a ``layout``, ``parallel/tp.py``) the pre-clips and the weight-norm
projection compare the norm of the WHOLE tensor with their ceiling: a
sharded tensor's squares summed over the ``model`` group.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional

import torch

from kokoro_tpu_torch.config import TrainingConfig
from kokoro_tpu_torch.parallel.tp import norms

GROUP_LABELS = (
    "encoder", "encoder_ffn", "decoder_no_decay", "decoder_other", "decoder_attn",
    "decoder_attn_no_decay", "decoder_ffn", "decoder_ffn_no_decay", "variance_embed",
    "stop_head",
)
_ENCODER_TOPS = ("text_embedding", "stress_embedding", "encoder_layers", "encoder_norm")


def _parts(name: str):
    keys = name.split(".")
    return keys, keys[0], keys[-1], f".{name}."


def label_for_name(name: str) -> str:
    """Optimizer group of a parameter (reference ``label_for_path``)."""
    keys, top, leaf, dotted = _parts(name)
    if top == "stop_token_predictor":
        return "stop_head"
    if top in ("variance_adaptor", "duration_adaptor"):
        if "pitch_embedding" in name or "energy_embedding" in name:
            return "variance_embed"
        return "decoder_no_decay"
    if top in _ENCODER_TOPS:
        if ".ff." in dotted and leaf == "weight" and "norm" not in name:
            return "encoder_ffn"
        return "encoder"
    # biases and every norm parameter are excluded from weight decay
    no_decay = leaf == "bias" or "norm" in name
    if ".ff." in dotted:
        return "decoder_ffn_no_decay" if no_decay else "decoder_ffn"
    if "self_attn" in name or "cross_attn" in name:
        return "decoder_attn_no_decay" if no_decay else "decoder_attn"
    return "decoder_no_decay" if no_decay else "decoder_other"


def group_lr_multiplier(label: str, config: TrainingConfig) -> float:
    return {
        "encoder": config.encoder_lr_multiplier,
        "encoder_ffn": config.encoder_lr_multiplier,
        "decoder_no_decay": 1.0,
        "decoder_other": 1.0,
        "decoder_attn": config.decoder_attn_lr_multiplier,
        "decoder_attn_no_decay": config.decoder_attn_lr_multiplier,
        "decoder_ffn": config.decoder_ffn_lr_multiplier,
        "decoder_ffn_no_decay": config.decoder_ffn_lr_multiplier,
        "variance_embed": config.variance_embedding_lr_multiplier,
        "stop_head": config.stop_head_lr_multiplier,
    }[label]


def group_weight_decay(label: str, config: TrainingConfig) -> float:
    return {
        "encoder": 0.0,
        "encoder_ffn": config.ffn_weight_decay,
        "decoder_no_decay": 0.0,
        "decoder_other": config.weight_decay,
        "decoder_attn": config.weight_decay,
        "decoder_attn_no_decay": 0.0,
        "decoder_ffn": config.decoder_ffn_weight_decay,
        "decoder_ffn_no_decay": 0.0,
        "variance_embed": 0.0,
        "stop_head": 0.0,
    }[label]


def _is_ffn_linear(name: str) -> bool:
    return ".ff." in f".{name}." and ("linear1" in name or "linear2" in name)


def preclip_norm_for_name(name: str, config: TrainingConfig) -> float:
    """Max L2 norm of this tensor's gradient before the global clip; 0 = none."""
    keys, top, leaf, _ = _parts(name)
    if top in ("mel_projection_in", "mel_projection_out"):
        return config.projection_spike_clip_norm
    if top == "stop_token_predictor":
        return config.stop_head_spike_clip_norm
    in_stack = top in ("encoder_layers", "decoder_layers")
    is_attn_w = (("self_attn" in name or "cross_attn" in name) and leaf == "weight"
                 and "norm" not in name)
    if in_stack and is_attn_w:
        return config.attention_spike_clip_norm
    if _is_ffn_linear(name):  # weights AND biases of linear1/linear2
        return (config.encoder_ffn_spike_clip_norm if top == "encoder_layers"
                else config.ffn_spike_clip_norm)
    return 0.0


def build_preclip_norms(names, config: TrainingConfig) -> Dict[str, float]:
    return {name: preclip_norm_for_name(name, config) for name in names}


def is_weight_norm_target(name: str) -> bool:
    """Encoder/decoder FFN linear weights, projected after each step."""
    top = name.split(".", 1)[0]
    return (top in ("encoder_layers", "decoder_layers") and _is_ffn_linear(name)
            and name.endswith(".weight"))


def apply_preclips(grads: List[torch.Tensor], ceilings: List[float],
                   names: Optional[List[str]] = None, layout=None) -> None:
    """Scale in place each gradient whose L2 norm exceeds its ceiling
    (``names`` and ``layout``: the norms of sharded tensors are whole)."""
    sel = [i for i, c in enumerate(ceilings) if c > 0]
    if not sel:
        return
    whole = norms([grads[i] for i in sel], names and [names[i] for i in sel], layout)
    scales = [torch.where(n > c, c / (n + 1e-12), torch.ones_like(n))
              for n, c in zip(whole, (ceilings[i] for i in sel))]
    torch._foreach_mul_([grads[i] for i in sel], scales)


@torch.no_grad()
def apply_weight_norm_constraints(params: Mapping[str, torch.Tensor],
                                  config: TrainingConfig, layout=None) -> None:
    """Project FFN linear weights back onto the L2 ball of radius
    ``dec_ffn_max_weight_norm`` (in place; whole-tensor norms under a
    ``layout``)."""
    max_norm = config.dec_ffn_max_weight_norm
    if max_norm <= 0:
        return
    names = [name for name in params if is_weight_norm_target(name)]
    targets = [params[name] for name in names]
    scales = [torch.where(n > max_norm, max_norm / (n + 1e-12), torch.ones_like(n))
              for n in norms(targets, names, layout)]
    torch._foreach_mul_(targets, scales)


# -- LR schedules ----------------------------------------------------------
def make_group_schedule(config: TrainingConfig, total_steps: int,
                        label: str) -> Callable[[int], float]:
    """Per-group LR as a function of the optimizer step: linear warmup, then
    OneCycle cosine (``use_onecycle_lr``), else per-epoch warm restarts."""
    base_lr = config.learning_rate * group_lr_multiplier(label, config)
    if not config.use_onecycle_lr:
        return _make_warm_restarts_schedule(config, total_steps, base_lr)
    mult = config.max_lr_multiplier
    max_lr = base_lr * mult
    warmup = min(config.warmup_steps, max(total_steps // 2, 1)) if config.use_warmup else 0
    onecycle_steps = max(total_steps - warmup, 1)
    div_factor = max(1.0, float(mult)) if config.use_warmup else 25.0
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / 1.0e4
    rise_steps = max(int(config.pct_start * onecycle_steps), 1)
    fall_steps = max(onecycle_steps - rise_steps, 1)
    warmup_start = base_lr * config.warmup_start_lr_ratio
    warmup_target = min(base_lr, max_lr)

    def clip01(x: float) -> float:
        return min(max(x, 0.0), 1.0)

    def schedule(step: int) -> float:
        step = float(step)
        if warmup and step < warmup:
            frac = clip01(step / max(warmup, 1))
            return warmup_start + (warmup_target - warmup_start) * frac
        t = max(step - warmup, 0.0)
        if t < rise_steps:
            frac = clip01(t / rise_steps)
            return max_lr + (initial_lr - max_lr) * (1.0 + math.cos(math.pi * frac)) / 2.0
        frac = clip01((t - rise_steps) / fall_steps)
        return min_lr + (max_lr - min_lr) * (1.0 + math.cos(math.pi * frac)) / 2.0

    return schedule


def _make_warm_restarts_schedule(config: TrainingConfig, total_steps: int,
                                 base_lr: float) -> Callable[[int], float]:
    """CosineAnnealingWarmRestarts stepped per epoch; steps per epoch are
    estimated as total_steps // num_epochs, as in the reference."""
    T_0 = max(int(config.lr_T_0), 1)
    T_mult = max(int(config.lr_T_mult), 1)
    eta_min = config.lr_eta_min
    steps_per_epoch = max(total_steps // max(config.num_epochs, 1), 1)

    def schedule(step: int) -> float:
        epoch = float(step // steps_per_epoch)
        if T_mult == 1:
            t_cur, t_i = epoch % T_0, float(T_0)
        else:
            n = math.floor(math.log(epoch / T_0 * (T_mult - 1) + 1.0) / math.log(T_mult))
            t_cur = epoch - T_0 * (T_mult ** n - 1.0) / (T_mult - 1)
            t_i = T_0 * float(T_mult) ** n
        return eta_min + (base_lr - eta_min) * (1.0 + math.cos(math.pi * t_cur / t_i)) / 2.0

    return schedule


# -- fused AdamW -----------------------------------------------------------
class FusedAdamW:
    """Ten-group AdamW over named f32 parameters, one ``torch._foreach_*``
    pass per group.  ``count`` is the number of updates applied; ``mu`` and
    ``nu`` the moments, in the order of ``names``."""

    def __init__(self, params: Mapping[str, torch.Tensor], config: TrainingConfig,
                 total_steps: int) -> None:
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.b1, self.b2, self.eps = config.adam_b1, config.adam_b2, config.adam_eps
        self.groups: Dict[str, List[int]] = {}
        for i, name in enumerate(self.names):
            self.groups.setdefault(label_for_name(name), []).append(i)
        self.schedules = {lab: make_group_schedule(config, total_steps, lab)
                          for lab in GROUP_LABELS}
        self.decays = {lab: group_weight_decay(lab, config) for lab in GROUP_LABELS}
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def lr(self, label: str) -> float:
        return self.schedules[label](self.count)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        t = self.count + 1
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for label, idx in self.groups.items():
            ps = [self.params[i] for i in idx]
            gs = [grads[i] for i in idx]
            mus = [self.mu[i] for i in idx]
            nus = [self.nu[i] for i in idx]
            torch._foreach_mul_(mus, self.b1)
            torch._foreach_add_(mus, gs, alpha=1.0 - self.b1)
            torch._foreach_mul_(nus, self.b2)
            torch._foreach_addcmul_(nus, gs, gs, value=1.0 - self.b2)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            update = torch._foreach_div(mus, bc1)
            torch._foreach_div_(update, denom)
            if self.decays[label]:
                torch._foreach_add_(update, ps, alpha=self.decays[label])
            torch._foreach_add_(ps, update, alpha=-self.lr(label))
        self.count += 1


# -- EMA and the explosion detector ----------------------------------------
def recommended_ema_decay(steps_per_epoch: int, half_life_epochs: float) -> float:
    """decay = exp(-ln 2 / (steps_per_epoch * half_life_epochs)), clipped to
    [0.9, 0.9999]."""
    if steps_per_epoch <= 0 or half_life_epochs <= 0:
        return 0.9999
    return max(0.9, min(math.exp(-math.log(2.0) / (steps_per_epoch * half_life_epochs)), 0.9999))


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor], decay: float) -> None:
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)


def grad_explosion_threshold(ema_norm: float, ema_steps: int, step: int,
                             config: TrainingConfig) -> float:
    """EMA * multiplier against a floor that decays linearly from the warmup
    floor to the final floor over ``grad_explosion_warmup_steps``; +inf until
    ``grad_explosion_min_ema_steps`` norms were observed."""
    if ema_steps < config.grad_explosion_min_ema_steps:
        return math.inf
    frac = min(max(step / max(config.grad_explosion_warmup_steps, 1), 0.0), 1.0)
    floor = (config.grad_explosion_warmup_floor
             + (config.grad_explosion_final_floor - config.grad_explosion_warmup_floor) * frac)
    return max(ema_norm * config.grad_explosion_ema_multiplier, floor)


def update_grad_explosion_ema(ema_norm: float, ema_steps: int, grad_norm: float,
                              decay: float) -> float:
    return grad_norm if ema_steps == 0 else decay * ema_norm + (1.0 - decay) * grad_norm
