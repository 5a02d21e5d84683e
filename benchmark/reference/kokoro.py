"""Plain PyTorch reference of one Kokoro training step, in float32.

It follows the published model (kokoro-ruslan's text encoder, FastSpeech-2
variance adaptor and teacher-forced autoregressive decoder) as the port
trains it: the same parameter names, the same random sites and seeds, the
same losses, stabilization, pre-clips, global clip, ten-group AdamW and
weight-norm projection.  The EMA is left out: three steps at the configs'
decay of 0.999 move it by about 2e-3 of the parameters' change, under the
float32 resolution of the parameters.  The explosion detector never fires in
three steps (it waits for 100 norms).  It imports nothing of the port: every
mask is drawn again here from the step's seed (``reference/rng.py``), the
attention kernels' Philox dropout among them.

All products are float32 with TF32 off.  ``cast`` is applied where the port
computes in its compute dtype: the inputs and outputs of every linear,
convolution and embedding, q, k, v, the attention weights before their
product with v and that product.  It is the identity for the reference and
a lower precision for the control.

The batch is run in blocks of rows, so that the full attention matrices of
one block fit beside the rest: each block's masked sums are divided by the
whole batch's counts, and the blocks' gradients are summed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import rng as R

NEG_INF = -1e9
Cast = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _scaled(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale that takes its
    largest magnitude to ``top``."""
    s = top / x.abs().amax().clamp(min=1e-30)
    return (x * s).to(dtype).to(x.dtype) / s


class _Fp8(torch.autograd.Function):
    """float8 both ways, the usual recipe of fp8 training: e4m3 forward,
    e5m2 for the gradient flowing back, each under a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _scaled(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _scaled(grad, torch.float8_e5m2, 57344.0)


def fp8_cast(x: torch.Tensor) -> torch.Tensor:
    """The control's precision, where the port computes in bf16."""
    return _Fp8.apply(x)


class Block:
    """Rows ``rows`` of a batch of ``B`` rows: what a site's mask over the
    whole batch gives these rows."""

    def __init__(self, rows: range, B: int, device) -> None:
        self.rows, self.B, self.device = rows, B, device

    def rand(self, seed: int, shape) -> torch.Tensor:
        u = R.uniform(seed, (self.B,) + tuple(shape), self.device)
        return u[self.rows.start:self.rows.stop]


def dropout(x, rate: float, seed: int, blk: Block):
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = blk.rand(seed, x.shape[1:]) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x, rate: float, seed: int, blk: Block):
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = blk.rand(seed, (1,) * (x.dim() - 1)) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def linear(p, name, x, cast: Cast, bias=True):
    b = p.get(f"{name}.bias") if bias else None
    return cast(F.linear(cast(x), cast(p[f"{name}.weight"]), None if b is None else cast(b)))


def layer_norm(p, name, x, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + eps) * p[f"{name}.weight"]) + p[f"{name}.bias"]


def rms_norm(p, name, x, eps=1e-6):
    var = (x * x).mean(-1, keepdim=True)
    return x * (torch.rsqrt(var + eps) * p[f"{name}.weight"])


def sinusoid(length: int, dim: int, device) -> torch.Tensor:
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-np.log(10000.0) / dim))
    table = np.zeros((length, dim), dtype=np.float64)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: table[:, 1::2].shape[1]])
    return torch.as_tensor(table, dtype=torch.float32, device=device)


def rope(x: torch.Tensor, T: int) -> torch.Tensor:
    """Interleaved rotary positions 0..T-1 on ``(..., T, Dh)``."""
    half = x.shape[-1] // 2
    inv = 1.0 / (10000.0 ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    pairs = x.reshape(*x.shape[:-1], half, 2)
    x1, x2 = pairs[..., 0], pairs[..., 1]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).reshape(x.shape)


def heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, H, D // H).transpose(1, 2)


def attention(p, name, xq, xkv, H: int, cast: Cast, *, use_rope: bool, causal: bool,
              key_pad=None, rate: float = 0.0, seed: int = 0, kernel_mask: bool = False,
              blk: Block):
    """Multi-head attention with per-head q/k/v RMSNorm: f32 logits, the
    causal and key masks at -1e9, f32 softmax, weight dropout (the kernels'
    Philox mask where ``kernel_mask``, else the plain route's uniforms),
    then w_o."""
    q = rms_norm(p, f"{name}.q_norm", heads(linear(p, f"{name}.w_q", xq, cast, False), H))
    k = rms_norm(p, f"{name}.k_norm", heads(linear(p, f"{name}.w_k", xkv, cast, False), H))
    v = rms_norm(p, f"{name}.v_norm", heads(linear(p, f"{name}.w_v", xkv, cast, False), H))
    Tq, Tk = q.shape[2], k.shape[2]
    if use_rope:
        q, k = rope(q, Tq), rope(k, Tk)
    q, k, v = cast(q), cast(k), cast(v)
    s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    neg = torch.full((), NEG_INF, device=s.device)
    if causal:
        s = torch.where(torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril(), s, neg)
    if key_pad is not None:
        s = torch.where(key_pad[:, None, None, :], neg, s)
    w = torch.softmax(s, dim=-1)
    if rate > 0.0:
        keep = 1.0 - rate
        if kernel_mask:
            mask = R.attention_keep(seed, blk.rows, H, Tq, rate, s.device)
        else:
            mask = blk.rand(seed, w.shape[1:]) < keep
        w = torch.where(mask, w / keep, torch.zeros((), device=w.device))
    out = cast(torch.matmul(cast(w), v)).transpose(1, 2).reshape(xq.shape[0], Tq, -1)
    return linear(p, f"{name}.w_o", out, cast)


def glu(p, name, x, rate, seed, cast: Cast, blk: Block):
    gate, lin = linear(p, f"{name}.linear1", x, cast).chunk(2, dim=-1)
    h = dropout(F.gelu(gate, approximate="tanh") * lin, rate, R.fold(seed, "dropout_0"), blk)
    h = rms_norm(p, f"{name}.output_norm", linear(p, f"{name}.linear2", h, cast))
    return dropout(h, rate, R.fold(seed, "dropout_1"), blk)


def residual(out, i, drop_rate, path_rate, seed, blk):
    out = drop_path(out, path_rate, R.fold(seed, f"drop_path_{i}"), blk)
    return dropout(out, drop_rate, R.fold(seed, f"dropout_{i}"), blk)


def path_rates(n: int, m: dict) -> List[float]:
    if not m["use_stochastic_depth"]:
        return [0.0] * n
    return [(i / max(n - 1, 1)) * m["stochastic_depth_rate"] for i in range(n)]


def conv(p, name, x, cast: Cast):
    """Stride-1 'same' convolution over ``(B, L, C)``."""
    w = p[f"{name}.weight"]
    y = cast(F.conv1d(cast(x.transpose(1, 2)), cast(w), cast(p[f"{name}.bias"]),
                      padding=(w.shape[-1] - 1) // 2))
    return y.transpose(1, 2)


def variance_predictor(p, name, x, pad, rate, seed, cast: Cast, blk: Block):
    valid = ~pad
    v = valid[:, :, None].float()
    for i in range(2):
        x = conv(p, f"{name}.conv{i}", x, cast)
        count = torch.clamp(v.sum(dim=(1, 2), keepdim=True) * x.shape[2], min=1.0)
        mean = (x * v).sum(dim=(1, 2), keepdim=True) / count
        var = (((x - mean) ** 2) * v).sum(dim=(1, 2), keepdim=True) / count
        x = (x - mean) * torch.rsqrt(var + 1e-5) * p[f"{name}.norm{i}_scale"] \
            + p[f"{name}.norm{i}_bias"]
        x = dropout(F.relu(x), rate, R.fold(seed, f"dropout_{i}"), blk)
        x = torch.where(valid[:, :, None], x, torch.zeros((), device=x.device))
    out = linear(p, f"{name}.linear", x, cast)[..., 0]
    return torch.where(pad, torch.zeros((), device=out.device), out)


def expand(tokens, durations, T):
    """Frames ``(B, T, D)`` of per-token values repeated by ``durations``;
    frames past each row's total are zero.  Returns (frames, frame_pad)."""
    ends = torch.cumsum(durations.long(), dim=1)
    total = torch.clamp(ends[:, -1], max=T)
    frames = torch.arange(T, device=tokens.device)
    idx = torch.searchsorted(ends.contiguous(), frames.expand(ends.shape[0], T).contiguous(),
                             right=True).clamp(0, durations.shape[1] - 1)
    valid = frames[None, :] < total[:, None]
    out = torch.gather(tokens, 1, idx[:, :, None].expand(-1, -1, tokens.shape[2]))
    return torch.where(valid[:, :, None], out, torch.zeros((), device=out.device)), ~valid


def forward(p: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor], seed: int, m: dict,
            t: dict, cast: Cast, blk: Block, pitch_scaled: bool, energy_scaled: bool):
    """The training forward of rows ``blk`` of batch ``b`` (its tensors cut to
    those rows); the model's outputs."""
    D, H = m["hidden_dim"], m["n_heads"]
    ph, dur = b["phoneme_indices"].long(), b["phoneme_durations"]
    L, T = ph.shape[1], b["mel_specs"].shape[1]
    dev = ph.device
    text_pad = torch.arange(L, device=dev)[None, :] >= b["phoneme_lengths"][:, None]
    mel_pad = torch.arange(T, device=dev)[None, :] >= b["mel_lengths"][:, None]
    enc_rate, dec_rate = m["encoder_dropout"], m["decoder_dropout"]
    attn_on = m["attention_weight_dropout"]

    # text encoder
    x = cast(F.embedding(ph, cast(p["text_embedding.weight"])) * math.sqrt(D))
    if m["use_stress_embedding"]:
        st = b["stress_indices"].long()
        x = x + F.embedding(st, cast(p["stress_embedding.weight"])) * (st != 0)[..., None]
    x = dropout(x + sinusoid(L, D, dev)[None], enc_rate, R.fold(seed, "pe_dropout"), blk)
    for i, pr in enumerate(path_rates(m["n_encoder_layers"], m)):
        s, n = R.fold(seed, f"encoder_layer_{i}"), f"encoder_layers.{i}"
        h = layer_norm(p, f"{n}.norm1", x)
        a = attention(p, f"{n}.self_attn", h, h, H, cast, use_rope=True, causal=False,
                      key_pad=text_pad, rate=enc_rate if attn_on else 0.0,
                      seed=R.fold(s, "self_attn"), blk=blk)
        x = x + residual(a, 0, enc_rate, pr, s, blk)
        f = glu(p, f"{n}.ff", layer_norm(p, f"{n}.norm2", x), enc_rate, R.fold(s, "ff"), cast,
                blk)
        x = x + residual(f, 1, enc_rate, pr, s, blk)
    enc = torch.where(text_pad[:, :, None], torch.zeros((), device=dev),
                      layer_norm(p, "encoder_norm", x))

    # variance adaptor
    s_ad = R.fold(seed, "variance_adaptor")
    va, vr = "variance_adaptor", m["variance_dropout"]
    dur_pred = variance_predictor(p, f"{va}.duration_predictor", enc, text_pad, vr,
                                  R.fold(s_ad, "duration_predictor"), cast, blk)
    durations = torch.where(text_pad, 0, torch.clamp(dur.long(), min=0))
    tokens = enc.detach() if m["length_regulator_stop_gradient"] else enc
    x, frame_pad = expand(tokens, durations, T)
    pitch_pred = variance_predictor(p, f"{va}.pitch_predictor", x, frame_pad, vr,
                                    R.fold(s_ad, "pitch_predictor"), cast, blk)
    energy_pred = variance_predictor(p, f"{va}.energy_predictor", x, frame_pad, vr,
                                     R.fold(s_ad, "energy_predictor"), cast, blk)
    bins = torch.linspace(0.0, 1.0, m["n_variance_bins"] - 1, device=dev)

    def level(target, scaled):
        v = target[:, :T]
        v = torch.clamp(v / (1.0 + 1e-8), 0.0, 1.0) if scaled else v
        return torch.bucketize(v, bins, right=False)

    x = (x + F.embedding(level(b["pitch_targets"], pitch_scaled),
                         cast(p[f"{va}.pitch_embedding.weight"]))
         + F.embedding(level(b["energy_targets"], energy_scaled),
                       cast(p[f"{va}.energy_embedding.weight"])))
    memory = torch.where(frame_pad[:, :, None], torch.zeros((), device=dev), x)
    if t["use_spec_augment"]:
        memory = memory * spec_augment_keep(R.fold(seed, "specaugment"), memory.shape[1:],
                                            t, blk)

    # teacher-forced decoder
    mel_in = F.pad(b["mel_specs"][:, :-1, :], (0, 0, 1, 0))
    x = dropout(linear(p, "mel_projection_in", mel_in, cast), m["decoder_input_dropout"],
                R.fold(seed, "input_dropout"), blk)
    x = x + sinusoid(T, D, dev)[None]
    kv_pad = frame_pad  # K2 masks keys past each row's frame count
    for i, pr in enumerate(path_rates(m["n_decoder_layers"], m)):
        s, n = R.fold(seed, f"decoder_layer_{i}"), f"decoder_layers.{i}"
        rate = dec_rate if attn_on else 0.0
        h = layer_norm(p, f"{n}.norm1", x)
        a = attention(p, f"{n}.self_attn", h, h, H, cast, use_rope=True, causal=True,
                      rate=rate, seed=R.fold(s, "self_attn"), kernel_mask=True, blk=blk)
        x = x + residual(a, 0, dec_rate, pr, s, blk)
        c = attention(p, f"{n}.cross_attn", layer_norm(p, f"{n}.norm2", x), memory, H, cast,
                      use_rope=False, causal=False, key_pad=kv_pad, rate=rate,
                      seed=R.fold(s, "cross_attn"), kernel_mask=True, blk=blk)
        x = x + residual(c, 1, dec_rate, pr, s, blk)
        f = glu(p, f"{n}.ff", layer_norm(p, f"{n}.norm3", x), dec_rate, R.fold(s, "ff"), cast,
                blk)
        x = x + residual(f, 2, dec_rate, pr, s, blk)
    x = layer_norm(p, "decoder_norm", x)
    return {
        "predicted_mel": linear(p, "mel_projection_out", x, cast),
        "predicted_stop_logits": linear(p, "stop_token_predictor", x.detach(), cast)[..., 0],
        "predicted_log_durations": dur_pred, "predicted_pitch": pitch_pred,
        "predicted_energy": energy_pred, "mel_pad": mel_pad, "text_pad": text_pad,
    }


def spec_augment_keep(seed: int, shape, t: dict, blk: Block) -> torch.Tensor:
    """SpecAugment's keep mask ``(rows, T, D)``: per row, time spans and
    feature spans of uniform width and start, drawn from one generator for
    the whole batch in the port's order."""
    T, D = shape
    gen = torch.Generator(device=blk.device).manual_seed(seed)

    def spans(size, max_width, n):
        widths = torch.randint(0, max_width + 1, (blk.B, n), generator=gen, device=blk.device)
        high = torch.clamp(size - widths, min=1)
        starts = (torch.rand((blk.B, n), generator=gen, device=blk.device) * high).long()
        starts = torch.minimum(starts, high - 1)
        pos = torch.arange(size, device=blk.device)[None, None, :]
        hit = (pos >= starts[:, :, None]) & (pos < (starts + widths)[:, :, None])
        return hit.any(dim=1)[blk.rows.start:blk.rows.stop]

    time = spans(T, t["spec_augment_time_mask_max"], t["spec_augment_num_time_masks"])
    freq = spans(D, t["spec_augment_freq_mask_max"], t["spec_augment_num_freq_masks"])
    return (~(time[:, :, None] | freq[:, None, :])).float()


def huber(pred, target, delta):
    err = (pred - target).abs()
    return torch.where(err < delta, 0.5 * err ** 2, delta * (err - 0.5 * delta))


def loss_terms(out, b, t: dict):
    """Masked sums of the five loss terms over the block's rows, and the
    masks they were taken over."""
    mel_valid = ~out["mel_pad"]
    ph_valid = (~out["text_pad"]) & (b["phoneme_durations"] > 0)
    T = b["mel_specs"].shape[1]
    zero = torch.zeros((), device=mel_valid.device)
    log_d = torch.log(b["phoneme_durations"].float() + 1.0)
    z = b["stop_token_targets"]
    x = out["predicted_stop_logits"]
    bce = (t["stop_token_pos_weight"] * z * torch.logaddexp(-x, zero)
           + (1.0 - z) * torch.logaddexp(x, zero))
    terms = {
        "mel": ((out["predicted_mel"] - b["mel_specs"]).abs(), mel_valid[:, :, None]),
        "duration": (huber(out["predicted_log_durations"], log_d, t["duration_huber_delta"]),
                     ph_valid),
        "stop": (bce, mel_valid),
        "pitch": (huber(out["predicted_pitch"][:, :T], b["pitch_targets"][:, :T],
                        t["pitch_huber_delta"]), mel_valid),
        "energy": (huber(out["predicted_energy"][:, :T], b["energy_targets"][:, :T],
                         t["energy_huber_delta"]), mel_valid),
    }
    sums = {k: torch.where(mask.expand_as(v), v, zero).sum() for k, (v, mask) in terms.items()}
    return sums


LOSS_WEIGHTS = {"mel": None, "duration": "duration_loss_weight",
                "stop": "stop_token_loss_weight", "pitch": "pitch_loss_weight",
                "energy": "energy_loss_weight"}
CLAMPS = {"mel": 100.0, "duration": 100.0, "stop": 100.0, "pitch": 10.0, "energy": 10.0}


def counts(b: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The whole batch's element counts of each loss term's mask."""
    T, M = b["mel_specs"].shape[1], b["mel_specs"].shape[2]
    L = b["phoneme_indices"].shape[1]
    dev = b["mel_specs"].device
    mel = (torch.arange(T, device=dev)[None] < b["mel_lengths"][:, None]).sum().item()
    ph = ((torch.arange(L, device=dev)[None] < b["phoneme_lengths"][:, None])
          & (b["phoneme_durations"] > 0)).sum().item()
    return {"mel": mel * M, "duration": ph, "stop": mel, "pitch": mel, "energy": mel}


def losses_and_grads(params: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor], seed: int,
                     m: dict, t: dict, cast: Cast, block_rows: int):
    """The step's losses (floats) and the gradient of its total loss for
    every parameter, over blocks of ``block_rows`` rows."""
    B = b["mel_specs"].shape[0]
    n = counts(b)
    weights = {k: 1.0 if w is None else t[w] for k, w in LOSS_WEIGHTS.items()}
    # the port rescales a target to [0, 1] when any value of the batch falls outside
    scaled = {k: bool((b[k].max() > 1.0) | (b[k].min() < 0.0))
              for k in ("pitch_targets", "energy_targets")}
    names = list(params)
    leaves = [params[k] for k in names]
    grads = [torch.zeros_like(x) for x in leaves]
    sums = {k: 0.0 for k in n}
    for r0 in range(0, B, block_rows):
        blk = Block(range(r0, min(r0 + block_rows, B)), B, b["mel_specs"].device)
        part = {k: v[r0:blk.rows.stop] for k, v in b.items()}
        out = forward(params, part, seed, m, t, cast, blk, scaled["pitch_targets"],
                      scaled["energy_targets"])
        s = loss_terms(out, part, t)
        total = sum(weights[k] * s[k] / max(n[k], 1) for k in s)
        for g, x in zip(grads, torch.autograd.grad(total, leaves, allow_unused=True)):
            if x is not None:
                g.add_(x)
        for k in s:
            sums[k] += float(s[k].detach())
        del out, s, total
    means = {k: sums[k] / n[k] if n[k] else 0.0 for k in n}
    for k, c in CLAMPS.items():
        if means[k] > c:
            raise ValueError(f"loss term {k} = {means[k]} passes its clamp {c}: the "
                             "reference sums blocks only below the clamps")
    losses = dict(means, total=sum(weights[k] * means[k] for k in means))
    return losses, dict(zip(names, grads))


# -- the update --------------------------------------------------------------
ENCODER_TOPS = ("text_embedding", "stress_embedding", "encoder_layers", "encoder_norm")


def group_of(name: str) -> str:
    top, leaf, dotted = name.split(".")[0], name.split(".")[-1], f".{name}."
    if top == "stop_token_predictor":
        return "stop_head"
    if top in ("variance_adaptor", "duration_adaptor"):
        return ("variance_embed" if "pitch_embedding" in name or "energy_embedding" in name
                else "decoder_no_decay")
    if top in ENCODER_TOPS:
        return ("encoder_ffn" if ".ff." in dotted and leaf == "weight" and "norm" not in name
                else "encoder")
    no_decay = leaf == "bias" or "norm" in name
    if ".ff." in dotted:
        return "decoder_ffn_no_decay" if no_decay else "decoder_ffn"
    if "self_attn" in name or "cross_attn" in name:
        return "decoder_attn_no_decay" if no_decay else "decoder_attn"
    return "decoder_no_decay" if no_decay else "decoder_other"


def group_lr_and_decay(label: str, t: dict):
    mult = {"encoder": "encoder_lr_multiplier", "encoder_ffn": "encoder_lr_multiplier",
            "decoder_attn": "decoder_attn_lr_multiplier",
            "decoder_attn_no_decay": "decoder_attn_lr_multiplier",
            "decoder_ffn": "decoder_ffn_lr_multiplier",
            "decoder_ffn_no_decay": "decoder_ffn_lr_multiplier",
            "variance_embed": "variance_embedding_lr_multiplier",
            "stop_head": "stop_head_lr_multiplier"}.get(label)
    decay = {"encoder_ffn": "ffn_weight_decay", "decoder_other": "weight_decay",
             "decoder_attn": "weight_decay", "decoder_ffn": "decoder_ffn_weight_decay"}.get(label)
    return (1.0 if mult is None else t[mult]), (0.0 if decay is None else t[decay])


def learning_rate(label: str, step: int, t: dict, total_steps: int) -> float:
    """Linear warmup, then the one-cycle cosine (the config's ``use_onecycle_lr``)."""
    if not t["use_onecycle_lr"]:
        raise ValueError("the reference follows the one-cycle schedule only")
    base = t["learning_rate"] * group_lr_and_decay(label, t)[0]
    mult = t["max_lr_multiplier"]
    max_lr = base * mult
    warmup = min(t["warmup_steps"], max(total_steps // 2, 1)) if t["use_warmup"] else 0
    cycle = max(total_steps - warmup, 1)
    initial = max_lr / (max(1.0, float(mult)) if t["use_warmup"] else 25.0)
    rise = max(int(t["pct_start"] * cycle), 1)
    fall = max(cycle - rise, 1)
    start, target = base * t["warmup_start_lr_ratio"], min(base, max_lr)
    step = float(step)
    if warmup and step < warmup:
        return start + (target - start) * min(max(step / warmup, 0.0), 1.0)
    u = max(step - warmup, 0.0)
    if u < rise:
        return max_lr + (initial - max_lr) * (1.0 + math.cos(math.pi * min(u / rise, 1.0))) / 2
    lo = initial / 1.0e4
    return lo + (max_lr - lo) * (1.0 + math.cos(math.pi * min((u - rise) / fall, 1.0))) / 2


def preclip_ceiling(name: str, t: dict) -> float:
    top, leaf = name.split(".")[0], name.split(".")[-1]
    ffn = ".ff." in f".{name}." and ("linear1" in name or "linear2" in name)
    if top in ("mel_projection_in", "mel_projection_out"):
        return t["projection_spike_clip_norm"]
    if top == "stop_token_predictor":
        return t["stop_head_spike_clip_norm"]
    if (top in ("encoder_layers", "decoder_layers") and leaf == "weight" and "norm" not in name
            and ("self_attn" in name or "cross_attn" in name)):
        return t["attention_spike_clip_norm"]
    if ffn:
        return (t["encoder_ffn_spike_clip_norm"] if top == "encoder_layers"
                else t["ffn_spike_clip_norm"])
    return 0.0


def weight_norm_target(name: str) -> bool:
    return (name.split(".")[0] in ("encoder_layers", "decoder_layers")
            and ".ff." in f".{name}." and ("linear1" in name or "linear2" in name)
            and name.endswith(".weight"))


def stabilization(b, t: dict):
    """(loss scale, clip norm) from the batch's risk."""
    risk = max(float(b["mel_lengths"].max()) / t["stabilization_soft_frames"],
               float(b["phoneme_durations"].max()) / t["stabilization_max_duration"])
    if risk > 1.0:
        return max(1.0 / risk, 0.25), max(0.5 / math.sqrt(risk), 0.05)
    return 1.0, t["max_grad_norm"]


def global_norm(tensors) -> float:
    return float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(x) for x in tensors])))


def train(params0: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]],
          generator_seed: int, m: dict, t: dict, run: dict, cast: Cast = identity,
          block_rows: int = 8, half_batch: bool = False) -> dict:
    """``len(batches)`` training steps from ``params0``, drawing each step's
    seed from a CPU generator seeded ``generator_seed``.  Returns each step's
    losses, the first step's gradient as the optimizer takes it (after the
    pre-clips and the clip), and the parameters after the last step.
    ``half_batch`` takes the mean over the first half of each batch's rows
    alone (a planted fault)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(params0, batches, generator_seed, m, t, run, cast, block_rows,
                      half_batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _train(params0, batches, generator_seed, m, t, run, cast, block_rows, half_batch):
    names = list(params0)
    p = {k: v.detach().float().clone().requires_grad_(True) for k, v in params0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    gen = torch.Generator().manual_seed(generator_seed)
    b1, b2, eps = t["adam_b1"], t["adam_b2"], t["adam_eps"]
    total_steps = run["total_steps"]
    out = {"losses": [], "first_grad": None}
    for count, batch in enumerate(batches):
        seed = R.step_seed(gen)
        if half_batch:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        scale, clip = stabilization(batch, t)
        losses, grads = losses_and_grads(p, batch, seed, m, t, cast, block_rows)
        out["losses"].append(losses)
        g = {k: grads[k] * scale for k in names}
        raw = global_norm(g.values())
        for k in names:
            c = preclip_ceiling(k, t)
            if c > 0:
                nk = float(torch.linalg.vector_norm(g[k]))
                if nk > c:
                    g[k] = g[k] * (c / (nk + 1e-12))
        clipped = global_norm(g.values())
        if not (math.isfinite(raw) and math.isfinite(losses["total"])):
            raise FloatingPointError(f"the reference's step {count + 1} is not finite")
        factor = min(1.0, clip / (clipped + 1e-6))
        g = {k: v * factor for k, v in g.items()}
        if count == 0:
            out["first_grad"] = {k: v.clone() for k, v in g.items()}
        bc1, bc2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
        with torch.no_grad():
            for k in names:
                label = group_of(k)
                mu[k].mul_(b1).add_(g[k], alpha=1.0 - b1)
                nu[k].mul_(b2).addcmul_(g[k], g[k], value=1.0 - b2)
                upd = (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + eps)
                decay = group_lr_and_decay(label, t)[1]
                if decay:
                    upd = upd + decay * p[k]
                p[k].sub_(learning_rate(label, count, t, total_steps) * upd)
            limit = t["dec_ffn_max_weight_norm"]
            for k in names:
                if limit > 0 and weight_norm_target(k):
                    nk = float(torch.linalg.vector_norm(p[k]))
                    if nk > limit:
                        p[k].mul_(limit / (nk + 1e-12))
    out["params"] = {k: v.detach() for k, v in p.items()}
    return out
