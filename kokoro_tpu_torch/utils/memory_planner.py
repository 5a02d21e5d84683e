"""Device-memory planning for the training step on one GPU.

Port of ``kokoro_tpu/utils/memory_planner.py`` (``count_params``,
``MemoryEstimate``, ``estimate_train_step_hbm``, ``live_hbm_bytes``,
``max_batch_size``, ``plan_buckets``, ``recommend_settings``), with the
terms modelling PyTorch's caching allocator on an H100 instead of XLA's
static allocation on a TPU.  The functions take the port's two configs,
``(model_config, config)``.

The estimate is of ``torch.cuda.max_memory_allocated`` over one training
step.  Its terms:

* ``state_bytes`` — f32 parameters, their gradients, AdamW's two moments and
  the EMA (five f32 copies), plus the compute-dtype casts of the weights
  that autograd saves when the step computes in bf16;
* ``token_activation_bytes`` — the tensors autograd saves per mel frame and
  per phoneme (projections, GLU, norms, residuals, dropout masks, the heads
  and the losses): an inventory of elements per token, each costing
  ``4 * _F32_SAVES + ab * _ACT_SAVES`` bytes (part of what autograd keeps is
  f32 whatever the compute dtype of width ``ab``).  Under remat
  (``torch.utils.checkpoint`` per decoder layer and in
  ``checkpoint_segments`` encoder segments) the layer inputs stay, and one
  decoder layer's (one encoder segment's) inventory is alive at the peak at
  ``ab * _REMAT_LIVE`` bytes an element;
* ``attention_weight_bytes`` — the (T, T) terms of the plain attention route
  only: its f32 softmax, the compute-dtype weights and the dropout mask, per
  attention site.  The encoder's self-attention over phonemes always takes
  it; the decoder's self- and cross-attention (over the expanded memory, T
  keys) take it when ``use_flash_attention`` is off.  The attention kernels
  save the output and the row log-sum-exp, in the per-frame term, and under
  bf16 each packed site (K2's cross-attention, and K1's self-attention
  wherever K4 does not take it) also O's rounding residual for the
  backward's delta: one compute-dtype value per frame and model width, a
  closed-form term of each decoder layer's inventory (not fitted);
* ``transient_bytes`` — the f32 gradient buffers of one plain attention
  site's backward (the largest one);
* ``batch_bytes`` — the step's batch on the device (every microbatch);
* ``overhead_bytes`` — a fixed allowance.

The three per-token coefficients are fitted (``fit_coefficients``, least
squares of the relative error, the overhead held at 0.25 GiB) to the peaks of
``shape_sweep_h100.json``, measured on an NVIDIA H100 80GB HBM3 at 700.00 W
by ``python -m kokoro_tpu_torch.utils.memory_planner --sweep``:
``bench.py``'s bucket ladder under the throughput preset, the long step of
``scripts/quality_run.py --long``, and plain-route, remat and f32 rows.  The
fit is within 3.0 % of every row; ``tests/test_torch_planner.py`` holds it
within 15 %.  The caching allocator reserves more than it allocates
(fragmentation): 3.8-16.9 % over the sweep, the remat rows most.  The
``safety_margin`` of 0.9 covers that gap except under remat.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB HBM3
# (shape_sweep_h100.json): the budget when neither a card nor a size is given
DEFAULT_HBM_BYTES = 85_017_493_504

# saved elements per token per layer before the fitted scale: the
# reference's inventory (q/k/v/out projections, the GLU hidden and product,
# pre-norm and residual saves), and per mel frame outside the layers
_DEC_TOKEN_ELEMS = lambda D, ff: 4 * D + 4 * D + 3 * ff + 3 * D  # noqa: E731  self+cross+GLU
_ENC_TOKEN_ELEMS = lambda D, ff: 4 * D + 3 * ff + 2 * D  # noqa: E731
_HEAD_TOKEN_ELEMS = lambda D, n_mels: 4 * D + 8 * n_mels  # noqa: E731
# fitted to shape_sweep_h100.json (fit_coefficients): f32 values and
# compute-dtype values autograd keeps per element of the inventory above, and
# compute-dtype values per element of the one checkpointed layer alive at the
# peak under remat
_F32_SAVES = 1.1978
_ACT_SAVES = 1.1625
_REMAT_LIVE = 1.9135
# f32 parameters, gradients, AdamW mu and nu, EMA
_STATE_COPIES = 5
# f32 gradient buffers of one plain attention site's backward
_TRANSIENT_SCORE_BUFFERS = 2
_FIXED_OVERHEAD = int(0.25 * 1024**3)

SWEEP_FILE = Path(__file__).with_name("shape_sweep_h100.json")
# bench.py's bucket ladder (mel bucket, its phoneme bucket, batch rows:
# B32 up to T512, B16 from T784) and the long step of scripts/quality_run.py --long
LADDER = ((32, 256, 64), (32, 288, 64), (32, 320, 64), (32, 432, 96), (32, 464, 96),
          (32, 512, 96), (16, 784, 160), (16, 848, 160), (16, 896, 160))
LONG = (12, 1408, 256)


def count_params(model_config, vocab_size: int) -> int:
    """Exact trainable-parameter count of the configured model, built on the
    ``meta`` device: nothing is allocated and nothing runs."""
    from kokoro_tpu_torch.models.kokoro import KokoroModel

    with torch.device("meta"):
        model = KokoroModel(dataclasses.replace(model_config, vocab_size=vocab_size))
    return sum(p.numel() for p in model.parameters())


@dataclasses.dataclass
class MemoryEstimate:
    """Named device-memory terms (bytes) of one training step."""

    batch_size: int
    mel_frames: int
    phoneme_len: int
    state_bytes: int
    token_activation_bytes: int
    attention_weight_bytes: int
    transient_bytes: int
    batch_bytes: int
    overhead_bytes: int
    flash_active: bool   # the decoder's attention runs the kernels (no (T, T) term)
    remat_active: bool

    @property
    def total_bytes(self) -> int:
        return (self.state_bytes + self.token_activation_bytes + self.attention_weight_bytes
                + self.transient_bytes + self.batch_bytes + self.overhead_bytes)

    def fits(self, hbm_bytes: int = DEFAULT_HBM_BYTES, margin: float = 1.0) -> bool:
        return self.total_bytes <= hbm_bytes * margin

    def summary(self) -> str:
        g = 1024**3
        return (f"B={self.batch_size} T={self.mel_frames} L={self.phoneme_len}: "
                f"{self.total_bytes / g:.2f} GiB (state {self.state_bytes / g:.2f}, "
                f"token acts {self.token_activation_bytes / g:.2f}, "
                f"attn weights {self.attention_weight_bytes / g:.2f}, "
                f"transients {self.transient_bytes / g:.2f}, "
                f"batch {self.batch_bytes / g:.2f}"
                f"{', flash' if self.flash_active else ''}"
                f"{', remat' if self.remat_active else ''})")


def _act_bytes(config) -> int:
    return 2 if config.compute_dtype == "bfloat16" else 4


def _approx_params(model_config) -> int:
    """Closed-form parameter estimate: the attention and GLU matrices,
    embeddings and heads."""
    D = model_config.hidden_dim
    per_enc = 4 * D * D + 3 * D * model_config.encoder_ff_dim
    per_dec = 8 * D * D + 3 * D * model_config.decoder_ff_dim
    return int(model_config.n_encoder_layers * per_enc + model_config.n_decoder_layers * per_dec
               + 256 * D + 2 * D * model_config.n_mels + 4 * D)


def _token_terms(model_config, B: int, T: int, L: int):
    """Inventory elements saved per decoder layer, per encoder layer and
    outside the layers, at this shape."""
    m = model_config
    return (B * T * _DEC_TOKEN_ELEMS(m.hidden_dim, m.decoder_ff_dim),
            B * L * _ENC_TOKEN_ELEMS(m.hidden_dim, m.encoder_ff_dim),
            B * T * _HEAD_TOKEN_ELEMS(m.hidden_dim, m.n_mels))


def _site_bytes(config, rate: float) -> int:
    """Bytes the plain route saves per (query, key) element of one site: the
    f32 softmax, then the compute-dtype weights (a no-op cast in f32) and,
    with dropout, its mask and the dropped weights."""
    ab = _act_bytes(config)
    if rate > 0.0:
        return 4 + 1 + ab
    return 4 + (ab if ab != 4 else 0)


def _residual_sites(model_config, config, T: int) -> int:
    """Packed-kernel sites of one decoder layer that save O's bf16 rounding
    residual under grad: the cross-attention (K2) and, unless K4 takes the
    causal self-attention (T >= 1024 in multiples of 128, no attention
    dropout), the self-attention (K1); none in f32 or on the plain route."""
    from kokoro_tpu_torch.ops.flash_attention import flash_supported

    m = model_config
    if not m.use_flash_attention or config.compute_dtype != "bfloat16":
        return 0
    rate = m.decoder_dropout if m.attention_weight_dropout else 0.0
    return 1 if rate == 0.0 and flash_supported(T, T, m.hidden_dim // m.n_heads) else 2


def estimate_train_step_hbm(model_config, config, batch_size: int, mel_frames: int,
                            phoneme_len: int, n_params: Optional[int] = None,
                            coefficients: Optional[Tuple[float, float, float]] = None
                            ) -> MemoryEstimate:
    """The step's device-memory peak at one shape, term by term (module
    docstring).  ``coefficients`` overrides the fitted ``(_F32_SAVES,
    _ACT_SAVES, _REMAT_LIVE)``."""
    m, c = model_config, config
    D, H = m.hidden_dim, m.n_heads
    Ne, Nd = m.n_encoder_layers, m.n_decoder_layers
    B, T, L = batch_size, mel_frames, phoneme_len
    if n_params is None:
        n_params = _approx_params(m)
    bf16 = c.compute_dtype == "bfloat16"
    state = n_params * 4 * _STATE_COPIES + (n_params * 2 if bf16 else 0)

    flash_active = bool(m.use_flash_attention)
    remat_active = bool(c.gradient_checkpointing)
    f32_saves, act_saves, remat_live = coefficients or (_F32_SAVES, _ACT_SAVES, _REMAT_LIVE)
    per_elem = 4 * f32_saves + _act_bytes(c) * act_saves
    dec, enc, head = _token_terms(m, B, T, L)
    residual = _residual_sites(m, c, T) * B * T * D * _act_bytes(c)
    enc_rate = m.encoder_dropout if m.attention_weight_dropout else 0.0
    dec_rate = m.decoder_dropout if m.attention_weight_dropout else 0.0
    enc_site = B * H * L * L * _site_bytes(c, enc_rate)
    dec_site = 0 if flash_active else 2 * B * H * T * T * _site_bytes(c, dec_rate)
    if remat_active:
        enc_live = math.ceil(Ne / max(1, min(int(c.checkpoint_segments), Ne)))
        ab = _act_bytes(c)
        boundaries = (Nd * B * T + Ne * B * L) * D * ab
        token_acts = (boundaries + ab * remat_live * (dec + enc_live * enc) + per_elem * head
                      + residual)
        attn = dec_site + enc_live * enc_site
    else:
        token_acts = per_elem * (Nd * dec + Ne * enc + head) + Nd * residual
        attn = Nd * dec_site + Ne * enc_site
    largest = (B * H * T * T) if not flash_active else (B * H * L * L)
    transient = _TRANSIENT_SCORE_BUFFERS * largest * 4

    per_micro = (B * T * (m.n_mels + 3) + B * L * 3) * 4
    batch = per_micro * max(1, int(c.gradient_accumulation_steps))
    return MemoryEstimate(
        batch_size=B, mel_frames=T, phoneme_len=L, state_bytes=int(state),
        token_activation_bytes=int(token_acts), attention_weight_bytes=int(attn),
        transient_bytes=int(transient), batch_bytes=int(batch),
        overhead_bytes=_FIXED_OVERHEAD, flash_active=flash_active, remat_active=remat_active)


def live_hbm_bytes() -> Optional[int]:
    """The device memory this process can fill on the current card (free
    memory plus what its caching allocator already holds), None without
    CUDA."""
    if not torch.cuda.is_available():
        return None
    free, _ = torch.cuda.mem_get_info()
    return int(free + torch.cuda.memory_reserved())


def max_batch_size(model_config, config, mel_frames: int, phoneme_len: int,
                   hbm_bytes: int = DEFAULT_HBM_BYTES, n_params: Optional[int] = None,
                   safety_margin: float = 0.9, multiple: int = 8) -> int:
    """Largest batch size (a multiple of ``multiple``) whose estimated step
    fits ``safety_margin * hbm_bytes``; 0 when not even ``multiple`` fits."""
    if n_params is None:
        n_params = _approx_params(model_config)
    best, b = 0, multiple
    while b <= 4096:
        est = estimate_train_step_hbm(model_config, config, b, mel_frames, phoneme_len,
                                      n_params=n_params)
        if not est.fits(hbm_bytes, safety_margin):
            break
        best = b
        b += multiple
    return best


def _bucket_lists(config) -> Tuple[Sequence[int], Sequence[int]]:
    mels = config.mel_bucket_sizes or (config.max_seq_length,)
    # phoneme buckets default non-empty; the fallback mirrors RUSLAN's ~7
    # frames/phoneme ratio
    phons = config.phoneme_bucket_sizes or (max(mels[-1] // 7, 16),)
    return mels, phons


def plan_buckets(model_config, config, hbm_bytes: int = DEFAULT_HBM_BYTES,
                 n_params: Optional[int] = None, safety_margin: float = 0.9) -> List[Dict]:
    """Per-(mel, phoneme) bucket plan: the largest batch that fits and the
    estimate at the configured batch size, flagged when it would not fit."""
    if n_params is None:
        n_params = _approx_params(model_config)
    mels, phons = _bucket_lists(config)
    rows = []
    for i, T in enumerate(mels):
        L = phons[min(i, len(phons) - 1)]
        est = estimate_train_step_hbm(model_config, config, config.batch_size, T, L,
                                      n_params=n_params)
        rows.append({
            "mel_frames": T, "phoneme_len": L, "configured_batch": config.batch_size,
            "configured_fits": est.fits(hbm_bytes, safety_margin),
            "estimate_gib": round(est.total_bytes / 1024**3, 2),
            "max_batch": max_batch_size(model_config, config, T, L, hbm_bytes, n_params,
                                        safety_margin),
            "flash_active": est.flash_active, "remat_active": est.remat_active,
        })
    return rows


def recommend_settings(model_config, config, hbm_bytes: int = DEFAULT_HBM_BYTES,
                       n_params: Optional[int] = None) -> Dict:
    """The advisor: the card's memory and the configured sequence regime ->
    batch size, and whether remat or the attention kernels are needed, at
    the largest bucket."""
    if n_params is None:
        n_params = _approx_params(model_config)
    mels, phons = _bucket_lists(config)
    T, L = mels[-1], phons[-1]
    plain = max_batch_size(model_config, config, T, L, hbm_bytes, n_params)
    notes = []
    rec = {"batch_size": plain, "gradient_checkpointing": False}
    if plain > config.batch_size:
        notes.append(f"the card fits up to B={plain} at T={T}; the steps are bound by "
                     "their kernel launches, so a larger batch mostly raises the frames "
                     "per launch (PERF.md)")
    if plain < 8:
        remat_cfg = dataclasses.replace(config, gradient_checkpointing=True)
        with_remat = max_batch_size(model_config, remat_cfg, T, L, hbm_bytes, n_params)
        rec = {"batch_size": with_remat, "gradient_checkpointing": True}
        notes.append(f"plain step fits B<8 at T={T}; remat raises the cap to {with_remat}")
    if not model_config.use_flash_attention:
        notes.append("enable use_flash_attention: the decoder's attention then runs the "
                     "kernels, which keep no (T, T) attention weights")
    rec.update({"largest_bucket": {"mel_frames": T, "phoneme_len": L},
                "hbm_gib": round(hbm_bytes / 1024**3, 2), "n_params": n_params,
                "notes": notes})
    return rec


# -- the measurement behind the fitted terms ------------------------------------
def _card() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in out.split(",", 1))
    return {"card": name, "power_limit": power}


def measure_step_peaks(model_config, config, shapes, device: str | torch.device = "cuda"
                       ) -> List[Dict]:
    """``torch.cuda.max_memory_allocated`` and ``max_memory_reserved`` of one
    training step at each ``(B, T, L)`` of ``shapes``, on seeded random
    weights and ``cli/profile_paths.py::training_batch`` (one batch, no
    microbatch axis), after a first step at that shape."""
    from kokoro_tpu_torch.cli.profile_paths import training_batch
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the step peaks are the caching allocator's: measure on a card")
    model = KokoroModel(model_config).init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model.to(dev), config, total_steps=20000)
    step = make_train_step(config, build_preclip_norms(state.names, config),
                           spec_augment=config.use_spec_augment)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for B, T, L in shapes:
        batch = training_batch(model_config, B, T, L, dev)
        step(state, batch, gen)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        rows.append({"B": B, "T": T, "L": L,
                     "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                     "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
                     "stepped": metrics["stepped"]})
        del batch
    del state, step, model
    torch.cuda.empty_cache()
    return rows


def sweep_configs():
    """The sweep's configurations: ``(label, model_config, config, shapes)``."""
    from kokoro_tpu_torch.cli.profile_paths import LONG_REGIME
    from kokoro_tpu_torch.config import get_default_config, get_high_performance_config

    return [
        ("preset", *get_high_performance_config(), LADDER),
        ("long", *get_default_config(**LONG_REGIME), (LONG,)),
        ("preset_plain_route", *get_high_performance_config(use_flash_attention=False),
         ((32, 256, 64), (32, 512, 96), (16, 896, 160))),
        ("preset_remat", *get_high_performance_config(gradient_checkpointing=True),
         ((32, 512, 96), (16, 896, 160))),
        ("preset_f32", *get_high_performance_config(compute_dtype="float32"),
         ((32, 512, 96),)),
    ]


def sweep(device: str | torch.device = "cuda", labels: Optional[Sequence[str]] = None
          ) -> Dict:
    """Every configuration of :func:`sweep_configs` (or those named in
    ``labels``) on the card: one row per shape, with the card's name, power
    limit and total memory."""
    card = _card()
    total = torch.cuda.get_device_properties(0).total_memory
    rows = []
    for label, mcfg, cfg, shapes in sweep_configs():
        if labels is not None and label not in labels:
            continue
        rows += [{"config": label, **row, **card}
                 for row in measure_step_peaks(mcfg, cfg, shapes, device)]
    return {"total_memory_bytes": total, **card, "rows": rows}


def fit_coefficients(rows: Sequence[Dict]) -> Tuple[float, float, float]:
    """``(_F32_SAVES, _ACT_SAVES, _REMAT_LIVE)`` that best fit the rows'
    allocated peaks: least squares of the relative error.  The estimate is
    linear in the three, so each row's columns are its estimates at the unit
    vectors less its estimate at zero."""
    import numpy as np

    configs = {label: (m, c) for label, m, c, _ in sweep_configs()}
    A, y = [], []
    for row in rows:
        m, c = configs[row["config"]]
        n_params = count_params(m, m.vocab_size)

        def total(coef):
            return estimate_train_step_hbm(m, c, row["B"], row["T"], row["L"], n_params,
                                           coef).total_bytes

        base, peak = total((0.0, 0.0, 0.0)), row["peak_allocated_bytes"]
        A.append([(total(unit) - base) / peak
                  for unit in ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))])
        y.append(1.0 - base / peak)
    sol = np.linalg.lstsq(np.asarray(A), np.asarray(y), rcond=None)[0]
    return tuple(float(x) for x in sol)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Measure the training step's device-memory peaks (needs a card), or "
                    "fit the per-token coefficients to a sweep file")
    parser.add_argument("--sweep", metavar="OUT", help="measure and write the sweep JSON")
    parser.add_argument("--fit", metavar="SWEEP", help="print the fitted coefficients")
    args = parser.parse_args(argv)
    if args.sweep:
        doc = sweep()
        Path(args.sweep).write_text(json.dumps(doc, indent=1) + "\n")
        for row in doc["rows"]:
            print(json.dumps(row), flush=True)
    if args.fit:
        print(json.dumps(dict(zip(("f32_saves", "act_saves", "remat_live"), fit_coefficients(
            json.loads(Path(args.fit).read_text())["rows"])))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
