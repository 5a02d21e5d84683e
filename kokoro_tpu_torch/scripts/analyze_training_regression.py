"""Offline training-regression forensics of a port run directory.

Port of ``scripts/analyze_training_regression.py``, every function in the
reference's order, reading what the port's trainer writes:

* per-checkpoint parameter L2-norm / delta / non-finite tables over the
  ``checkpoint_epoch_*`` series (``training/checkpoint.py``: ``state.pt``
  with the parameters and their EMA, ``metadata.json`` with the counters),
  with top-mover attribution and an mtime-keyed stats cache, so repeat runs
  skip unchanged checkpoints;
* EMA-vs-live weight divergence;
* metric-log analysis (loss trends, val-mel series, grad-norm spikes and
  clip saturation, LR phases) from ``logs/metrics.jsonl`` (what the trainer
  writes when tensorboard is not installed) or, when ``tensorboard``
  imports, TensorBoard event files;
* stop-loss percentiles and burst detection with late-burst warnings;
* mel<->stop 200-step window correlation with co-movement labels;
* val-mel epoch-series regression detection (linear slope and R^2);
* a PASS/WARN/FAIL checklist with recommendations.

Parameters are named by their flax paths (``convert.flax_names`` of the
checkpoint's architecture), so the tables, the groups of
:func:`classify_param` and the top movers read as the reference's do for
the same tensors.  Host work only: checkpoints load with
``torch.load(..., map_location="cpu")``.  The check details and the
recommendations are the reference script's words; a line reference of the
form ``reference :a-b`` in them names the upstream PyTorch analyzer that
the reference follows.

    python -m kokoro_tpu_torch.scripts.analyze_training_regression --model-dir RUN_DIR [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np


# ---------------------------------------------------------------------------
# Checkpoint weight analysis
# ---------------------------------------------------------------------------

def _flax_paths(model_config: dict) -> dict:
    """``{torch parameter name: flax path}`` of the architecture a
    checkpoint's ``metadata.json`` records; the model is built on the meta
    device, so no memory is allocated."""
    import dataclasses

    import torch

    from kokoro_tpu_torch.config import KokoroConfig
    from kokoro_tpu_torch.convert import flax_names
    from kokoro_tpu_torch.models.kokoro import KokoroModel

    fields = {f.name for f in dataclasses.fields(KokoroConfig)}
    with torch.device("meta"):
        model = KokoroModel(KokoroConfig(**{k: v for k, v in model_config.items()
                                            if k in fields}))
    return flax_names(model)


def load_checkpoint_params(path: Path) -> dict:
    """``{"params": {"params/<flax path>": float32 array}, "ema_params":
    {...}}`` of a port checkpoint, named as the reference's flattened flax
    variables, on the host whatever device saved it."""
    import torch

    path = Path(path)
    doc = json.loads((path / "metadata.json").read_text())
    names = _flax_paths(doc["model_config"])
    saved = torch.load(path / "state.pt", map_location="cpu", weights_only=True)

    def host(tree):
        return {f"params/{names[k]}": v.float().numpy() for k, v in tree.items() if k in names}

    return {"params": host(saved["model"]), "ema_params": host(saved.get("ema") or {})}


def flatten_norms(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_norms(v, f"{prefix}/{k}" if prefix else k))
    else:
        arr = np.asarray(tree)
        out[prefix] = {
            "norm": float(np.linalg.norm(arr)),
            "nonfinite": int((~np.isfinite(arr)).sum()),
            "size": arr.size,
        }
    return out


def flatten_arrays(tree, prefix="") -> dict:
    """name -> float32 ndarray (for TRUE parameter-space deltas ||w_i - w_{i-1}||,
    reference compute_weight_stats :213-287 — norm-of-difference, not
    difference-of-norms)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_arrays(v, f"{prefix}/{k}" if prefix else k))
    else:
        out[prefix] = np.asarray(tree, dtype=np.float32)
    return out


#: param-name -> architectural group, for top-mover attribution
#: (reference classify_param :112-151).
_GROUP_RULES = (
    ("stop_token_predictor", "stop_head"),
    ("pitch_embedding", "variance_embed"),
    ("energy_embedding", "variance_embed"),
    ("variance", "variance_pred"),
    ("duration", "variance_pred"),
    ("text_embedding", "embedding"),
    ("stress_embedding", "embedding"),
    ("encoder_layer", "encoder"),
    ("decoder_layer_", None),  # refined below: attn vs ffn
    ("mel_projection", "decoder_io"),
    ("decoder_norm", "decoder_io"),
)


def classify_param(name: str) -> str:
    low = name.lower()
    if "decoder_layer" in low:
        if "attn" in low or "attention" in low:
            return "decoder_attn"
        if "linear" in low or "ff" in low or "glu" in low:
            return "decoder_ffn"
        return "decoder_other"
    for needle, group in _GROUP_RULES:
        if group and needle in low:
            return group
    return "other"


_CACHE_VERSION = 2


def _load_stats_cache(model_dir: Path) -> dict:
    """mtime-keyed per-checkpoint norm cache (reference :34-60): repeat
    analyzer runs skip re-reading unchanged checkpoints."""
    path = model_dir / ".analysis_stats_cache.json"
    try:
        data = json.loads(path.read_text())
        if data.get("version") == _CACHE_VERSION:
            return data.get("entries", {})
    except Exception:
        pass
    return {}


def _save_stats_cache(model_dir: Path, entries: dict) -> None:
    try:
        (model_dir / ".analysis_stats_cache.json").write_text(
            json.dumps({"version": _CACHE_VERSION, "entries": entries})
        )
    except OSError:
        pass


def _checkpoint_mtime(ck: Path) -> float:
    return max((p.stat().st_mtime for p in ck.rglob("*") if p.is_file()),
               default=ck.stat().st_mtime)


def _read_counters(ck: Path) -> dict:
    try:
        doc = json.loads((ck / "metadata.json").read_text())
        return doc.get("counters", {}) or {}
    except Exception:
        return {}


def _compute_entry(ck: Path, prev_arrays, counters, prev_counters) -> tuple:
    """(entry dict, params_arrays) — TRUE parameter-space forensics for one
    checkpoint: per-param ||w||, ||Δw|| vs the previous checkpoint, per-group
    delta attribution, delta velocity per optimizer step, and live-vs-EMA
    divergence ||w - ema|| (reference compute_weight_stats :213-287)."""
    state = load_checkpoint_params(ck)
    arrays = flatten_arrays(state["params"])
    ema_arrays = flatten_arrays(state.get("ema_params") or {})
    total_norm_sq = 0.0
    delta_norm_sq = 0.0
    ema_div_sq = 0.0
    nonfinite = 0
    deltas = {}
    group_deltas = defaultdict(float)
    for name, arr in arrays.items():
        total_norm_sq += float(arr.astype(np.float64).ravel() @
                               arr.astype(np.float64).ravel())
        nonfinite += int((~np.isfinite(arr)).sum())
        if prev_arrays is not None and name in prev_arrays:
            d = float(np.linalg.norm(
                arr.astype(np.float64) - prev_arrays[name].astype(np.float64)
            ))
            deltas[name] = d
            delta_norm_sq += d * d
            group_deltas[classify_param(name)] += d * d
        if name in ema_arrays:
            ema_div_sq += float(np.linalg.norm(
                arr.astype(np.float64) - ema_arrays[name].astype(np.float64)
            )) ** 2
    movers = sorted(deltas.items(), key=lambda kv: -kv[1])[:8]
    steps = counters.get("optimizer_step")
    prev_steps = (prev_counters or {}).get("optimizer_step")
    steps_in_window = (
        steps - prev_steps
        if isinstance(steps, int) and isinstance(prev_steps, int)
        and steps > prev_steps else None
    )
    total_delta = float(np.sqrt(delta_norm_sq)) if deltas else None
    entry = {
        "name": ck.name,
        "epoch": counters.get("epoch"),
        "optimizer_step": steps,
        "total_norm": round(float(np.sqrt(total_norm_sq)), 4),
        "nonfinite_params": nonfinite,
        "total_delta_norm": round(total_delta, 4) if total_delta else None,
        "delta_velocity": (
            round(total_delta / steps_in_window, 6)
            if total_delta is not None and steps_in_window else None
        ),
        "ema_divergence_norm": (
            round(float(np.sqrt(ema_div_sq)), 4) if ema_arrays else None
        ),
        "group_deltas": {
            g: round(float(np.sqrt(v)), 4)
            for g, v in sorted(group_deltas.items(), key=lambda kv: -kv[1])
        },
        "top_movers": [
            {
                "param": k,
                "group": classify_param(k),
                "delta": round(d, 4),
            }
            for k, d in movers
        ],
    }
    return entry, arrays


def analyze_checkpoints(model_dir: Path) -> dict:
    """Per-checkpoint weight-delta tables across ALL checkpoints with
    top-mover attribution, rank-stability Jaccard between consecutive top-N
    mover sets, and persistent-mover counts (reference compute_weight_stats +
    compute_rank_stability + print_persistent_movers :213-400).  An
    mtime+prev-keyed cache skips unchanged (checkpoint, predecessor) pairs —
    repeat runs over a finished training land zero tensor loads."""
    ckpts = sorted(
        model_dir.glob("checkpoint_epoch_*"),
        key=lambda p: int(p.name.rsplit("_", 1)[1]),
    )
    report = {
        "checkpoints": [], "persistent_movers": [], "ema_divergence": None,
    }
    cache = _load_stats_cache(model_dir)
    cache_out = {}
    prev_loaded = None          # (name, arrays) rolled forward on misses
    prev_counters = None
    prev_top: set | None = None
    persistent = defaultdict(int)
    for i, ck in enumerate(ckpts):
        mtime = _checkpoint_mtime(ck)
        prev_name = ckpts[i - 1].name if i else None
        counters = _read_counters(ck)
        cached = cache.get(ck.name)
        if (cached and cached.get("mtime") == mtime
                and cached.get("prev") == prev_name):
            entry = dict(cached["entry"])
            cache_out[ck.name] = cached
            prev_loaded = None  # arrays unavailable; a later miss reloads
        else:
            if prev_name and (prev_loaded is None
                              or prev_loaded[0] != prev_name):
                try:
                    prev_state = load_checkpoint_params(ckpts[i - 1])
                    prev_loaded = (
                        prev_name, flatten_arrays(prev_state["params"])
                    )
                except Exception:
                    prev_loaded = None
            try:
                entry, arrays = _compute_entry(
                    ck,
                    prev_loaded[1] if prev_loaded else None,
                    counters, prev_counters,
                )
            except Exception as err:
                report["checkpoints"].append(
                    {"name": ck.name, "error": str(err)}
                )
                prev_loaded = None
                prev_counters = counters
                continue
            prev_loaded = (ck.name, arrays)
            cache_out[ck.name] = {
                "mtime": mtime, "prev": prev_name, "entry": dict(entry),
            }
        # rank stability: Jaccard of consecutive top-mover name sets
        top = {m["param"] for m in entry.get("top_movers", [])}
        for name in top:
            persistent[name] += 1
        if prev_top is not None and (prev_top or top):
            entry["rank_stability_jaccard"] = round(
                len(prev_top & top) / max(len(prev_top | top), 1), 3
            )
        prev_top = top
        prev_counters = counters
        report["checkpoints"].append(entry)
    if cache_out:
        _save_stats_cache(model_dir, cache_out)

    n_delta_epochs = sum(
        1 for c in report["checkpoints"] if c.get("total_delta_norm")
    )
    report["persistent_movers"] = [
        {
            "param": k, "group": classify_param(k), "epochs_in_top": v,
            "of_epochs": n_delta_epochs,
        }
        for k, v in sorted(persistent.items(), key=lambda kv: -kv[1])[:10]
        if v >= 2
    ]

    # EMA divergence summary = the last checkpoint's live-vs-EMA norm
    last_ok = [c for c in report["checkpoints"] if "error" not in c]
    if last_ok:
        report["ema_divergence"] = {
            "final_norm": last_ok[-1].get("ema_divergence_norm"),
            "series": [c.get("ema_divergence_norm") for c in last_ok],
        }
    return report


# ---------------------------------------------------------------------------
# Metric log analysis
# ---------------------------------------------------------------------------

def load_scalars(logdir: Path) -> dict:
    """tag -> [(step, value)] from ``metrics.jsonl`` or, when there is none
    and ``tensorboard`` imports, the TB event files."""
    scalars: dict = defaultdict(list)
    jsonl = logdir / "metrics.jsonl"
    if jsonl.exists():
        for line in jsonl.read_text().splitlines():
            try:
                rec = json.loads(line)
                scalars[rec["tag"]].append((rec["step"], rec["value"]))
            except (json.JSONDecodeError, KeyError):
                continue  # a histogram or image record, or a torn line
        return dict(scalars)
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )
    except ImportError:
        return {}
    try:
        acc = EventAccumulator(str(logdir), size_guidance={"scalars": 0})
        acc.Reload()
        for tag in acc.Tags().get("scalars", []):
            scalars[tag] = [(e.step, e.value) for e in acc.Scalars(tag)]
    except Exception as err:
        print(f"warning: could not read TB events: {err}", file=sys.stderr)
    return dict(scalars)


def analyze_metrics(scalars: dict) -> dict:
    report = {}
    val_mel = sorted(scalars.get("loss/val_mel", []))
    if val_mel:
        values = [v for _, v in val_mel]
        best_i = int(np.argmin(values))
        tail_regression = values[-1] - values[best_i]
        report["val_mel"] = {
            "best": round(values[best_i], 4),
            "best_index": best_i,
            "last": round(values[-1], 4),
            "tail_regression": round(tail_regression, 4),
        }
    grads = sorted(scalars.get("stats/grad_norm", []))
    if grads:
        g = np.array([v for _, v in grads])
        median = float(np.median(g))
        spikes = int((g > 5 * max(median, 1e-9)).sum())
        report["grad_norm"] = {
            "median": round(median, 4),
            "p99": round(float(np.percentile(g, 99)), 4),
            "spike_count": spikes,
            "spike_rate": round(spikes / len(g), 4),
        }
        clipped = sorted(scalars.get("stats/grad_norm_clipped", []))
        if clipped and len(clipped) == len(grads):
            c = np.array([v for _, v in clipped])
            report["clip_saturation"] = round(float((c < g - 1e-6).mean()), 4)
    lr = sorted(scalars.get("stats/lr_decoder", []))
    if lr:
        values = np.array([v for v_, v in lr])
        peak_i = int(np.argmax(values))
        report["lr_phases"] = {
            "peak_lr": float(values.max()),
            "peak_at_fraction": round(peak_i / max(len(values) - 1, 1), 3),
            "final_lr": float(values[-1]),
        }
    stop = analyze_stop_token(scalars)
    if stop:
        report["stop_token"] = stop
    corr = analyze_mel_stop_correlation(scalars)
    if corr:
        report["mel_stop_correlation"] = corr
    vs = analyze_val_mel_series(scalars)
    if vs:
        report["val_mel_series"] = vs
    return report


def analyze_stop_token(scalars: dict) -> dict:
    """Stop-loss percentiles + burst detection with late-burst warnings
    (reference analyze_training_regression.py:899-970)."""
    series = sorted(scalars.get("loss/stop", []))
    report: dict = {}
    if series:
        steps = np.array([s for s, _ in series])
        vals = np.array([v for _, v in series])
        p50 = float(np.percentile(vals, 50))
        burst_thresh = p50 * 2.0
        burst_mask = vals > burst_thresh
        half = steps[-1] * 0.5
        late_mask = burst_mask & (steps > half)
        report["step"] = {
            "n": len(series),
            "first": round(float(vals[0]), 5),
            "last": round(float(vals[-1]), 5),
            "p50": round(p50, 5),
            "p90": round(float(np.percentile(vals, 90)), 5),
            "p99": round(float(np.percentile(vals, 99)), 5),
            "burst_threshold": round(burst_thresh, 5),
            "bursts": int(burst_mask.sum()),
            "late_bursts": int(late_mask.sum()),
            "burst_steps": [int(s) for s in steps[burst_mask][:15]],
        }
    # epoch-level regressions (train and val)
    for tag, label in (("loss/train_stop_epoch", "train"),
                       ("loss/val_stop_epoch", "val")):
        ep = sorted(scalars.get(tag, []))
        if ep:
            vals = [v for _, v in ep]
            regressions = [
                i + 1 for i in range(1, len(vals)) if vals[i] > vals[i - 1]
            ]
            report[f"epoch_{label}"] = {
                "values": [round(v, 5) for v in vals],
                "regression_epochs": regressions,
            }
    return report


def attribute_burst_epochs(metric_report: dict, ck_report: dict) -> None:
    """Map stop-loss burst STEPS to training EPOCHS using the checkpoints'
    optimizer_step counters as epoch boundaries (reference
    tb_print_stop_token_analysis epoch attribution, :899-970).  Mutates
    metric_report['stop_token']['step'] with 'burst_epochs'."""
    st = metric_report.get("stop_token", {}).get("step")
    if not st or not st.get("burst_steps"):
        return
    boundaries = [
        (c.get("epoch"), c.get("optimizer_step"))
        for c in ck_report.get("checkpoints", [])
        if isinstance(c.get("optimizer_step"), int)
        and c.get("epoch") is not None
    ]
    if not boundaries:
        return
    boundaries.sort(key=lambda t: t[1])
    per_epoch = defaultdict(int)
    for step in st["burst_steps"]:
        epoch = boundaries[-1][0] + 1  # after the last checkpointed epoch
        for ep, end_step in boundaries:
            if step <= end_step:
                epoch = ep
                break
        per_epoch[epoch] += 1
    st["burst_epochs"] = {int(k): v for k, v in sorted(per_epoch.items())}


def analyze_mel_stop_correlation(scalars: dict, window: int = 200) -> list:
    """mel<->stop co-movement over fixed step windows with attribution labels
    (reference tb_print_mel_stop_window_correlation, :1078-1140)."""
    mel = sorted(scalars.get("loss/mel", []))
    stop = sorted(scalars.get("loss/stop", []))
    lr = sorted(scalars.get("stats/lr_decoder", []))
    if not mel:
        return []
    lr_arr = np.array(lr) if lr else None
    lr_max = float(lr_arr[:, 1].max()) if lr is not None and len(lr) else 1.0
    rows = []
    max_step = mel[-1][0]
    w = (mel[0][0] // window) * window
    prev_mm = prev_sm = None
    while w <= max_step:
        seg_mel = [v for s, v in mel if w <= s < w + window]
        seg_stop = [v for s, v in stop if w <= s < w + window]
        if seg_mel:
            mm = float(np.mean(seg_mel))
            sm = float(np.mean(seg_stop)) if seg_stop else None
            dmel = mm - prev_mm if prev_mm is not None else None
            dstop = (
                sm - prev_sm
                if (prev_sm is not None and sm is not None) else None
            )
            label = ""
            if dmel is not None and dstop is not None:
                if dmel > 0 and dstop > 0:
                    label = "both_up_lr_pressure"
                elif dmel < 0 and dstop < 0:
                    label = "both_down_improving"
                elif dstop > 0 >= dmel:
                    label = "stop_up_only_stop_source"
                elif dmel > 0 >= dstop:
                    label = "mel_up_only"
            lr_pct = None
            if lr_arr is not None and len(lr_arr):
                mid = w + window // 2
                lr_here = lr_arr[np.abs(lr_arr[:, 0] - mid).argmin(), 1]
                lr_pct = round(100.0 * float(lr_here) / lr_max, 1)
            rows.append({
                "window": [int(w), int(w + window)],
                "mel_mean": round(mm, 5),
                "dmel": round(dmel, 5) if dmel is not None else None,
                "stop_mean": round(sm, 5) if sm is not None else None,
                "dstop": round(dstop, 5) if dstop is not None else None,
                "lr_pct": lr_pct,
                "attribution": label,
            })
            prev_mm, prev_sm = mm, sm
        w += window
    return rows


def _linear_slope(vals: list) -> tuple:
    """(slope per index, R^2) of a least-squares line."""
    if len(vals) < 2:
        return 0.0, 0.0
    x = np.arange(len(vals), dtype=np.float64)
    y = np.asarray(vals, np.float64)
    slope, intercept = np.polyfit(x, y, 1)
    pred = slope * x + intercept
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    return float(slope), r2


def analyze_val_mel_series(scalars: dict, spec_augment_epoch: int = 1) -> dict:
    """Epoch-series regression detection on val mel with SpecAugment-transient
    awareness (reference tb_print_val_mel_series, :820-850)."""
    vm = sorted(scalars.get("loss/val_mel_epoch", []))
    if not vm:
        return {}
    vals = [v for _, v in vm]
    epochs = []
    for i, v in enumerate(vals):
        flag = ""
        if i > 0 and v > vals[i - 1]:
            # epochs right after SpecAugment enables are expected transients
            in_sa_window = spec_augment_epoch <= (i + 1) < spec_augment_epoch + 5
            flag = "spec_augment_transient" if in_sa_window else "REGRESSION"
        epochs.append({"epoch": i + 1, "val_mel": round(v, 5), "flag": flag})
    slope, r2 = _linear_slope(vals)
    best = min(vals)
    return {
        "epochs": epochs,
        "best": round(best, 5),
        "best_epoch": vals.index(best) + 1,
        "last": round(vals[-1], 5),
        "slope_per_epoch": round(slope, 6),
        "r2": round(r2, 3),
        "regression_count": sum(1 for e in epochs if e["flag"] == "REGRESSION"),
    }


# ---------------------------------------------------------------------------
# Checklist
# ---------------------------------------------------------------------------

def build_checklist(ck_report: dict, metric_report: dict) -> list:
    checks = []

    def check(name, status, detail):
        checks.append({"check": name, "status": status, "detail": detail})

    nonfinite = sum(
        c.get("nonfinite_params", 0) for c in ck_report["checkpoints"]
    )
    check(
        "finite weights",
        "PASS" if nonfinite == 0 else "FAIL",
        f"{nonfinite} non-finite parameter values across checkpoints",
    )

    vm = metric_report.get("val_mel")
    if vm:
        status = (
            "PASS" if vm["tail_regression"] <= 0.02
            else "WARN" if vm["tail_regression"] <= 0.1 else "FAIL"
        )
        check(
            "val-mel regression", status,
            f"best {vm['best']} -> last {vm['last']} "
            f"(regression {vm['tail_regression']})",
        )
    gn = metric_report.get("grad_norm")
    if gn:
        status = "PASS" if gn["spike_rate"] < 0.01 else "WARN"
        check(
            "gradient spikes", status,
            f"{gn['spike_count']} spikes ({gn['spike_rate']*100:.1f}% of steps, "
            f"median {gn['median']})",
        )
    sat = metric_report.get("clip_saturation")
    if sat is not None:
        status = "PASS" if sat < 0.25 else "WARN" if sat < 0.4 else "FAIL"
        check(
            "clip saturation", status,
            f"{sat*100:.1f}% of steps clipped (reference guidance: >38% "
            "distorts gradient direction, config.py:247)",
        )
    ema = ck_report.get("ema_divergence")
    if ema and ema.get("final_norm") is not None:
        check(
            "EMA tracking", "PASS" if ema["final_norm"] < 50 else "WARN",
            f"final live-vs-EMA parameter-space distance {ema['final_norm']}",
        )
    jac = [
        c["rank_stability_jaccard"] for c in ck_report["checkpoints"]
        if c.get("rank_stability_jaccard") is not None
    ]
    if jac:
        mean_j = float(np.mean(jac))
        movers = ck_report.get("persistent_movers", [])
        if movers and mean_j >= 0.5:
            detail = (
                f"mean top-mover Jaccard {mean_j:.2f}; persistent: "
                + ", ".join(
                    f"{m['param'].split('/')[-2]}({m['epochs_in_top']}ep)"
                    for m in movers[:3]
                )
                + " — the SAME layers dominate drift (reference "
                "print_persistent_movers :390-400)"
            )
            status = "WARN"
        else:
            detail = (
                f"mean top-mover Jaccard {mean_j:.2f} "
                f"({len(movers)} persistent movers)"
            )
            status = "PASS"
        check("mover rank stability", status, detail)
    st = metric_report.get("stop_token", {}).get("step")
    if st:
        status = "PASS" if st["late_bursts"] == 0 else "WARN"
        check(
            "stop-loss bursts", status,
            f"{st['bursts']} bursts > 2x median ({st['burst_threshold']}); "
            f"{st['late_bursts']} in the 2nd half of the run"
            + ("" if st["late_bursts"] == 0 else
               " — stop loss NOT stabilizing (reference :948-953)"),
        )
    vs = metric_report.get("val_mel_series")
    if vs:
        status = (
            "PASS" if vs["regression_count"] == 0
            else "WARN" if vs["regression_count"] <= 2 else "FAIL"
        )
        check(
            "val-mel epoch series", status,
            f"best {vs['best']} @Ep{vs['best_epoch']}, last {vs['last']}, "
            f"slope {vs['slope_per_epoch']}/ep (R2 {vs['r2']}), "
            f"{vs['regression_count']} non-transient regression(s)",
        )
    corr = metric_report.get("mel_stop_correlation", [])
    stop_source = [r for r in corr if r["attribution"] == "stop_up_only_stop_source"]
    if corr:
        check(
            "mel<->stop co-movement",
            "PASS" if len(stop_source) <= max(1, len(corr) // 10) else "WARN",
            f"{len(stop_source)}/{len(corr)} windows attribute a loss rise to "
            "the stop head alone",
        )
    return checks


def recommendations(checks: list) -> list:
    recs = []
    for c in checks:
        if c["status"] == "PASS":
            continue
        if c["check"] == "val-mel regression":
            recs.append(
                "val-mel regressed after its best: consider lowering "
                "decoder_attn_lr_multiplier / variance_embedding_lr_multiplier "
                "(the reference's run-3 fix, config.py:58-71)"
            )
        elif c["check"] == "gradient spikes":
            recs.append(
                "frequent gradient spikes: tighten per-param pre-clips "
                "(ffn_spike_clip_norm / attention_spike_clip_norm)"
            )
        elif c["check"] == "clip saturation":
            recs.append(
                "global clip saturating: raise max_grad_norm and rely on "
                "per-param pre-clips instead (reference config.py:247 history)"
            )
        elif c["check"] == "finite weights":
            recs.append(
                "non-finite weights found: inspect skipped-step counters and "
                "lower the warmup floor of the explosion detector"
            )
        elif c["check"] == "stop-loss bursts":
            recs.append(
                "late stop-loss bursts: lower stop_head_lr_multiplier or "
                "stop_head_spike_clip_norm (the head is gradient-isolated, so "
                "bursts are confined to it — reference trainer.py:547-563)"
            )
        elif c["check"] == "val-mel epoch series":
            recs.append(
                "val-mel regressing across epochs: check the mel<->stop "
                "correlation table for attribution, and consider the "
                "reference's run-3 attention-LR fix (config.py:58-61)"
            )
        elif c["check"] == "mel<->stop co-movement":
            recs.append(
                "loss rises attribute to the stop head alone: reduce "
                "stop_token_loss_weight or stop-head LR"
            )
    return recs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model-dir", required=True)
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args()
    model_dir = Path(args.model_dir)
    if not model_dir.exists():
        print(f"error: {model_dir} not found", file=sys.stderr)
        return 1

    ck_report = analyze_checkpoints(model_dir)
    metric_report = analyze_metrics(load_scalars(model_dir / "logs"))
    attribute_burst_epochs(metric_report, ck_report)
    checks = build_checklist(ck_report, metric_report)
    recs = recommendations(checks)

    if args.json:
        print(json.dumps({
            "checkpoints": ck_report, "metrics": metric_report,
            "checklist": checks, "recommendations": recs,
        }, indent=2))
        return 0

    print("=" * 70)
    print("TRAINING REGRESSION ANALYSIS")
    print("=" * 70)
    for c in ck_report["checkpoints"]:
        if "error" in c:
            print(f"  {c['name']}: ERROR {c['error']}")
            continue
        movers = ", ".join(
            f"{m['param'].split('/')[-2]}[{m['group']}]:{m['delta']}"
            for m in c.get("top_movers", [])[:3]
        )
        delta = c.get("total_delta_norm")
        vel = c.get("delta_velocity")
        jac = c.get("rank_stability_jaccard")
        print(
            f"  {c['name']}: |w|={c.get('total_norm', '?')} "
            f"|dw|={delta if delta is not None else '-'} "
            f"vel={vel if vel is not None else '-'} "
            f"|w-ema|={c.get('ema_divergence_norm', '-')} "
            f"jaccard={jac if jac is not None else '-'} "
            f"nonfinite={c.get('nonfinite_params', '?')}"
        )
        if movers:
            print(f"      movers: {movers}")
        gd = c.get("group_deltas")
        if gd:
            print("      group |dw|: "
                  + "  ".join(f"{g}={v}" for g, v in list(gd.items())[:5]))
    if ck_report.get("persistent_movers"):
        print("  persistent movers (in top-8 across epochs):")
        for m in ck_report["persistent_movers"]:
            print(
                f"    {m['param']} [{m['group']}]: "
                f"{m['epochs_in_top']}/{m['of_epochs']} epochs"
            )
    if ck_report.get("ema_divergence"):
        print(f"  EMA divergence: {ck_report['ema_divergence']}")
    print("-" * 70)
    for k, v in metric_report.items():
        if k == "mel_stop_correlation":
            print("  mel<->stop correlation (200-step windows):")
            for r in v:
                print(
                    f"    {r['window'][0]:>6}-{r['window'][1]:<6} "
                    f"mel={r['mel_mean']:.5f} ({r['dmel'] if r['dmel'] is not None else '':>8}) "
                    f"stop={r['stop_mean'] if r['stop_mean'] is not None else '?'} "
                    f"({r['dstop'] if r['dstop'] is not None else '':>8}) "
                    f"lr={r['lr_pct'] if r['lr_pct'] is not None else '?':>5}% "
                    f"{r['attribution']}"
                )
        elif k == "val_mel_series":
            print("  val-mel epoch series:")
            for e in v["epochs"]:
                print(f"    Ep{e['epoch']:02d}  val_mel={e['val_mel']:.5f}  {e['flag']}")
            print(
                f"    best={v['best']} @Ep{v['best_epoch']}  last={v['last']}  "
                f"slope={v['slope_per_epoch']}/ep  R2={v['r2']}"
            )
        else:
            print(f"  {k}: {v}")
    print("-" * 70)
    for c in checks:
        print(f"  [{c['status']:4}] {c['check']}: {c['detail']}")
    if recs:
        print("-" * 70)
        print("RECOMMENDATIONS:")
        for r in recs:
            print(f"  * {r}")
    print("=" * 70)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
