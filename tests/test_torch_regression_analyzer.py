"""The port's regression analyzer
(``kokoro_tpu_torch/scripts/analyze_training_regression.py``) against the
reference script of the same name (loaded by path; nothing in it changes),
on the runs of ``tests/torch_quality_parity.py``: the JAX trainer's Orbax
checkpoints and the port trainer's ``torch.save`` checkpoints, both from the
same initial parameters through the same batches.

* The metric-log functions (``load_scalars``, ``analyze_metrics``,
  ``analyze_stop_token``, ``analyze_mel_stop_correlation``,
  ``analyze_val_mel_series``, ``build_checklist``) give the reference's
  output on the ``logs/metrics.jsonl`` the port's trainer wrote, floats to
  1e-9.
* The port's checkpoint parameters carry the reference's names
  (``params/<flax path>``), so ``classify_param`` gives the reference's
  class for every tensor.
* The reference's ``analyze_checkpoints`` on the JAX run and the port's on
  the port run agree: checkpoint names, epochs and optimizer steps exactly,
  non-finite counts (0) exactly, total norms, deltas, EMA divergences and
  per-class deltas within ``RTOL`` = 2e-3 plus the 1e-4 the reports round
  to; unrounded, each class's norm and delta from the two runs'
  parameters within ``RTOL``.
* ``main`` prints the checklist, ``--json`` a parseable report, and a second
  run reads the stats cache.
"""

import importlib.util
import json
import math
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest

from kokoro_tpu_torch.scripts import analyze_training_regression as port
from tests.torch_quality_parity import run_both

ROOT = Path(__file__).resolve().parents[1]
RTOL = 2e-3
ROUNDING = 1e-4  # the checkpoint report rounds norms and deltas to 4 decimals


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "reference_analyze_training_regression",
        ROOT / "scripts" / "analyze_training_regression.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("analyzer_parity"))


@pytest.fixture(scope="module")
def scalars(runs, ref):
    logdir = runs["run_dir"]["port"] / "logs"
    ours = port.load_scalars(logdir)
    assert ours == ref.load_scalars(logdir)
    return ours


def _assert_same(ours, theirs, path="report"):
    """Equal structure; floats within 1e-9."""
    if isinstance(theirs, dict):
        assert ours.keys() == theirs.keys(), path
        for k in theirs:
            _assert_same(ours[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(theirs, float):
        assert math.isclose(ours, theirs, rel_tol=1e-9, abs_tol=1e-9), (path, ours, theirs)
    else:
        assert ours == theirs, (path, ours, theirs)


def test_scalars_hold_every_step_and_epoch_series(scalars):
    for tag in ("loss/mel", "loss/stop", "stats/grad_norm", "stats/grad_norm_clipped",
                "stats/lr_decoder", "loss/val_mel", "loss/val_mel_epoch",
                "loss/train_stop_epoch", "loss/val_stop_epoch"):
        assert len(scalars[tag]) == 4, tag


@pytest.mark.parametrize("name", ["analyze_metrics", "analyze_stop_token",
                                  "analyze_mel_stop_correlation", "analyze_val_mel_series"])
def test_metric_log_functions_give_the_reference_output(scalars, ref, name):
    ours, theirs = getattr(port, name)(scalars), getattr(ref, name)(scalars)
    assert theirs  # each has something to say about the run
    _assert_same(ours, theirs)


def test_checklist_statuses_are_the_reference(runs, ref, scalars):
    ck = port.analyze_checkpoints(runs["run_dir"]["port"])
    metric_ours, metric_ref = port.analyze_metrics(scalars), ref.analyze_metrics(scalars)
    port.attribute_burst_epochs(metric_ours, ck)
    ref.attribute_burst_epochs(metric_ref, ck)
    _assert_same(metric_ours, metric_ref)
    ours, theirs = port.build_checklist(ck, metric_ours), ref.build_checklist(ck, metric_ref)
    _assert_same(ours, theirs)
    assert {c["check"] for c in ours} >= {"finite weights", "val-mel regression",
                                          "gradient spikes", "EMA tracking",
                                          "val-mel epoch series"}
    assert port.recommendations(ours) == ref.recommendations(theirs)


def _checkpoints(run_dir):
    return sorted(run_dir.glob("checkpoint_epoch_*"), key=lambda p: int(p.name.rsplit("_", 1)[1]))


def test_checkpoint_parameters_carry_the_reference_names_and_classes(runs, ref):
    ours = port.load_checkpoint_params(_checkpoints(runs["run_dir"]["port"])[0])
    theirs = ref.load_checkpoint_params(_checkpoints(runs["run_dir"]["jax"])[0])
    ours_flat, theirs_flat = (port.flatten_arrays(s["params"]) for s in (ours, theirs))
    assert ours_flat.keys() == ref.flatten_arrays(theirs["params"]).keys() == theirs_flat.keys()
    assert port.flatten_arrays(ours["ema_params"]).keys() == ours_flat.keys()
    classes = {name: port.classify_param(name) for name in ours_flat}
    assert classes == {name: ref.classify_param(name) for name in theirs_flat}
    assert {"encoder", "decoder_attn", "decoder_ffn", "variance_pred", "stop_head",
            "embedding", "decoder_io"} <= set(classes.values())
    for name in ours_flat:  # torch layout against flax layout: same sizes
        assert ours_flat[name].size == theirs_flat[name].size, name


def _close(a, b):
    return abs(a - b) <= RTOL * abs(b) + ROUNDING


def test_checkpoint_reports_agree_across_the_two_runs(runs, ref):
    ours = port.analyze_checkpoints(runs["run_dir"]["port"])
    theirs = ref.analyze_checkpoints(runs["run_dir"]["jax"])
    assert [c["name"] for c in ours["checkpoints"]] == ["checkpoint_epoch_2", "checkpoint_epoch_4"]
    assert len(ours["checkpoints"]) == len(theirs["checkpoints"])
    for mine, their in zip(ours["checkpoints"], theirs["checkpoints"]):
        assert "error" not in mine and "error" not in their
        for key in ("name", "epoch", "optimizer_step", "nonfinite_params"):
            assert mine[key] == their[key], key
        assert mine["nonfinite_params"] == 0
        for key in ("total_norm", "total_delta_norm", "delta_velocity", "ema_divergence_norm"):
            if their[key] is None:
                assert mine[key] is None, key
            else:
                assert _close(mine[key], their[key]), (key, mine[key], their[key])
        assert mine["group_deltas"].keys() == their["group_deltas"].keys()
        for group, value in their["group_deltas"].items():
            assert _close(mine["group_deltas"][group], value), group
    last = ours["checkpoints"][-1]
    assert last["total_delta_norm"] > 0 and last["top_movers"]
    assert _close(ours["ema_divergence"]["final_norm"], theirs["ema_divergence"]["final_norm"])


def test_class_norms_and_deltas_agree_unrounded(runs, ref):
    def per_class(states):
        norms, deltas = defaultdict(float), defaultdict(float)
        first, last = (port.flatten_arrays(s["params"]) for s in states)
        for name, arr in last.items():
            cls = ref.classify_param(name)
            norms[cls] += float(np.sum(arr.astype(np.float64) ** 2))
            deltas[cls] += float(np.sum((arr.astype(np.float64) - first[name]) ** 2))
        return ({k: math.sqrt(v) for k, v in norms.items()},
                {k: math.sqrt(v) for k, v in deltas.items()})

    ours = per_class([port.load_checkpoint_params(p)
                      for p in _checkpoints(runs["run_dir"]["port"])])
    theirs = per_class([ref.load_checkpoint_params(p)
                        for p in _checkpoints(runs["run_dir"]["jax"])])
    for mine, their in zip(ours, theirs):
        assert mine.keys() == their.keys()
        for cls in their:
            assert their[cls] > 0, cls
            np.testing.assert_allclose(mine[cls], their[cls], rtol=RTOL, err_msg=cls)


def test_main_prints_the_checklist_and_reuses_its_cache(runs, capsys, monkeypatch):
    run_dir = runs["run_dir"]["port"]
    monkeypatch.setattr("sys.argv", ["analyze", "--model-dir", str(run_dir), "--json"])
    assert port.main() == 0
    report = json.loads(capsys.readouterr().out)
    checks = {c["check"]: c["status"] for c in report["checklist"]}
    assert checks["finite weights"] == "PASS"
    assert report["checklist"] == port.build_checklist(report["checkpoints"], report["metrics"])
    assert (run_dir / ".analysis_stats_cache.json").exists()

    def no_reload(path):
        raise AssertionError(f"checkpoint reloaded despite the cache: {path}")

    monkeypatch.setattr(port, "load_checkpoint_params", no_reload)
    monkeypatch.setattr("sys.argv", ["analyze", "--model-dir", str(run_dir)])
    assert port.main() == 0
    assert "[PASS] finite weights" in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["analyze", "--model-dir", str(run_dir / "missing")])
    assert port.main() == 1


def test_load_scalars_without_a_jsonl_or_tensorboard(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("tensorboard"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    assert port.load_scalars(tmp_path) == {}
