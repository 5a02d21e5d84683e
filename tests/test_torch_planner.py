"""The port's memory planner (``utils/memory_planner.py``) and ``cli.plan``.

The committed H100 sweep (``kokoro_tpu_torch/utils/shape_sweep_h100.json``,
``torch.cuda.max_memory_allocated`` of one training step per shape, measured
by ``python -m kokoro_tpu_torch.utils.memory_planner --sweep``) is pinned as
``tests/unit/test_memory_planner.py`` pins the reference's: the estimate is
within 15 % of every measured allocated peak.  The estimate's structure
(which terms the attention route, remat and the batch move), the batch
advice and the CLI's table and ``--json`` document (the reference's layout
and keys) are held on the CPU.
"""

import contextlib
import dataclasses
import io
import json
import sys

import pytest
import torch

from kokoro_tpu.cli import plan as ref_plan
from kokoro_tpu_torch.cli import plan
from kokoro_tpu_torch.cli.profile_paths import LONG_REGIME
from kokoro_tpu_torch.config import get_default_config, get_high_performance_config
from kokoro_tpu_torch.utils import memory_planner as mp

GIB = 1024**3
SWEEP = json.loads(mp.SWEEP_FILE.read_text())
CONFIGS = {label: (m, c) for label, m, c, _ in mp.sweep_configs()}


@pytest.fixture(scope="module")
def preset():
    m, c = get_high_performance_config()
    return m, c, mp.count_params(m, m.vocab_size)


def test_sweep_was_taken_on_the_card():
    assert SWEEP["total_memory_bytes"] == mp.DEFAULT_HBM_BYTES
    rows = SWEEP["rows"]
    assert {r["config"] for r in rows} == set(CONFIGS)
    assert [(r["B"], r["T"], r["L"]) for r in rows if r["config"] == "preset"] == list(mp.LADDER)
    for r in rows:
        assert r["card"].startswith("NVIDIA H100") and r["power_limit"].endswith("W")
        assert r["peak_reserved_bytes"] >= r["peak_allocated_bytes"] > 0 and r["stepped"] == 1.0


@pytest.mark.parametrize("row", SWEEP["rows"],
                         ids=lambda r: f"{r['config']}-B{r['B']}-T{r['T']}")
def test_estimate_within_15_percent_of_the_measured_peak(row):
    m, c = CONFIGS[row["config"]]
    est = mp.estimate_train_step_hbm(m, c, row["B"], row["T"], row["L"],
                                     n_params=mp.count_params(m, m.vocab_size))
    assert abs(est.total_bytes / row["peak_allocated_bytes"] - 1) <= 0.15, est.summary()


def test_fitted_coefficients_are_the_sweeps():
    assert mp.fit_coefficients(SWEEP["rows"]) == pytest.approx(
        (mp._F32_SAVES, mp._ACT_SAVES, mp._REMAT_LIVE), rel=1e-3)


def test_count_params_allocates_nothing(preset):
    m, _, n = preset
    assert 40_000_000 < n < 60_000_000
    assert 0.5 < mp._approx_params(m) / n < 2.0


def test_total_is_sum_of_terms_and_monotonic_in_batch(preset):
    m, c, n = preset
    ests = [mp.estimate_train_step_hbm(m, c, b, 512, 96, n) for b in (8, 16, 32, 64)]
    assert [e.total_bytes for e in ests] == sorted({e.total_bytes for e in ests})
    e = ests[0]
    assert e.total_bytes == (e.state_bytes + e.token_activation_bytes + e.attention_weight_bytes
                             + e.transient_bytes + e.batch_bytes + e.overhead_bytes)
    # f32 params, grads, mu, nu, EMA and the bf16 weight casts
    assert e.state_bytes == n * 4 * 5 + n * 2


def test_plain_route_adds_the_decoder_quadratic_terms(preset):
    m, c, n = preset
    kernels = mp.estimate_train_step_hbm(m, c, 16, 896, 160, n)
    plain = mp.estimate_train_step_hbm(dataclasses.replace(m, use_flash_attention=False), c,
                                       16, 896, 160, n)
    assert kernels.flash_active and not plain.flash_active
    # the encoder's self-attention over phonemes is plain either way
    assert 0 < kernels.attention_weight_bytes < plain.attention_weight_bytes
    assert plain.transient_bytes > kernels.transient_bytes
    assert kernels.token_activation_bytes == plain.token_activation_bytes
    no_dropout = mp.estimate_train_step_hbm(
        dataclasses.replace(m, use_flash_attention=False, attention_weight_dropout=False), c,
        16, 896, 160, n)
    assert no_dropout.attention_weight_bytes < plain.attention_weight_bytes


def test_remat_keeps_one_layer_alive(preset):
    m, c, n = preset
    plain = mp.estimate_train_step_hbm(m, c, 16, 896, 160, n)
    remat = mp.estimate_train_step_hbm(m, dataclasses.replace(c, gradient_checkpointing=True),
                                       16, 896, 160, n)
    assert remat.remat_active and not plain.remat_active
    assert remat.token_activation_bytes < plain.token_activation_bytes
    assert remat.attention_weight_bytes < plain.attention_weight_bytes
    assert "remat" in remat.summary() and "B=16 T=896" in remat.summary()


def test_max_batch_and_plan(preset):
    m, c, n = preset
    b = mp.max_batch_size(m, c, 896, 160, n_params=n, multiple=16)
    assert b % 16 == 0 and b >= 16
    assert mp.max_batch_size(m, c, 1800, 256, hbm_bytes=1 * GIB, n_params=n) == 0
    rows = mp.plan_buckets(m, c, n_params=n)
    assert len(rows) == len(c.mel_bucket_sizes) and all(r["configured_fits"] for r in rows)
    assert not mp.plan_buckets(m, dataclasses.replace(c, batch_size=4096), n_params=n)[-1][
        "configured_fits"]


def test_recommendations(preset):
    m, c, n = preset
    rec = mp.recommend_settings(m, c, n_params=n)
    assert rec["batch_size"] > c.batch_size and rec["gradient_checkpointing"] is False
    plain_m = dataclasses.replace(m, use_flash_attention=False)
    assert any("use_flash_attention" in note
               for note in mp.recommend_settings(plain_m, c, n_params=n)["notes"])
    assert mp.recommend_settings(plain_m, c, hbm_bytes=6 * GIB, n_params=n)[
        "gradient_checkpointing"] is True


def test_long_regime_estimate_is_the_long_step(preset):
    m, c = get_default_config(**LONG_REGIME)
    est = mp.estimate_train_step_hbm(m, c, *mp.LONG, n_params=mp.count_params(m, m.vocab_size))
    assert est.flash_active and not est.remat_active and est.fits(mp.DEFAULT_HBM_BYTES, 0.9)


def test_live_memory_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mp.live_hbm_bytes() is None


def _run(main, argv, monkeypatch=None):
    """The port's CLI, or (with ``monkeypatch``) the reference's, whose
    parameter count (a traced init) is replaced by the port's number: only
    its layout is compared."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if monkeypatch is None:
            assert main(argv) == 0
        else:
            from kokoro_tpu.utils import memory_planner as ref_mp

            m, _ = get_default_config()
            monkeypatch.setattr(ref_mp, "count_params",
                                lambda config, vocab_size: mp.count_params(m, vocab_size))
            monkeypatch.setattr(sys, "argv", ["kokoro-plan", *argv])
            assert main() == 0
    return out.getvalue()


def test_cli_table_has_the_references_layout(monkeypatch):
    argv = ["--data-dir", "/nonexistent", "--hbm-gib", "80"]
    ours = _run(plan.main, argv).splitlines()
    theirs = _run(ref_plan.main, argv, monkeypatch).splitlines()
    assert ours[0] == "HBM budget: 80.00 GiB (safety margin 0.9)"
    assert ours[0] == theirs[0] and ours[3] == theirs[3]  # budget and the column header
    assert "Recommendation at the largest bucket:" in ours
    assert any(line.startswith("  configured-step estimate: B=16 T=1800") for line in ours)


def test_cli_json_has_the_references_keys(monkeypatch):
    argv = ["--data-dir", "/nonexistent", "--json", "--hbm-gib", "8"]
    ours = json.loads(_run(plan.main, argv))
    theirs = json.loads(_run(ref_plan.main, argv, monkeypatch))
    assert ours.keys() == theirs.keys() and ours["hbm_bytes"] == 8 * GIB
    assert [r.keys() for r in ours["buckets"]] == [r.keys() for r in theirs["buckets"]]
    assert ours["recommendation"].keys() == theirs["recommendation"].keys()


def test_cli_without_a_card_needs_hbm_gib(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        plan.main(["--data-dir", "/nonexistent"])
    assert err.value.code == 2 and "--hbm-gib" in capsys.readouterr().err
