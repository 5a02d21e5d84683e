"""The port's quality run (``kokoro_tpu_torch/scripts/quality_run.py``) and
audio tool (``scripts/e2e_audio_artifact.py``) against the reference scripts
of the same names, loaded by path (they put the repository on ``sys.path``
themselves; nothing in them changes), and the port's ``KokoroTrainer`` held
to the JAX package's trainer epoch by epoch.

* The synthetic corpus is the reference's byte for byte (every WAV and
  ``metadata.csv``), in both modes.
* The run's configuration equals the reference's on every shared field, by
  default and under ``--long``; the reference's ``scan_steps`` is the one
  override without a counterpart.
* Trainer parity (``tests/torch_quality_parity.py``: the quality run's two
  phases, epochs 1..2 then a resume from ``auto`` through epoch 4, at small
  widths in f32 without dropout, both trainers from the JAX trainer's
  initial parameters): the item ids of every step's microbatches, the
  optimizer step at the break and at the end, the skipped steps, the best
  epoch and the history's row labels (epoch, step) are equal; the
  history's losses and metrics agree within ``HISTORY_RTOL`` = 2e-3 (the
  measured maximum is 1.3e-5, on ``val_duration``, which the rows round to
  5 decimals); the per-step learning rates each trainer logs agree within
  1e-6.
* The port's seeded initialisation draws every tensor at the JAX trainer's
  scale (the pitch and energy embeddings were 11x too large).
* ``audio_health`` equals the reference's on a seeded waveform; the audio
  tool, run on the parity run's directory with a small exported HiFi-GAN,
  writes a WAV of (the frames it reports) x 256 samples and its JSON under
  the run directory.
"""

import importlib.util
import json
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch

from kokoro_tpu_torch.scripts import e2e_audio_artifact as port_e2e
from kokoro_tpu_torch.scripts import quality_run as port_qr
from tests.torch_quality_parity import run_both

ROOT = Path(__file__).resolve().parents[1]
HISTORY_RTOL = 2e-3
# the reference's overrides without a field in the port: lax.scan chunks
NO_COUNTERPART = {"scan_steps"}


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref_qr():
    return _reference("quality_run")


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("quality_parity"))


@pytest.mark.parametrize("long_mode", [False, True], ids=["short", "long"])
def test_corpus_is_the_reference_byte_for_byte(ref_qr, tmp_path, long_mode):
    ref_qr.build_corpus(tmp_path / "ref", 3, long_mode=long_mode)
    port_qr.build_corpus(tmp_path / "port", 3, long_mode=long_mode)
    files = ["metadata.csv"] + [f"wavs/q{i:04d}.wav" for i in range(3)]
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    assert sorted(p.name for p in (tmp_path / "port" / "wavs").iterdir()) == [
        f"q{i:04d}.wav" for i in range(3)]


class _Captured(Exception):
    pass


def _reference_overrides(ref_qr, tmp_path, monkeypatch, long_mode, epochs):
    """The keyword arguments the reference's ``run`` gives
    ``get_default_config`` for its first phase (its corpus is made first, so
    the run builds none)."""
    import kokoro_tpu.config as ref_config

    captured = {}

    def capture(**kw):
        captured.update(kw)
        raise _Captured

    (tmp_path / "corpus").mkdir(parents=True, exist_ok=True)
    (tmp_path / "corpus" / "metadata.csv").write_text("q0000|привет", encoding="utf-8")
    monkeypatch.setattr(ref_config, "get_default_config", capture)
    with pytest.raises(_Captured):
        ref_qr.run(Namespace(out=str(tmp_path), utts=3, epochs=epochs, long=long_mode))
    return captured


@pytest.mark.parametrize("long_mode", [False, True], ids=["default", "long"])
def test_config_is_the_reference_field_by_field(ref_qr, tmp_path, monkeypatch, long_mode):
    import dataclasses

    import kokoro_tpu.config as ref_config
    from kokoro_tpu_torch.config import get_default_config

    real = ref_config.get_default_config
    epochs = 30
    theirs_kw = _reference_overrides(ref_qr, tmp_path, monkeypatch, long_mode, epochs)
    ours_kw = port_qr.config_overrides(tmp_path / "corpus", tmp_path / "run", epochs, long_mode)
    ours_kw["num_epochs"] = epochs // 2
    assert set(theirs_kw) - set(ours_kw) == (NO_COUNTERPART if long_mode else set())
    assert set(ours_kw) <= set(theirs_kw)
    theirs = real(**theirs_kw)
    model_cfg, train_cfg = get_default_config(**ours_kw)
    shared = ({f.name for f in dataclasses.fields(theirs)}
              & ({f.name for f in dataclasses.fields(model_cfg)}
                 | {f.name for f in dataclasses.fields(train_cfg)}))
    assert {"use_flash_attention", "attention_weight_dropout", "gradient_checkpointing",
            "mel_bucket_sizes", "batch_size_multiple", "warmup_steps"} <= shared
    for name in sorted(shared):
        mine = getattr(train_cfg if hasattr(train_cfg, name) else model_cfg, name)
        if name == "feature_cache_dir":  # each package keeps its own cache directory
            assert Path(mine).parent == Path(getattr(theirs, name)).parent
            continue
        assert mine == getattr(theirs, name), name


def test_trainer_follows_the_reference_epoch_by_epoch(parity):
    jax, port = parity["jax"], parity["port"]
    assert parity["batches"]["port"] == parity["batches"]["jax"]
    assert len(parity["batches"]["port"]) == 4  # one step of 2 microbatches an epoch
    assert all(len(group) == 2 for group in parity["batches"]["port"])
    for key in ("step_at_break", "final_step", "skipped"):
        assert port[key] == jax[key], key
    assert (port["step_at_break"], port["final_step"], port["skipped"]) == (2, 4, 0)
    assert port["resumed_step"] == port["step_at_break"]  # resumed from epoch 2's checkpoint
    assert port["result"]["best_val_epoch"] == jax["result"]["best_val_epoch"]
    np.testing.assert_allclose(port["result"]["best_val_loss"], jax["result"]["best_val_loss"],
                               rtol=HISTORY_RTOL)
    ours, theirs = parity["history"]["port"], parity["history"]["jax"]
    assert [(h["epoch"], h["step"]) for h in ours] == [(h["epoch"], h["step"]) for h in theirs]
    assert [h["epoch"] for h in ours] == [1, 2, 3, 4]
    worst = 0.0
    for mine, ref in zip(ours, theirs):
        assert mine.keys() == ref.keys()
        for key in mine.keys() - {"epoch", "step"}:
            gap = abs(mine[key] - ref[key]) / max(abs(ref[key]), 1e-12)
            worst = max(worst, gap)
            assert gap <= HISTORY_RTOL, (mine["epoch"], key, mine[key], ref[key])
    assert worst < HISTORY_RTOL
    # every step is taken and finite, and launches no kernel on the CPU
    assert all(s["metrics"]["stepped"] and np.isfinite(s["metrics"]["total"])
               and not s["launches"] and s["ms"] > 0 for s in port["steps"])
    assert [s["opt_step"] for s in port["steps"]] == [0, 1, 2, 3]
    assert [s["logged_step"] for s in port["steps"]] == [1, 2, 3, 4]


def _logged(run_dir: Path) -> dict:
    out = {}
    for line in (run_dir / "logs" / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if "value" in rec:
            out.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
    return out


def test_both_trainers_log_the_same_schedule_and_losses(parity):
    ours, theirs = (_logged(parity["run_dir"][k]) for k in ("port", "jax"))
    lr_tags = [t for t in theirs if t.startswith("stats/lr_")]
    assert len(lr_tags) == 6
    for tag in lr_tags + ["loss/mel", "loss/total", "loss/val_mel_epoch", "stats/grad_norm"]:
        steps_ours = [s for s, _ in ours[tag]]
        assert steps_ours == [s for s, _ in theirs[tag]], tag
        rtol = 1e-6 if tag.startswith("stats/lr_") else HISTORY_RTOL
        np.testing.assert_allclose([v for _, v in ours[tag]], [v for _, v in theirs[tag]],
                                   rtol=rtol, err_msg=tag)


def test_audio_health_is_the_reference(tmp_path):
    ref = _reference("e2e_audio_artifact")
    rng = np.random.default_rng(5)
    wav = (0.3 * np.sin(np.arange(22050) * 0.05) + 0.05 * rng.standard_normal(22050))
    wav[5000:9000] = 0.0
    wav = wav.astype(np.float32)
    assert port_e2e.audio_health(wav, 22050) == ref.audio_health(wav, 22050)
    assert port_e2e.audio_health(np.zeros(0, np.float32), 22050) == {"empty": True}


def test_audio_tool_writes_frames_times_256_samples(parity, tmp_path):
    from kokoro_tpu_torch.data.audio_io import read_wav
    from kokoro_tpu_torch.inference.vocoder import export_hifigan_npz
    from kokoro_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator

    torch.manual_seed(0)
    cfg = HiFiGANConfig(upsample_initial_channel=16)
    export_hifigan_npz(HiFiGANGenerator(cfg), tmp_path / "tiny_hifigan.npz", config=cfg)
    run_dir = parity["run_dir"]["port"]
    payload = port_e2e.run(port_e2e.parse_args([
        "--model", str(run_dir), "--vocoder", str(tmp_path / "tiny_hifigan.npz"),
        "--device", "cpu", "--max-len", "64"]))
    sr, wav = read_wav(run_dir / "sample_hifigan.wav")
    assert sr == 22050 and wav.size == payload["mel_frames"] * 256 == payload["samples"]
    assert json.loads((run_dir / "e2e_audio.json").read_text()) == payload
    for path in ("hifigan", "griffin_lim"):
        health = payload[path]
        assert health["nonfinite"] == 0 and np.isfinite(list(health.values())).all()
    assert payload["warm_latency_s"]["total_hifigan_path"] >= 0


def test_audio_tool_refuses_a_griffin_lim_fallback(parity, tmp_path):
    with pytest.raises(AssertionError, match="Griffin-Lim fallback"):
        port_e2e.run(port_e2e.parse_args([
            "--model", str(parity["run_dir"]["port"]), "--vocoder", str(tmp_path / "none.npz"),
            "--device", "cpu", "--max-len", "16"]))


def test_outputs_default_under_the_run_and_out_directories(tmp_path):
    args = port_e2e.parse_args(["--model", str(tmp_path)])
    assert args.wav_out is None and args.json_out is None and args.device == "cuda"
    qr_args = port_qr.parse_args([])
    assert qr_args.device == "cuda" and "docs" not in Path(qr_args.out).parts
    assert Path(port_e2e.DEFAULT_VOCODER) == ROOT / "docs" / "hifigan_v1_int8.npz"


def test_seeded_initialisation_draws_the_reference_scales(parity):
    """The port's ``init_weights`` draws each tensor at the scale of the
    JAX trainer's initialisation: the regression analyzer read the full
    run's parameter norm at 583.6 against the reference's 283.2 when the
    pitch and energy embeddings were drawn N(0, 1) instead of flax's
    ``nn.Embed`` default N(0, 1/sqrt(d))."""
    from kokoro_tpu_torch.config import KokoroConfig
    from kokoro_tpu_torch.convert import flax_names
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from tests.torch_quality_parity import SMALL

    fields = {k: v for k, v in SMALL.items() if k in KokoroConfig.__dataclass_fields__}
    model = KokoroModel(KokoroConfig(**fields)).init_weights(torch.Generator().manual_seed(42))
    names = flax_names(model)
    ours = {names[n]: float(p.detach().norm()) for n, p in model.named_parameters()}
    init = {k.removeprefix("params/"): v for k, v in parity["init"].items()}
    theirs = {k: float(np.linalg.norm(v)) for k, v in init.items()}
    assert ours.keys() == theirs.keys()
    for name, value in theirs.items():
        if init[name].size >= 1000:  # a sampled norm within 25 %
            assert 0.8 < ours[name] / value < 1.25, (name, ours[name], value)
    total = (sum(v * v for v in ours.values()) / sum(v * v for v in theirs.values())) ** 0.5
    assert abs(total - 1) < 0.05


# the committed card runs and the reference's record of the same schedule
CARD_RUNS = {"quality_run_h100.json": ("quality_run_metrics.json", None),
             "quality_run_flash_h100.json": ("quality_run_metrics.json",
                                             "packed_attention_fwd_causal"),
             "quality_run_long_h100.json": ("quality_run_long_metrics.json",
                                            "flash_attention_fwd")}


@pytest.mark.parametrize("name", sorted(CARD_RUNS))
def test_committed_card_run_meets_the_reference_limit(name):
    """Each committed H100 run: the reference's epochs and history rows (the
    break epoch twice where the reference has it twice), 0 skipped steps,
    the resume continuing from the break step, its kernel launched at every
    step where it runs one, and best val mel within 15 % of the reference's
    recorded value."""
    reference_name, kernel = CARD_RUNS[name]
    run = json.loads((ROOT / "kokoro_tpu_torch" / "scripts" / name).read_text())
    ref = json.loads((ROOT / "docs" / reference_name).read_text())
    assert run["device"].startswith("NVIDIA H100")
    assert run["epochs"] == ref["epochs"]
    assert [h["epoch"] for h in run["history"]] == [h["epoch"] for h in ref["history"]]
    assert run["skipped_steps"] == 0
    assert 0 < run["resumed_at_step"] <= run["resume_continued_from_step"] < run["optimizer_steps"]
    if kernel is not None:
        assert min(run["launches_per_step"][kernel]) > 0
    assert run["best_val_mel"] <= 1.15 * ref["best_val_mel"]
