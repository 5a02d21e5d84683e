"""The port trainer's observability on the CPU at the smoke widths, against
the JAX package's tag namespace (``tests/unit/test_observability_tags.py``)
and its ``make_diagnostic_step``.

One module-scoped pair of two-epoch runs on a 4-utterance corpus: one with
every diagnostic on (``histogram_every_steps=1``, the profiler window in
epoch 1, the interbatch profiler, ``verbose``, ``log_every_steps=1``), one
with all of them off.  The first run's event file holds every scalar family
of the reference, ``weights/*`` named by the flax paths of the reference's
parameters, ``gradients/*`` and ``val_predictions/*`` histograms and the
four spectrogram images; its profiler window wrote a trace; the two runs end
with bit-identical parameters, EMA, optimizer state and generator.  The
diagnostic step matches the reference's at f32 (losses and spectral
convergence 2e-5, gradients 1e-4: the f32 tolerances of
``docs/attention_numerics_tpu.json``) and perturbs nothing.
"""

import io
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from kokoro_tpu.config import get_smoke_test_config as ref_smoke_config
from kokoro_tpu.models.kokoro import KokoroModel as RefModel
from kokoro_tpu.training.train_step import make_diagnostic_step as ref_make_diagnostic_step
from kokoro_tpu_torch.config import KokoroConfig, get_smoke_test_config
from kokoro_tpu_torch.convert import flax_names, kokoro_state_dict_from_flax
from kokoro_tpu_torch.data.audio_io import save_wav
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.training import trainer as trainer_mod
from kokoro_tpu_torch.training.train_step import make_diagnostic_step
from tests.torch_parity import init_flax, perturbed_params, t

SCALAR_FAMILIES = [  # tests/unit/test_observability_tags.py
    "loss/total", "loss/mel", "loss/duration", "loss/stop", "loss/pitch", "loss/energy",
    "loss/val_total", "loss/val_mel",
    "loss/train_total_epoch", "loss/train_mel_epoch", "loss/train_stop_epoch",
    "loss/val_total_epoch", "loss/val_mel_epoch",
    "stats/grad_norm", "stats/grad_norm_clipped",
    "stats/lr_encoder", "stats/lr_decoder", "stats/lr_decoder_ffn",
    "stats/lr_decoder_attn", "stats/lr_stop_head", "stats/lr_variance_embed",
    "metrics/val_spectral_convergence", "metrics/val_f0_rmse", "metrics/val_mcd",
    "metrics/train_spectral_convergence",
]
SMOKE_ARCH = dict(n_mels=80, hidden_dim=64, n_encoder_layers=2, n_decoder_layers=2, n_heads=4,
                  encoder_ff_dim=128, decoder_ff_dim=128, variance_filter_size=32)


def _corpus(root):
    rng = np.random.default_rng(0)
    lines = []
    for i, text in enumerate(["привет мир", "как дела", "всё хорошо", "пока"]):
        tt = np.arange(int(22050 * 0.5)) / 22050
        audio = 0.4 * np.sin(2 * np.pi * (150 + 25 * i) * tt) + 0.02 * rng.normal(size=len(tt))
        save_wav(root / "wavs" / f"s{i}.wav", audio.astype(np.float32), 22050)
        lines.append(f"s{i}|{text}")
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("torch.utils.tensorboard")
    corpus = _corpus(tmp_path_factory.mktemp("obs_corpus"))
    out = {}
    for name, diagnostics in (("on", True), ("off", False)):
        run_dir = tmp_path_factory.mktemp(f"obs_{name}")
        cfg = get_smoke_test_config(
            data_dir=str(corpus), output_dir=str(run_dir), num_epochs=2,
            validation_split=0.25, use_spec_augment=False, compute_dtype="float32",
            save_every=1, log_every_steps=1, histogram_every_steps=int(diagnostics),
            enable_profiling=diagnostics, enable_interbatch_profiling=diagnostics,
            verbose=diagnostics)
        log = io.StringIO()
        handler = logging.StreamHandler(log)
        logger = logging.getLogger("kokoro_tpu_torch.training.trainer")
        level = logger.level
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        try:
            trainer = trainer_mod.KokoroTrainer(*cfg, device="cpu")
            trainer.train()
        finally:
            logger.removeHandler(handler)
            logger.setLevel(level)
        out[name] = (trainer, run_dir, log.getvalue())
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(out["on"][1] / "logs"),
                           size_guidance={"scalars": 0, "histograms": 0, "images": 0,
                                          "tensors": 0})
    acc.Reload()
    return out, acc.Tags()


@pytest.mark.parametrize("tag", SCALAR_FAMILIES)
def test_scalar_tag_present(runs, tag):
    assert tag in runs[1]["scalars"], sorted(runs[1]["scalars"])


def test_weight_histograms_are_the_reference_flax_paths(runs):
    trainer = runs[0]["on"][0]
    m = trainer.model_config
    ref = RefModel(vocab_size=m.vocab_size, **SMOKE_ARCH, gradient_checkpointing=False)
    B, L, T = 1, 8, 16
    shapes = jax.eval_shape(lambda r: ref.init(
        r, phoneme_indices=jnp.zeros((B, L), jnp.int32),
        mel_specs=jnp.zeros((B, T, 80), jnp.float32),
        phoneme_durations=jnp.full((B, L), 2, jnp.int32),
        stress_indices=jnp.zeros((B, L), jnp.int32),
        pitch_targets=jnp.zeros((B, T), jnp.float32),
        energy_targets=jnp.zeros((B, T), jnp.float32), deterministic=True),
        jax.random.PRNGKey(0))
    ref_names = {"weights/params/" + k for k in flatten_dict(shapes["params"], sep="/")}
    hists = set(runs[1]["histograms"])
    assert {h for h in hists if h.startswith("weights/")} == ref_names
    assert {h for h in hists if h.startswith("gradients/")} == {
        "gradients/" + h[len("weights/"):] for h in ref_names}


@pytest.mark.parametrize("tag", ["val_predictions/log_durations", "val_predictions/pitch",
                                 "val_predictions/energy"])
def test_val_prediction_histograms_present(runs, tag):
    assert tag in runs[1]["histograms"]


def test_spectrogram_images_and_custom_scalars_present(runs):
    for tag in ("spectrogram/val_predicted", "spectrogram/val_ground_truth",
                "spectrogram/train_predicted", "spectrogram/train_ground_truth"):
        assert tag in runs[1]["images"], tag
    assert "custom_scalars__config__" in runs[1]["tensors"]


def test_profiler_window_and_logged_diagnostics(runs):
    _, run_dir, log = runs[0]["on"]
    traces = list((run_dir / "profiler_logs").glob("*.pt.trace.json"))
    events = json.loads(traces[0].read_text())["traceEvents"] if len(traces) == 1 else []
    assert events
    spans = {e.get("name") for e in events if str(e.get("name", "")).startswith("kokoro.")}
    assert {"kokoro.data", "kokoro.collate", "kokoro.train_step", "kokoro.forward",
            "kokoro.backward", "kokoro.optimizer", "kokoro.host_read"} <= spans, spans
    for line in ("Duration pred @1:", "Duration pred @2:", "interbatch profile: kokoro.data:",
                 "optimizer steps in", "Feature cache:"):
        assert line in log, line
    _, off_dir, off_log = runs[0]["off"]
    assert not (off_dir / "profiler_logs").exists()
    assert "Duration pred" not in off_log and "interbatch profile" not in off_log


def test_diagnostics_do_not_perturb_training(runs):
    on, off = runs[0]["on"][0].state, runs[0]["off"][0].state
    assert on.opt_step == off.opt_step == 2
    for (name, a), b in zip(on.model.named_parameters(), off.model.parameters()):
        assert torch.equal(a, b), name
        assert a.grad is None
    assert all(torch.equal(on.ema[k], off.ema[k]) for k in on.ema)
    assert all(torch.equal(x, y) for x, y in zip(on.optimizer.mu, off.optimizer.mu))
    assert all(torch.equal(x, y) for x, y in zip(on.optimizer.nu, off.optimizer.nu))
    assert on.optimizer.count == off.optimizer.count
    assert torch.equal(runs[0]["on"][0].generator.get_state(),
                       runs[0]["off"][0].generator.get_state())


def test_memory_preflight_is_advisory(runs, monkeypatch, caplog):
    from kokoro_tpu_torch.utils import memory_planner

    trainer = runs[0]["on"][0]
    monkeypatch.setattr(memory_planner, "live_hbm_bytes", lambda: 80 * 1024**3)
    with caplog.at_level(logging.INFO, logger="kokoro_tpu_torch.training.trainer"):
        trainer._preflight_memory_check()
        monkeypatch.setattr(memory_planner, "live_hbm_bytes", lambda: 1024)
        trainer._preflight_memory_check()
    messages = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("HBM plan: B=4 T=128 L=32") for m in messages)
    assert any("exceeds the card" in m for m in messages)


def test_debug_batch_of_a_skipped_step(runs, tmp_path):
    trainer = runs[0]["off"][0]
    trainer.output_dir = tmp_path
    batch = {"mel_specs": np.full((2, 4, 80), np.nan, np.float32)}
    trainer._dump_debug_batch(batch, 7)
    with np.load(tmp_path / "debug_batch_step_7.npz") as z:
        assert np.isnan(z["mel_specs"]).all()


def test_jsonl_writer_keeps_histograms_and_images(tmp_path):
    import chip_smoke

    writer = trainer_mod._JsonlWriter(tmp_path)
    writer.add_scalar("loss/total", 1.5, 1)
    writer.add_histogram("weights/params/a/kernel", np.arange(4.0), 1)
    writer.add_histogram("val_predictions/pitch", np.zeros(0), 1)
    writer.add_image("spectrogram/val_predicted", np.ones((1, 80, 5)), 2)
    writer.close()
    records = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert records[1] == {"tag": "weights/params/a/kernel", "kind": "histogram", "step": 1,
                          "count": 4, "min": 0.0, "max": 3.0, "mean": 1.5,
                          "std": float(np.arange(4.0).std())}
    assert np.load(tmp_path / records[3]["file"]).shape == (1, 80, 5)
    assert chip_smoke.logged_tags(tmp_path) == {
        "scalars": {"loss/total"}, "histograms": {"weights/params/a/kernel",
                                                  "val_predictions/pitch"},
        "images": {"spectrogram/val_predicted"}}


# -- the diagnostic step against the reference's ---------------------------------------
def _batch(seed=3, B=2, T=64, L=12):
    rng = np.random.default_rng(seed)
    mel_len, phon_len = np.asarray([T, T - 9], np.int32), np.asarray([L, L - 3], np.int32)
    stop = (np.arange(T)[None, :] >= mel_len[:, None] - 1).astype(np.float32)
    return {
        "phoneme_indices": rng.integers(1, 59, (B, L)).astype(np.int32),
        "stress_indices": rng.integers(0, 3, (B, L)).astype(np.int32),
        "phoneme_durations": rng.integers(1, 2 * T // L, (B, L)).astype(np.int32),
        "mel_specs": rng.normal(-5.0, 2.0, (B, T, 80)).astype(np.float32),
        "pitch_targets": rng.uniform(size=(B, T)).astype(np.float32),
        "energy_targets": rng.uniform(size=(B, T)).astype(np.float32),
        "stop_token_targets": stop, "mel_lengths": mel_len, "phoneme_lengths": phon_len,
    }


def test_diagnostic_step_matches_reference():
    # the smoke widths at one layer each: the reference's jit compile is the cost
    arch = dict(SMOKE_ARCH, n_encoder_layers=1, n_decoder_layers=1)
    batch = _batch()
    ref_cfg = ref_smoke_config(compute_dtype="float32")
    jm = RefModel(vocab_size=59, **arch, gradient_checkpointing=False)
    init = {k: jnp.asarray(batch[k]) for k in ("phoneme_indices", "mel_specs",
                                               "phoneme_durations", "stress_indices",
                                               "pitch_targets", "energy_targets")}
    variables, flat = perturbed_params(init_flax(jm, **init), 5)
    ref_out, ref_losses, ref_grads = ref_make_diagnostic_step(jm, ref_cfg)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})

    mcfg, cfg = get_smoke_test_config(compute_dtype="float32")
    model = KokoroModel(KokoroConfig(vocab_size=59, **arch))
    model.load_state_dict(kokoro_state_dict_from_flax(flat), strict=True)
    model.train()
    rng_state = torch.get_rng_state()
    out, losses, grads = make_diagnostic_step(model, cfg)({k: t(v) for k, v in batch.items()})
    assert model.training and all(p.grad is None for p in model.parameters())
    assert torch.equal(torch.get_rng_state(), rng_state)
    assert set(losses) == set(ref_losses)
    for k in ref_losses:
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=2e-5, atol=2e-5,
                                   err_msg=k)
    np.testing.assert_allclose(out["predicted_mel"].numpy(), np.asarray(ref_out["predicted_mel"]),
                               atol=2e-5)
    ref_g = kokoro_state_dict_from_flax(
        {k: np.asarray(v, np.float32) for k, v in flatten_dict(ref_grads["params"],
                                                               sep="/").items()})
    assert set(grads) == set(ref_g) == set(flax_names(model))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_g[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
