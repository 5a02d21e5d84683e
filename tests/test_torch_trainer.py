"""Port's trainer (kokoro_tpu_torch/training/trainer.py) and checkpoints
(training/checkpoint.py) on the CPU under ``config.get_smoke_test_config``,
the JAX package's smoke preset (hidden 64, 2+2 layers, 4 heads, ff 128):
mirrors ``tests/unit/test_trainer_e2e.py``.  A two-epoch run with a resume
that continues the optimizer count, a refused restore under another
architecture, a bitwise checkpoint round trip, the run directory loading
in the serving pipeline, and ``train_model`` refusing to run without CUDA
unless asked for the CPU.
"""

import json

import numpy as np
import pytest
import torch

from kokoro_tpu_torch.config import get_smoke_test_config
from kokoro_tpu_torch.data.audio_io import save_wav
from kokoro_tpu_torch.training import checkpoint as ckpt_mod
from kokoro_tpu_torch.training.trainer import KokoroTrainer, train_model

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke_corpus")
    rng = np.random.default_rng(0)
    lines = []
    for i, text in enumerate(["привет мир", "как дела", "всё хорошо", "пока"]):
        tt = np.arange(int(22050 * 0.5)) / 22050
        audio = 0.4 * np.sin(2 * np.pi * (140 + 30 * i) * tt).astype(np.float32)
        audio += 0.03 * rng.normal(size=len(tt)).astype(np.float32)
        save_wav(root / "wavs" / f"s{i}.wav", audio, 22050)
        lines.append(f"s{i}|{text}")
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    return root


def make_config(corpus, out, **kw):
    base = dict(data_dir=str(corpus), output_dir=str(out), num_epochs=2,
                gradient_accumulation_steps=1, validation_split=0.25, save_every=1,
                log_every_steps=1, use_spec_augment=False, compute_dtype="float32")
    base.update(kw)
    return get_smoke_test_config(**base)


def test_train_then_resume_continues_the_optimizer_count(corpus, tmp_path):
    out = tmp_path / "run"
    trainer = KokoroTrainer(*make_config(corpus, out, num_epochs=1), device="cpu")
    result = trainer.train()
    assert np.isfinite(result["best_val_loss"])
    step1 = trainer.state.opt_step
    assert step1 > 0 and trainer.state.skipped_steps == 0
    assert (out / "checkpoint_epoch_1" / "metadata.json").exists()
    assert (out / "kokoro_russian_final" / "state.pt").exists()
    assert (out / "phoneme_processor.json").exists()

    trainer2 = KokoroTrainer(*make_config(corpus, out, num_epochs=2,
                                          gradient_accumulation_steps=2), device="cpu")
    trainer2.train()
    assert trainer2.start_epoch == 1
    assert trainer2.state.opt_step > step1
    assert trainer2.state.optimizer.count == trainer2.state.opt_step
    logs = (out / "logs").iterdir()
    assert any(True for _ in logs)

    # the run directory serves: EMA weights of the final model
    from kokoro_tpu_torch.inference.tts import KokoroTTS

    tts = KokoroTTS(str(out), device="cpu", vocoder_type="griffin_lim", max_len=24)
    mel = tts.synthesize_mel("привет")
    assert mel is not None and np.isfinite(mel).all()
    weights, meta = ckpt_mod.load_inference_weights(out)
    assert meta["hidden_dim"] == 64
    final = torch.load(out / "kokoro_russian_final" / "state.pt", weights_only=True)
    name = next(iter(final["ema"]))
    assert torch.equal(weights[name], final["ema"][name])


def test_restore_with_another_architecture_is_refused(corpus, tmp_path):
    out = tmp_path / "run2"
    KokoroTrainer(*make_config(corpus, out, num_epochs=1), device="cpu").train()
    bad = KokoroTrainer(*make_config(corpus, out, hidden_dim=128, resume_checkpoint="auto"),
                        device="cpu")
    with pytest.raises(ValueError, match="architecture mismatch"):
        bad._maybe_resume()


def test_checkpoint_round_trip_is_bitwise(corpus, tmp_path):
    out = tmp_path / "run3"
    trainer = KokoroTrainer(*make_config(corpus, out, num_epochs=1), device="cpu")
    trainer.train_epoch(0)
    state = trainer.state
    state.grad_ema, state.grad_ema_steps, state.skipped_steps = 1.25, 3, 1
    torch.randn(5, generator=trainer.generator)  # move the generator off its seed
    path = trainer.ckpt.save_checkpoint("probe", state, trainer.model_config, trainer.config,
                                        trainer.metadata, {"epoch": 0}, trainer.generator)
    expected = ckpt_mod.training_state_dict(state, trainer.generator)

    fresh = KokoroTrainer(*make_config(corpus, out, num_epochs=1), device="cpu")
    doc = fresh.ckpt.load_checkpoint(path, fresh.state, fresh.metadata, fresh.generator)
    got = ckpt_mod.training_state_dict(fresh.state, fresh.generator)
    assert doc["counters"] == {"epoch": 0}
    for key in ("model", "mu", "nu", "ema"):
        assert expected[key].keys() == got[key].keys()
        for name in expected[key]:
            assert torch.equal(expected[key][name], got[key][name]), (key, name)
    assert expected["count"] == got["count"] and expected["counters"] == got["counters"]
    assert torch.equal(expected["generator"], got["generator"])
    meta = json.loads((path / "metadata.json").read_text())
    assert meta["model_metadata"]["n_decoder_layers"] == 2


def test_train_model_needs_cuda_unless_asked_for_the_cpu(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_model(*make_config(corpus, tmp_path / "run4"))


def test_cli_arguments_map_to_the_configs(tmp_path):
    import argparse

    from kokoro_tpu_torch.cli.args import add_training_arguments, create_config_from_args

    parser = argparse.ArgumentParser()
    add_training_arguments(parser)
    args = parser.parse_args(["--data-dir", str(tmp_path), "--epochs", "3", "--resume", "",
                              "--gradient-accumulation", "1", "--flash-attention",
                              "--no-attention-weight-dropout", "--no-validation",
                              "--compute-dtype", "float32", "--device", "cpu"])
    mcfg, cfg = create_config_from_args(args)
    assert (cfg.num_epochs, cfg.resume_checkpoint, cfg.gradient_accumulation_steps) == (3, "", 1)
    assert mcfg.use_flash_attention and not mcfg.attention_weight_dropout
    assert cfg.validation_interval == 10**9 and cfg.compute_dtype == "float32"
    assert cfg.data_dir == str(tmp_path) and args.device == "cpu"
