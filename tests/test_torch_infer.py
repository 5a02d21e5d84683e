"""Port's kokoro-infer path on the CPU at smoke widths: the EMA / raw weight
choice of a run directory (``use_ema_weights`` auto | ema | model),
``ModelLoader``, ``KokoroTTS.batch_text_to_speech``, ``cli.infer.main``, the
torch ``.pth`` HiFi-GAN loader against the JAX package's ``VocoderManager``
(1e-4, the tolerance of ``tests/test_torch_vocoder.py``) and the server's
``POST /profile``.
"""

import http.client
import json
import shutil
import threading
import time
import wave

import numpy as np
import pytest
import torch

from kokoro_tpu_torch.config import get_smoke_test_config
from kokoro_tpu_torch.data.audio_io import save_wav
from kokoro_tpu_torch.inference import vocoder
from kokoro_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from kokoro_tpu_torch.training.checkpoint import FINAL_NAME, load_inference_weights
from kokoro_tpu_torch.training.trainer import KokoroTrainer

SMOKE = dict(  # on top of get_smoke_test_config: one epoch of B=2
    gradient_accumulation_steps=1, validation_split=0.25, use_spec_augment=False,
    compute_dtype="float32", save_every=1,
)
MAX_LEN = 24
LONG_TEXT = ("Сегодня хорошая погода, и мы идём гулять в большой парк у реки вместе с друзьями. "
             "Завтра будет дождь, поэтому мы останемся дома и будем читать интересные книги.")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer_run")
    rng = np.random.default_rng(0)
    lines = []
    for i, text in enumerate(["привет мир", "как дела", "всё хорошо", "пока"]):
        tt = np.arange(int(22050 * 0.5)) / 22050
        audio = 0.4 * np.sin(2 * np.pi * (140 + 30 * i) * tt) + 0.03 * rng.normal(size=len(tt))
        save_wav(root / "corpus" / "wavs" / f"s{i}.wav", audio.astype(np.float32), 22050)
        lines.append(f"s{i}|{text}")
    (root / "corpus" / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    KokoroTrainer(*get_smoke_test_config(**SMOKE, data_dir=str(root / "corpus"),
                                      output_dir=str(root / "run")), device="cpu").train()
    return root / "run"


def test_weight_choice_of_a_run_directory(run_dir, tmp_path):
    ema, _ = load_inference_weights(run_dir, "ema")
    raw, meta = load_inference_weights(run_dir, "model")
    auto, _ = load_inference_weights(run_dir, "auto")
    assert meta["hidden_dim"] == 64 and ema.keys() == raw.keys() == auto.keys()
    assert all(torch.equal(auto[k], ema[k]) for k in ema)
    assert any(not torch.equal(raw[k], ema[k]) for k in ema)
    # a checkpoint that recorded no EMA update: auto takes the raw weights
    copy = tmp_path / "run"
    shutil.copytree(run_dir, copy)
    meta_file = copy / FINAL_NAME / "metadata.json"
    doc = json.loads(meta_file.read_text())
    doc["counters"]["ema_updates"] = 0
    meta_file.write_text(json.dumps(doc))
    auto0, _ = load_inference_weights(copy, "auto")
    assert all(torch.equal(auto0[k], raw[k]) for k in raw)
    with pytest.raises(ValueError, match="use_ema_weights"):
        load_inference_weights(run_dir, "best")

    from kokoro_tpu_torch.inference.tts import KokoroTTS

    for choice, want in (("ema", ema), ("model", raw)):
        tts = KokoroTTS(str(run_dir), device="cpu", vocoder_type="griffin_lim",
                        use_ema_weights=choice, max_len=MAX_LEN)
        got = tts.model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_model_loader(run_dir):
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.models.model_loader import ModelLoader

    model, state = ModelLoader(run_dir).load()
    assert isinstance(model, KokoroModel) and not model.training
    ema, _ = load_inference_weights(run_dir, "auto")
    assert all(torch.equal(model.state_dict()[k], ema[k]) for k in ema)
    _, raw = ModelLoader(run_dir).load(use_ema=False)
    want, _ = load_inference_weights(run_dir, "model")
    assert all(torch.equal(raw[k], want[k]) for k in want)
    _, epoch1 = ModelLoader(run_dir).load(checkpoint="checkpoint_epoch_1")
    assert epoch1.keys() == ema.keys()
    with pytest.raises(FileNotFoundError):
        ModelLoader(run_dir).load(checkpoint="checkpoint_epoch_9")


@pytest.fixture(scope="module")
def tts(run_dir):
    from kokoro_tpu_torch.inference.tts import KokoroTTS

    return KokoroTTS(str(run_dir), device="cpu", vocoder_type="griffin_lim", max_len=MAX_LEN)


def _read(path):
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_batch_text_to_speech_batched_equals_sequential(tts, tmp_path):
    texts = ["привет мир", LONG_TEXT, "как дела", "кот"]
    assert [len(tts.split_text(t)) for t in texts] == [1, 2, 1, 1]
    tts.batch_text_to_speech(texts, str(tmp_path / "seq"))
    tts.batch_text_to_speech(texts, str(tmp_path / "bat"), batched=True)
    names = [f"output_{i:04d}.wav" for i in range(4)]
    for mode in ("seq", "bat"):
        assert sorted(p.name for p in (tmp_path / mode).iterdir()) == names
    for name in names:
        a, b = _read(tmp_path / "seq" / name), _read(tmp_path / "bat" / name)
        assert a.shape == b.shape and a.size > 0
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 4  # PCM16 of 1e-4


def test_infer_cli(run_dir, tmp_path, monkeypatch):
    from kokoro_tpu_torch.cli.infer import main

    base = ["--model", str(run_dir), "--device", "cpu", "--vocoder", "griffin_lim",
            "--max-len", str(MAX_LEN)]
    assert main([*base, "--text", "привет", "--output", str(tmp_path / "one.wav"),
                 "--profile", str(tmp_path / "trace")]) == 0
    assert _read(tmp_path / "one.wav").size > 0
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))
    lines = tmp_path / "lines.txt"
    lines.write_text("привет\n\nкак дела\nвсё хорошо\n", encoding="utf-8")
    assert main([*base, "--file", str(lines), "--batched", "--weights", "model",
                 "--output-dir", str(tmp_path / "outs")]) == 0
    assert sorted(p.name for p in (tmp_path / "outs").iterdir()) == [
        "output_0000.wav", "output_0001.wav", "output_0002.wav"]
    assert main(["--model", str(tmp_path / "nope"), "--device", "cpu", "--text", "x"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--model", str(run_dir), "--text", "привет"])


# -- torch HiFi-GAN checkpoints -----------------------------------------------------------

SMALL = dict(num_mels=8, upsample_initial_channel=16, upsample_rates=(2, 2, 2, 2),
             upsample_kernel_sizes=(4, 4, 4, 4), resblock_kernel_sizes=(3, 5, 7),
             resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)))


def _torch_hifigan_state(seed, weight_norm=True):
    """A torch HiFi-GAN generator's state dict (its own names, no ``.conv``
    level) with random weights, weight-normed: ``weight_g`` (the per-output
    norm times a random gain) and ``weight_v``."""
    gen = HiFiGANGenerator(HiFiGANConfig(**SMALL))
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, value in gen.state_dict().items():
        theirs = name.replace(".conv.", ".")
        w = 0.3 * torch.randn(value.shape, generator=g)
        if theirs.endswith(".weight") and weight_norm:
            prefix = theirs[: -len(".weight")]
            state[prefix + ".weight_v"] = w
            gain = 0.5 + torch.rand((w.shape[0],) + (1,) * (w.dim() - 1), generator=g)
            state[prefix + ".weight_g"] = gain * w.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        else:
            state[theirs] = w
    return state


@pytest.mark.parametrize("layout", ["weight_norm", "plain", "generator_key"])
def test_pth_vocoder_matches_reference(tmp_path, monkeypatch, layout):
    from kokoro_tpu.inference import vocoder as ref_vocoder
    from kokoro_tpu.models.hifigan import HiFiGANConfig as RefConfig

    state = _torch_hifigan_state(1, weight_norm=layout != "plain")
    path = tmp_path / "g.pth"
    torch.save({"generator": state} if layout == "generator_key" else state, path)
    mel = np.random.default_rng(2).uniform(-9.0, 0.0, (12, 8)).astype(np.float32)
    # both build the universal generator for a .pth; give them the small one
    monkeypatch.setattr(vocoder, "HiFiGANConfig", lambda num_mels: HiFiGANConfig(**SMALL))
    monkeypatch.setattr(ref_vocoder, "HiFiGANConfig", lambda num_mels: RefConfig(**SMALL))
    ours = vocoder.VocoderManager(vocoder_path=str(path), n_mels=8, device="cpu")
    assert ours.vocoder_type == "hifigan"
    theirs = ref_vocoder.VocoderManager(vocoder_path=str(path), n_mels=8)
    assert theirs.vocoder_type == "hifigan"
    got, want = ours.mel_to_audio(mel), np.asarray(theirs.mel_to_audio(mel))
    assert got.shape == want.shape == (12 * 16,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pth_with_unknown_layout_falls_back(tmp_path, caplog):
    path = tmp_path / "odd.pth"
    torch.save({"something": torch.zeros(3)}, path)
    voc = vocoder.VocoderManager(vocoder_path=str(path), n_mels=8, device="cpu")
    assert voc.vocoder_type == "griffin_lim" and voc.hifigan is None
    assert any("Unexpected HiFi-GAN checkpoint layout" in r.getMessage() for r in caplog.records)


# -- POST /profile --------------------------------------------------------------------------

def _post(port, path, payload, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, body=json.dumps(payload).encode())
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def test_profile_endpoint(run_dir, tmp_path):
    from kokoro_tpu_torch.serving import ServeConfig, TTSServer

    def server(**kw):
        return TTSServer.for_model(str(run_dir), device="cpu", vocoder_type="griffin_lim",
                                   max_len=MAX_LEN, config=ServeConfig(port=0), **kw).start()

    plain = server()
    try:
        assert _post(plain.port, "/profile", {"seconds": 1})[0] == 403
    finally:
        plain.stop()
    traced = server(profile_dir=str(tmp_path / "prof"))
    try:
        answers = {}
        first = threading.Thread(target=lambda: answers.update(
            first=_post(traced.port, "/profile", {"seconds": 1.5})))
        first.start()
        time.sleep(0.3)
        assert _post(traced.port, "/profile", {"seconds": 1})[0] == 409
        status, body = _post(traced.port, "/tts", {"text": "привет мир"})
        assert status == 200 and body[:4] == b"RIFF"
        first.join(timeout=120)
        status, body = answers["first"]
        assert status == 200 and json.loads(body)["seconds"] == 1.5
        assert list((tmp_path / "prof").glob("*.pt.trace.json"))
        assert _post(traced.port, "/profile", {"seconds": "x"})[0] == 400
    finally:
        traced.stop()


def test_resume_purges_log_records_past_the_restored_step(run_dir, tmp_path):
    """A crash after the last save leaves records past its step; the resume
    drops them before the resumed steps log again."""
    run = tmp_path / "run"
    shutil.copytree(run_dir, run)
    restored = json.loads((run / "checkpoint_epoch_1" / "metadata.json").read_text())
    step = int(restored["counters"]["host_step"])
    logs = run / "logs" / "metrics.jsonl"
    with open(logs, "a") as f:
        f.write(json.dumps({"tag": "loss/total", "value": 1e9, "step": step + 1}) + "\n")
        f.write(json.dumps({"tag": "loss/total", "value": 0.5, "step": step}) + "\n")
    corpus = run_dir.parent / "corpus"
    trainer = KokoroTrainer(*get_smoke_test_config(**{**SMOKE, "num_epochs": 2},
                                                data_dir=str(corpus), output_dir=str(run)),
                            device="cpu")
    trainer.train()
    assert trainer.start_epoch == 1 and trainer.host_step > step
    records = [json.loads(x) for x in logs.read_text().splitlines() if x.strip()]
    assert {"tag": "loss/total", "value": 0.5, "step": step} in records
    assert not any(r["value"] == 1e9 for r in records)
