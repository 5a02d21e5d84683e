"""Port's serving path on the CPU: the G2P copy against the reference's,
``KokoroTTS`` on a tiny model directory written by ``convert.save_model_dir``
(with a small HiFi-GAN that the reference's ``export_hifigan_npz`` wrote,
int8 with its ``__config__`` blob; the committed universal V1 is held to the
reference in test_torch_vocoder.py), and ``TTSServer`` over HTTP
(``device="cpu"``): coalescing, power-of-two group padding, failure
isolation, WAV framing."""

import http.client
import json
import wave
from concurrent.futures import ThreadPoolExecutor
from io import BytesIO

import numpy as np
import pytest
import torch

from kokoro_tpu.data import text_utils as ref_text_utils
from kokoro_tpu.data.phonemes import RussianPhonemeProcessor as RefProcessor
from kokoro_tpu.inference.vocoder import export_hifigan_npz
from kokoro_tpu.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from kokoro_tpu_torch.config import KokoroConfig
from kokoro_tpu_torch.convert import model_metadata, save_model_dir
from kokoro_tpu_torch.data import text_utils
from kokoro_tpu_torch.data.audio_io import save_wav
from kokoro_tpu_torch.data.phonemes import RussianPhonemeProcessor, load_processor_json
from kokoro_tpu_torch.inference.tts import KokoroTTS
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.serving import BatchScheduler, KokoroPipeline, ServeConfig, TTSServer
from tests.torch_parity import init_flax

SENTENCES = [
    "Привет, мир!",
    "Сегодня хорошая погода, и мы идём гулять в парк.",
    "Что ты делаешь? Я читаю книгу о 25 кошках и 3 собаках.",
    "Мягкий хлеб лежит на столе, а молоко стоит в холодильнике.",
    "Ёжик быстро бежал по лесу; солнце светило ярко.",
    "В 2024 году было 365 дней и 12 месяцев, т.е. целый год.",
]
MAX_LEN = 48
# hop 8 * 8 * 4 = 256 samples per frame, as the universal V1 it stands in for
SMALL_VOCODER = HiFiGANConfig(
    upsample_initial_channel=16, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))


def test_g2p_copy_matches_reference():
    ours, ref = RussianPhonemeProcessor(), RefProcessor()
    assert ours.phoneme_to_id == ref.phoneme_to_id
    assert ours.get_vocab_size() == ref.get_vocab_size() == 59
    for s in SENTENCES:
        raw, raw_ref = ours.process_text(s), ref.process_text(s)
        assert [(w, p, i.position, c) for w, p, i, c in raw] == \
            [(w, p, i.position, c) for w, p, i, c in raw_ref]
        seq = text_utils.flatten_with_sil(raw, ours.phoneme_to_id)
        assert seq == ref_text_utils.flatten_with_sil(raw_ref, ref.phoneme_to_id)
        assert text_utils.stress_indices_with_sil(raw, ours.phoneme_to_id) == \
            ref_text_utils.stress_indices_with_sil(raw_ref, ref.phoneme_to_id)


def test_processor_json_round_trip(tmp_path):
    p = RussianPhonemeProcessor()
    path = tmp_path / "proc.json"
    path.write_text(json.dumps(p.to_dict(), ensure_ascii=False), encoding="utf-8")
    q = load_processor_json(path)
    assert q.phoneme_to_id == p.phoneme_to_id
    assert q.process_text(SENTENCES[1]) == p.process_text(SENTENCES[1])


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfg = KokoroConfig(vocab_size=59, hidden_dim=64, n_encoder_layers=1, n_decoder_layers=1,
                       n_heads=4, encoder_ff_dim=96, decoder_ff_dim=96, variance_filter_size=32)
    model = KokoroModel(cfg).init_weights(torch.Generator().manual_seed(0))
    path = save_model_dir(
        tmp_path_factory.mktemp("model"), model.state_dict(), model_metadata(cfg),
        RussianPhonemeProcessor().to_dict(),
        {"max_seq_length": MAX_LEN, "stop_token_threshold": 0.5,
         "post_expected_stop_threshold": 0.2},
    )
    vocoder = init_flax(HiFiGANGenerator(SMALL_VOCODER), np.zeros((1, 4, 80), np.float32))
    export_hifigan_npz(vocoder, path / "vocoder.npz", config=SMALL_VOCODER, quantize="int8")
    return path


@pytest.fixture(scope="module")
def tts(model_dir):
    return KokoroTTS(str(model_dir), device="cpu")


def test_tts_loads_model_dir(tts):
    assert tts.max_frames == MAX_LEN
    assert tts.vocoder.vocoder_type == "hifigan"
    assert tts.vocoder.hifigan.config.upsample_rates == SMALL_VOCODER.upsample_rates
    assert next(tts.model.parameters()).device.type == "cpu"


def test_encode_pads_to_phoneme_bucket(tts):
    enc = tts._encode_chunk(SENTENCES[0])
    L = int((~enc["text_padding_mask"]).sum())
    assert enc["phoneme_indices"].shape == (1, 32) and 0 < L <= 32
    assert (enc["phoneme_indices"][0, L:] == 0).all()


def test_text_to_speech(tts, tmp_path):
    out = tmp_path / "out.wav"
    audio = tts.text_to_speech(SENTENCES[0] + " " + SENTENCES[1], str(out))
    assert audio.ndim == 1 and audio.size > 0 and np.isfinite(audio).all()
    with wave.open(str(out)) as w:
        assert w.getframerate() == 22050 and w.getnframes() == audio.size


def test_synthesize_mel_batch_matches_single(tts):
    texts = [SENTENCES[0], SENTENCES[3], ""]
    mels = tts.synthesize_mel_batch(texts)
    assert mels[2] is None
    single = tts.synthesize_mel(SENTENCES[0])
    np.testing.assert_allclose(mels[0], single, rtol=1e-4, atol=1e-4)


def test_pipeline_pads_groups_to_power_of_two(tts):
    pipe = KokoroPipeline(tts)
    rows = []
    real = tts.generate_batch
    tts.generate_batch = lambda encs: (rows.append(len(encs)), real(encs))[1]
    try:
        encs = [pipe.encode(s)[1] for s in ("привет мир", "мир привет", "дом кот")]
        out = pipe.decode_batch(32, encs)
    finally:
        del tts.generate_batch
    assert rows == [4] and len(out) == 3
    for res in out:  # each waveform is its own trimmed frames x hop
        assert res.audio.size == res.frames * 256 and 0 < res.frames <= res.generated_frames


def test_failure_is_isolated_to_its_dispatch(tts):
    pipe = KokoroPipeline(tts)
    real = pipe.decode_batch

    def decode(bucket, encs):
        if bucket == 64:
            raise RuntimeError("boom")
        return real(bucket, encs)

    sched = BatchScheduler(pipe.encode, decode, ServeConfig(port=0)).start()
    try:
        long_text = SENTENCES[3]  # bucket 64
        bad, good = sched.submit(long_text), sched.submit("привет")
        assert good.result(timeout=120) is not None
        with pytest.raises(RuntimeError, match="boom"):
            bad.result(timeout=120)
        assert sched.stats["decode_failures"] == 1
    finally:
        sched.stop()


def test_http_round_trip_coalesces(model_dir):
    server = TTSServer.for_model(
        str(model_dir), device="cpu", max_len=MAX_LEN,
        config=ServeConfig(port=0, max_batch_delay_ms=300.0),
    ).start()
    try:
        def post(text):
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
            conn.request("POST", "/tts", body=json.dumps({"text": text}).encode())
            resp = conn.getresponse()
            return resp.status, resp.getheader("X-Mel-Frames"), resp.read()

        texts = ["привет мир", "кот дома", "мир дом", SENTENCES[3]]
        with ThreadPoolExecutor(len(texts)) as pool:
            answers = list(pool.map(post, texts))
        for status, frames, body in answers:
            assert status == 200 and body[:4] == b"RIFF" and body[8:12] == b"WAVE"
            with wave.open(BytesIO(body)) as w:
                assert w.getnframes() == int(frames) * 256 > 0
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["requests"] == 4 and stats["dispatches"] < 4
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read()) == {"ok": True}
    finally:
        server.stop()


def test_save_wav_writes_pcm16(tmp_path):
    path = tmp_path / "x.wav"
    save_wav(path, np.array([0.0, 2.0, -1.0], np.float32), 16000)
    with wave.open(str(path)) as w:
        frames = np.frombuffer(w.readframes(3), "<i2")
    assert w.getsampwidth() == 2 and frames.tolist() == [0, 32767, -16383]
