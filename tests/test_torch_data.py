"""Port's data pipeline (kokoro_tpu_torch/data/{batching,dataset}.py)
against the JAX package's on the same inputs: the batch plan of the bucket
sampler (identical, every pack mode and order), ``collate`` (identical
arrays), the train/val split (identical) and dataset items of a tiny
synthetic corpus (indices, stress ids, durations and lengths identical;
log-mel, pitch and energy at the feature tolerances of
``tests/test_torch_features.py``: log-mel cells 1e-3 rel / 2e-2 abs or linear
1e-3 rel / 1e-6 abs, pitch voicing agreement > 0.93 and voiced RMSE < 0.02,
energy 1e-3).
"""

import numpy as np
import pytest

from kokoro_tpu.config import TrainingConfig as RefConfig
from kokoro_tpu.data import batching as ref_batching
from kokoro_tpu.data.dataset import RuslanDataset as RefDataset
from kokoro_tpu.data.dataset import train_val_split as ref_split
from kokoro_tpu_torch.config import get_default_config
from kokoro_tpu_torch.data import batching
from kokoro_tpu_torch.data.audio_io import save_wav
from kokoro_tpu_torch.data.dataset import RuslanDataset, train_val_split


def _lengths(n, seed):
    rng = np.random.default_rng(seed)
    return [(int(t), int(p)) for t, p in zip(rng.integers(60, 1800, n), rng.integers(8, 250, n))]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(batch_order="shape_major", carry_tail=True, pack_mode="bucket", batch_quantum=8,
         max_frames_per_batch=30000, max_batch_size=16),
    dict(max_frames_per_batch=18000, max_batch_size=12, batch_quantum=12,
         mel_buckets=(1408,), phoneme_buckets=(256,)),
], ids=["default", "preset", "long"])
def test_batch_plan_is_the_references(kw):
    lengths = _lengths(157, seed=len(kw))
    kw.setdefault("mel_buckets", (256, 512, 768, 1024, 1280, 1536, 1800))
    kw.setdefault("phoneme_buckets", (32, 64, 96, 128, 192, 256))
    ours = batching.FrameBudgetBatcher(lengths, seed=42, **kw)
    ref = ref_batching.FrameBudgetBatcher(lengths, seed=42, **kw)
    for epoch in (0, 1, 5):
        assert ours.build_batches(epoch) == ref.build_batches(epoch)
    assert (batching.FixedSizeBatcher(lengths, 16).build_batches(2)
            == ref_batching.FixedSizeBatcher(lengths, 16).build_batches(2))
    for q in (None, 8, 12):
        assert (batching.effective_batch_quantum(q, 12)
                == ref_batching.effective_batch_quantum(q, 12))


def test_collate_is_the_references():
    rng = np.random.default_rng(1)
    feats = []
    for t, p in [(300, 40), (517, 77), (120, 33)]:
        feats.append({
            "mel_spec": rng.standard_normal((t, 80)).astype(np.float32),
            "phoneme_indices": rng.integers(1, 59, p).astype(np.int32),
            "stress_indices": rng.integers(0, 3, p).astype(np.int32),
            "phoneme_durations": rng.integers(1, 9, p).astype(np.int32),
            "pitch": rng.random(t).astype(np.float32), "energy": rng.random(t).astype(np.float32),
            "mel_length": np.int32(t), "phoneme_length": np.int32(p),
        })
    _, cfg = get_default_config()
    for kw in (dict(), dict(pad_batch_to=8), dict(pad_mel_to=1024, pad_phoneme_to=100)):
        ours = batching.collate(feats, cfg, 80, **kw)
        ref = ref_batching.collate(feats, RefConfig(), **kw)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k


def test_split_is_the_references():
    for n, split in ((26, 0.1), (4, 0.25), (1000, 0.1)):
        assert train_val_split(n, split, seed=42) == ref_split(n, split, seed=42)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data_corpus")
    rng = np.random.default_rng(2)
    texts = ["привет мир", "как дела сегодня", "всё хорошо", "пока", "погода ясная"]
    lines = []
    for i, text in enumerate(texts):
        n = int(22050 * (0.6 + 0.25 * i))
        tt = np.arange(n) / 22050
        f0 = 120 + 20 * i + 10 * np.sin(2 * np.pi * tt)
        audio = 0.5 * np.sin(2 * np.pi * np.cumsum(f0) / 22050) + 0.02 * rng.standard_normal(n)
        save_wav(root / "wavs" / f"u{i}.wav", audio.astype(np.float32), 22050)
        lines.append(f"u{i}|{text}")
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    return root


def test_dataset_items_are_the_references(corpus, tmp_path):
    kw = dict(data_dir=str(corpus), use_speed_perturbation=False, max_seq_length=384)
    mcfg, cfg = get_default_config(feature_cache_dir=str(tmp_path / "torch_cache"), **kw)
    ref_cfg = RefConfig(feature_cache_dir=str(tmp_path / "jax_cache"), use_mfa=False, **kw)
    train_idx, _ = train_val_split(5, 0.2)
    ours = RuslanDataset(str(corpus), mcfg, cfg, indices=train_idx)
    ref = RefDataset(str(corpus), ref_cfg, indices=train_idx)
    assert len(ours) == len(ref) == 4
    for i in range(len(ref)):
        assert ours.lengths(i) == ref.lengths(i)
        a = ours.get_features(i, np.random.default_rng(0))
        b = ref.get_features(i, np.random.default_rng(0))
        assert a["audio_file"] == b["audio_file"] and a["text"] == b["text"]
        for k in ("phoneme_indices", "stress_indices", "phoneme_durations", "mel_length",
                  "phoneme_length"):
            assert np.array_equal(a[k], b[k]), k
        close = np.isclose(a["mel_spec"], b["mel_spec"], rtol=1e-3, atol=2e-2)
        lin = np.isclose(np.exp(a["mel_spec"]), np.exp(b["mel_spec"]), rtol=1e-3, atol=1e-6)
        assert (close | lin).all()
        np.testing.assert_allclose(a["energy"], b["energy"], rtol=1e-3, atol=1e-3)
        assert np.mean((a["pitch"] > 0) == (b["pitch"] > 0)) > 0.93
        both = (a["pitch"] > 0) & (b["pitch"] > 0)
        if both.sum() > 10:
            assert np.sqrt(np.mean((a["pitch"][both] - b["pitch"][both]) ** 2)) < 0.02
    # the cache serves the same item again, from disk in a fresh dataset
    again = RuslanDataset(str(corpus), mcfg, cfg, indices=train_idx)
    c = again.get_features(0, np.random.default_rng(0))
    d = ours.get_features(0, np.random.default_rng(0))
    assert again.cache_misses == 0
    for k in ("mel_spec", "pitch", "energy", "phoneme_indices"):
        assert np.array_equal(c[k], d[k])
