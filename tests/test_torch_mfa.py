"""Port's MFA-aligned durations (kokoro_tpu_torch/data/mfa.py, the C++
aligner of kokoro_tpu_torch/native, the dataset's MFA branch, the trainer's
wiring, cli/preprocess.py and cli/precompute.py) against the JAX package on
the same inputs.  Durations are compared for exact equality (the Python DP
and the native one against the reference's Python DP, 240 seeded cases);
features at the tolerances of ``tests/test_torch_data.py``.
"""

import argparse
import logging
import unicodedata
from pathlib import Path

import numpy as np
import pytest

from kokoro_tpu.cli.args import add_training_arguments as ref_add_arguments
from kokoro_tpu.cli.args import create_config_from_args as ref_config_from_args
from kokoro_tpu.cli.precompute import precompute_features as ref_precompute
from kokoro_tpu.cli.preprocess import validate_corpus as ref_validate_corpus
from kokoro_tpu.config import TrainingConfig as RefConfig
from kokoro_tpu.config import get_smoke_test_config
from kokoro_tpu.data import mfa as ref
from kokoro_tpu.data.dataset import RuslanDataset as RefDataset
from kokoro_tpu_torch import native
from kokoro_tpu_torch.cli import args as port_args
from kokoro_tpu_torch.cli.precompute import precompute_features
from kokoro_tpu_torch.cli.preprocess import main as preprocess_main
from kokoro_tpu_torch.cli.preprocess import validate_corpus
from kokoro_tpu_torch.config import get_default_config
from kokoro_tpu_torch.data import mfa
from kokoro_tpu_torch.data.audio_io import save_wav
from kokoro_tpu_torch.data.dataset import RuslanDataset, build_fallback_durations
from kokoro_tpu_torch.data.phonemes import RussianPhonemeProcessor
from kokoro_tpu_torch.data.text_utils import flatten_with_sil
from tests.test_torch_native import PHONES, random_case

ROOT = Path(__file__).resolve().parents[1]
HOP_S = 256 / 22050
MFA_INVERSE = {v: k for k, v in mfa.MFA_PHONE_MAP.items()}  # G2P phone -> an MFA label


def test_tables_and_normalization_match_reference():
    assert mfa.MFA_PHONE_MAP == ref.MFA_PHONE_MAP and mfa.IOTATED == ref.IOTATED
    assert mfa.PROSODY_TOKENS == ref.PROSODY_TOKENS and mfa.LENGTH_MARK == ref.LENGTH_MARK
    rng = np.random.default_rng(0)
    alphabet = list("ptkaoeiuʃʐxjɐɪəsndzlmgc") + ["̪", "̩", "ː", "ʲ"]
    labels = list(mfa.MFA_PHONE_MAP)
    labels += [unicodedata.normalize("NFD", k) for k in mfa.MFA_PHONE_MAP]
    labels += [k + "ː" for k in mfa.MFA_PHONE_MAP]
    labels += ["".join(rng.choice(alphabet, int(rng.integers(1, 4)))) for _ in range(300)]
    for label in labels:
        assert mfa.normalize_mfa_phone(label) == ref.normalize_mfa_phone(label), label
        for g2p in ("s", "t", "a", label, label.rstrip("ː")):
            assert mfa.phones_equivalent(label, g2p) == ref.phones_equivalent(label, g2p)


@pytest.mark.parametrize("chunk", range(8))
def test_align_durations_match_reference_exactly(chunk):
    rng = np.random.default_rng(100 + chunk)
    calls = native.binding.calls
    for _ in range(30):
        mfa_side, text = random_case(rng)
        want = ref.align_durations(mfa_side, text, use_native=False)
        assert mfa.align_durations(mfa_side, text, use_native=False) == want, (mfa_side, text)
        assert mfa.align_durations(mfa_side, text) == want, (mfa_side, text)
        assert len(want) == len(text)
        if text:
            assert sum(want) == sum(f for _, f in mfa_side)
    # the native DP ran each case that had two non-empty sides
    assert native.native_available() and native.binding.calls > calls


def test_native_library_builds_outside_the_package_tree():
    assert native.native_available()
    path = native.library_path()
    assert path.parent == ROOT / "kokoro_tpu_torch" / "build" and path.is_file()
    for where in (ROOT / "kokoro_tpu_torch" / "native", ROOT / "kokoro_tpu_torch" / "csrc"):
        assert not [p for p in where.iterdir() if p.suffix == ".so"], where
    # the JAX package's native directory gains nothing of the port's
    assert not list((ROOT / "kokoro_tpu" / "native").glob("libaligner-*"))


def _textgrid_intervals(rng, phones, total_frames):
    """(xmin, xmax, label) phones with leading and trailing silence whose
    frame counts sum to ``total_frames``, each at least 2 frames long (so
    that ``int()`` of its frame count is at least 1)."""
    n = len(phones) + 2
    cuts = np.sort(rng.choice(np.arange(1, total_frames - n), n - 1, replace=False))
    edges = np.concatenate([[0], cuts + np.arange(1, n), [total_frames]]) * HOP_S
    labels = ["sil"] + list(phones) + [""]
    return [(float(edges[i]), float(edges[i + 1]), labels[i]) for i in range(n)]


def test_textgrids_parse_align_and_validate_like_reference(tmp_path):
    rng = np.random.default_rng(3)
    align = tmp_path / "alignments"
    align.mkdir()
    stems = []
    for i in range(6):
        text = [str(p) for p in rng.choice(PHONES, int(rng.integers(3, 12)))]
        mfa_phones = [MFA_INVERSE.get(p, p) for p in text]
        mfa_phones.insert(1, "spn")
        intervals = _textgrid_intervals(rng, mfa_phones, int(rng.integers(40, 200)))
        words = [(intervals[1][0], intervals[-2][1], "слово")]
        mfa.write_textgrid(align / f"u{i}.TextGrid", intervals, words)
        stems.append((f"u{i}", text))
    for stem, text in stems:
        ours, ours_words = mfa.parse_textgrid(align / f"{stem}.TextGrid")
        theirs, theirs_words = ref.parse_textgrid(align / f"{stem}.TextGrid")
        assert ours_words == theirs_words and len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert (a.phoneme, a.start_time, a.end_time, a.duration_frames) == (
                b.phoneme, b.start_time, b.end_time, b.duration_frames)
        port_mfa = mfa.MFAIntegration(alignment_dir=str(align))
        ref_mfa = ref.MFAIntegration(alignment_dir=str(align))
        got = port_mfa.get_aligned_durations(stem, text)
        assert got == ref_mfa.get_aligned_durations(stem, text) and len(got) == len(text)
    meta = tmp_path / "metadata.csv"
    meta.write_text("\n".join(f"{s}|текст" for s, _ in stems) + "\nmissing|нет\n",
                    encoding="utf-8")
    stats = mfa.MFAIntegration(alignment_dir=str(align)).validate_alignments(str(meta))
    assert stats == ref.MFAIntegration(alignment_dir=str(align)).validate_alignments(str(meta))
    assert stats["failed_file_list"] == ["missing"] and stats["aligned_files"] == 6


def test_mfa_binary_missing_paths(tmp_path, monkeypatch):
    integ = mfa.MFAIntegration(alignment_dir=str(tmp_path / "a"))
    monkeypatch.setattr(integ, "mfa_binary", None)
    assert not integ.available and integ.run_alignment(str(tmp_path)) is False
    assert integ.download_models() is False
    monkeypatch.setattr(mfa.MFAIntegration, "_find_mfa_binary", staticmethod(lambda: None))
    with pytest.raises(RuntimeError, match="MFA binary not found"):
        mfa.setup_mfa_for_corpus(str(tmp_path), str(tmp_path / "out"))
    corpus = _corpus(tmp_path / "c", 2)
    staged = integ.prepare_corpus(str(corpus), str(tmp_path / "staging"))
    assert sorted(p.name for p in staged.iterdir()) == ["c0.txt", "c0.wav", "c1.txt", "c1.wav"]


# -- the corpus, its alignments, the dataset --------------------------------------------

def _corpus(root: Path, n=3, seconds=0.4):
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        t = np.arange(int(22050 * (seconds + 0.15 * i))) / 22050
        audio = 0.4 * np.sin(2 * np.pi * (160 + 30 * i) * t).astype(np.float32)
        audio += 0.02 * rng.normal(size=len(t)).astype(np.float32)
        save_wav(root / "wavs" / f"c{i}.wav", audio, 22050)
        lines.append(f"c{i}|привет мир {['как дела', 'всё хорошо', 'пока'][i % 3]}")
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    return root


def _align_corpus(corpus: Path, align: Path, skip=(), no_pauses=()):
    """A TextGrid per utterance (but ``skip``): the G2P phones in MFA's
    inventory, iotated vowels split into j + vowel, a pause per inter-word
    ``<sil>`` (none for the stems in ``no_pauses``: those ``<sil>`` get 0
    frames, then the dataset's floor of 1), leading and trailing silence;
    frames sum to the wav's frames."""
    processor = RussianPhonemeProcessor()
    rng = np.random.default_rng(5)
    align.mkdir(parents=True, exist_ok=True)
    for line in (corpus / "metadata.csv").read_text(encoding="utf-8").splitlines():
        stem, text = line.split("|")
        if stem in skip:
            continue
        seq = flatten_with_sil(processor.process_text(text), processor.phoneme_to_id)
        phones = []
        for p in seq:
            if p == "<sil>":
                if stem not in no_pauses:
                    phones.append("")
                continue
            if p in mfa.IOTATED:
                phones += ["j", mfa.IOTATED[p]]
            else:
                phones.append(MFA_INVERSE.get(p, p))
        import wave
        with wave.open(str(corpus / "wavs" / f"{stem}.wav")) as w:
            frames = w.getnframes() // 256 + 1
        mfa.write_textgrid(align / f"{stem}.TextGrid", _textgrid_intervals(rng, phones, frames))


@pytest.fixture(scope="module")
def aligned_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mfa_corpus")
    corpus = _corpus(root / "corpus", n=4, seconds=1.0)
    _align_corpus(corpus, root / "alignments", skip=("c3",), no_pauses=("c2",))
    return corpus, root / "alignments"


@pytest.mark.parametrize("perturb", [False, True], ids=["plain", "speed_perturbed"])
def test_dataset_items_with_alignments_match_reference(aligned_corpus, tmp_path, perturb):
    corpus, align = aligned_corpus
    kw = dict(data_dir=str(corpus), use_speed_perturbation=perturb, speed_perturb_prob=1.0,
              max_seq_length=384, mfa_alignment_dir=str(align))
    mcfg, cfg = get_default_config(feature_cache_dir=str(tmp_path / "torch"), **kw)
    ref_cfg = RefConfig(feature_cache_dir=str(tmp_path / "jax"), **kw)
    ours = RuslanDataset(str(corpus), mcfg, cfg, mfa=mfa.MFAIntegration(str(align)))
    theirs = RefDataset(str(corpus), ref_cfg, mfa=ref.MFAIntegration(str(align)))
    aligned = 0
    for i in range(len(theirs)):
        a = ours.get_features(i, np.random.default_rng(i))
        b = theirs.get_features(i, np.random.default_rng(i))
        assert a["audio_file"] == b["audio_file"]
        for k in ("phoneme_indices", "phoneme_durations", "mel_length", "phoneme_length"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        durs, frames = a["phoneme_durations"], int(a["mel_length"])
        assert durs.min() >= 1
        if a["audio_file"] != "c2":
            assert durs.sum() == frames
        elif not perturb:  # its 0-frame <sil> were floored to 1 after the reconciliation
            assert durs.sum() > frames
        fallback = build_fallback_durations(len(durs), frames)
        if a["audio_file"] == "c3":  # no TextGrid: the fallback
            assert np.array_equal(durs, fallback)
        else:
            aligned += not np.array_equal(durs, fallback)
        close = np.isclose(a["mel_spec"], b["mel_spec"], rtol=1e-3, atol=2e-2)
        lin = np.isclose(np.exp(a["mel_spec"]), np.exp(b["mel_spec"]), rtol=1e-3, atol=1e-6)
        assert (close | lin).all()
        np.testing.assert_allclose(a["energy"], b["energy"], rtol=1e-3, atol=1e-3)
    assert aligned == 3


def test_trainer_uses_alignments_or_falls_back(aligned_corpus, tmp_path, caplog):
    from kokoro_tpu_torch.training.trainer import KokoroTrainer

    corpus, align = aligned_corpus
    small = dict(hidden_dim=32, n_encoder_layers=1, n_decoder_layers=1, n_heads=2,
                 encoder_ff_dim=32, decoder_ff_dim=32, variance_filter_size=16,
                 use_dynamic_batching=False, batch_size=2, use_speed_perturbation=False,
                 data_dir=str(corpus), max_seq_length=256, mel_bucket_sizes=(128, 256),
                 phoneme_bucket_sizes=(32, 64), validation_split=0.25)
    with caplog.at_level(logging.WARNING):
        trainer = KokoroTrainer(*get_default_config(
            **small, output_dir=str(tmp_path / "a"), mfa_alignment_dir=str(tmp_path / "none"),
            feature_cache_dir=str(tmp_path / "fa")), device="cpu")
    assert trainer.train_dataset.mfa is None
    assert any("alignment dir" in r.getMessage() for r in caplog.records)
    trainer = KokoroTrainer(*get_default_config(
        **small, output_dir=str(tmp_path / "b"), mfa_alignment_dir=str(align),
        feature_cache_dir=str(tmp_path / "fb")), device="cpu")
    assert trainer.train_dataset.mfa.alignment_dir == align
    item = next(trainer.train_dataset.get_features(i, np.random.default_rng(0))
                for i in range(len(trainer.train_dataset))
                if trainer.train_dataset.samples[i]["audio_file"] in ("c0", "c1"))
    stem = item["audio_file"]
    seq = flatten_with_sil(*(lambda p: (p.process_text(item["text"]), p.phoneme_to_id))(
        RussianPhonemeProcessor()))
    want = mfa.MFAIntegration(str(align)).get_aligned_durations(stem, seq)
    got = item["phoneme_durations"]
    assert np.array_equal(got[:-1], np.maximum(want[:-1], 1)) and got.sum() == item["mel_length"]
    _, no_mfa = get_default_config(use_mfa=False, mfa_alignment_dir=str(align),
                                   data_dir=str(corpus))
    assert not no_mfa.use_mfa


# -- the command lines -------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ["--no-mfa", "--precompute-features", "--epochs", "2"],
    ["--mfa-alignment-dir", "al", "--seed", "7", "--no-speed-perturbation"],
], ids=["defaults", "no_mfa_precompute", "alignment_dir"])
def test_training_arguments_match_reference(argv, tmp_path):
    argv = ["--data-dir", str(tmp_path), *argv]
    ours_p, ref_p = argparse.ArgumentParser(), argparse.ArgumentParser()
    port_args.add_training_arguments(ours_p)
    ref_add_arguments(ref_p)
    mcfg, cfg = port_args.create_config_from_args(ours_p.parse_args(argv))
    theirs = ref_config_from_args(ref_p.parse_args(argv))
    for field in ("use_mfa", "mfa_alignment_dir", "mfa_acoustic_model", "mfa_dictionary",
                  "precompute_features", "num_epochs", "seed", "use_speed_perturbation",
                  "data_dir", "feature_cache_dir"):
        if field == "feature_cache_dir":  # each package keeps its own cache directory
            assert Path(getattr(cfg, field)).parent == Path(getattr(theirs, field)).parent
            continue
        assert getattr(cfg, field) == getattr(theirs, field), field


def test_validate_corpus_matches_reference(tmp_path):
    cases = {"valid": _corpus(tmp_path / "v"), "no_meta": tmp_path / "m",
             "no_wavs": tmp_path / "w", "no_match": tmp_path / "x"}
    (cases["no_meta"] / "wavs").mkdir(parents=True)
    cases["no_wavs"].mkdir()
    (cases["no_wavs"] / "metadata.csv").write_text("a|б\n", encoding="utf-8")
    (cases["no_match"] / "wavs").mkdir(parents=True)
    (cases["no_match"] / "metadata.csv").write_text("ghost|текст\n", encoding="utf-8")
    for name, path in cases.items():
        assert validate_corpus(str(path)) == ref_validate_corpus(str(path)), name
    assert validate_corpus(str(cases["valid"]))["matched"] == 3


def test_preprocess_validate_only_reports_coverage(aligned_corpus, tmp_path, capsys):
    corpus, align = aligned_corpus
    out = align.parent
    assert preprocess_main(["--corpus", str(corpus), "--output", str(out),
                            "--validate-only"]) == 0
    import json
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    meta = corpus / "metadata.csv"
    assert printed == ref.MFAIntegration(str(align)).validate_alignments(str(meta))
    assert printed["alignment_rate"] == 0.75 and printed["failed_file_list"] == ["c3"]
    assert preprocess_main(["--corpus", str(tmp_path / "empty"), "--skip-mfa"]) == 1
    assert preprocess_main(["--corpus", str(corpus), "--skip-mfa"]) == 0


def test_precompute_stats_match_reference(aligned_corpus, tmp_path):
    corpus, align = aligned_corpus
    mcfg, cfg = get_default_config(data_dir=str(corpus), use_speed_perturbation=False,
                                   feature_cache_dir=str(tmp_path / "torch"),
                                   mfa_alignment_dir=str(align), max_seq_length=384)
    ref_cfg = get_smoke_test_config(data_dir=str(corpus), use_speed_perturbation=False,
                                    use_mfa=True, feature_cache_dir=str(tmp_path / "jax"),
                                    mfa_alignment_dir=str(align), max_seq_length=384)
    keys = ("total", "computed", "skipped", "failed", "cache_version")
    for _ in range(2):  # fill, then every entry up to date
        ours = precompute_features(mcfg, cfg, device="cpu")
        theirs = ref_precompute(ref_cfg)
        assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}
    assert ours["skipped"] == 4 and ours["computed"] == 0
    for path in sorted((tmp_path / "jax").glob("*.npz")):
        with np.load(path) as a, np.load(tmp_path / "torch" / path.name) as b:
            assert np.array_equal(a["phoneme_durations"], b["phoneme_durations"])


# -- log purge at resume, token averages --------------------------------------------------

def test_purge_events_after_matches_reference(tmp_path):
    import json
    import shutil

    from torch.utils.tensorboard import SummaryWriter

    from kokoro_tpu.training.tb_events import purge_events_after as ref_purge
    from kokoro_tpu_torch.training.tb_events import purge_events_after

    src = tmp_path / "src"
    writer = SummaryWriter(str(src))
    for step in range(1, 11):
        writer.add_scalar("loss/total", 1.0 / step, step)
    writer.close()
    lines = [{"tag": "loss/total", "value": 0.5, "step": s} for s in (3, 7, 8, 12)]
    (src / "metrics.jsonl").write_text(
        "\n".join(json.dumps(x) for x in lines) + "\nnot json\n", encoding="utf-8")
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    shutil.copytree(src, ours)
    shutil.copytree(src, theirs)
    stats = purge_events_after(ours, 7)
    assert stats == ref_purge(theirs, 7)
    assert sorted(stats.values()) == [2, 3]  # jsonl: 8, 12; tfevents: 8, 9, 10
    for a in sorted(ours.iterdir()):
        assert a.read_bytes() == (theirs / a.name).read_bytes(), a.name
    kept = [json.loads(x)["step"] for x in (ours / "metrics.jsonl").read_text().splitlines()
            if x.startswith("{")]
    assert kept == [3, 7]
    assert purge_events_after(tmp_path / "absent", 1) == {}


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_average_by_duration_matches_reference(masked):
    import jax.numpy as jnp
    import torch

    from kokoro_tpu.ops.lengths import average_by_duration as ref_average
    from kokoro_tpu_torch.ops.lengths import average_by_duration

    rng = np.random.default_rng(7)
    B, L, T = 3, 9, 40
    durations = rng.integers(0, 6, (B, L)).astype(np.int32)
    durations[1, 4:] = 0
    values = rng.standard_normal((B, T)).astype(np.float32)
    mask = (np.arange(L)[None, :] >= np.array([[9], [4], [7]])) if masked else None
    got = average_by_duration(torch.from_numpy(values), torch.from_numpy(durations),
                              None if mask is None else torch.from_numpy(mask))
    want = ref_average(jnp.asarray(values), jnp.asarray(durations),
                       None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
