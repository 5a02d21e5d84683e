"""The port's headline benchmarks (``kokoro_tpu_torch/bench.py``,
``kokoro_tpu_torch/bench_inference.py``) against the repository's
``bench.py`` and ``bench_inference.py``, loaded by path, on the CPU at small
widths.

* ``_build_bench_corpus`` writes the reference's corpus byte for byte:
  ``metadata.csv`` and a sha256 of every WAV.
* Both payloads carry the reference's keys, read by AST from the
  reference's ``json.dumps`` calls (its mains cannot run small): the
  training line with the end-to-end phase's ``buckets``, ``shape_steps``
  and ``padding_efficiency``; the synthesis line with ``detail``,
  ``batched`` and ``batched_32``.
* The port trainer's shape census equals the JAX trainer's (``scan_steps=1``)
  over one epoch of the quality run's parity corpus and configuration
  (``tests/torch_quality_parity.py``): the same keys, the same steps.
* ``shape_steps`` and ``padding_efficiency`` from a known census.
* A failed end-to-end phase prints ``end_to_end: 0.0`` beside the
  compute-only value and exits 1; a sound one exits 0 and writes ``--out``.
* A 16-frame synthesis run decodes the forced length on every row, names
  the committed HiFi-GAN, and fails on any other length.
* The committed card runs (``bench_h100.json``, ``bench_inference_h100.json``)
  name the card, carry the reference's keys and positive rates.
"""

import ast
import hashlib
import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

from kokoro_tpu_torch import bench, bench_inference

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TINY = dict(hidden_dim=64, n_encoder_layers=2, n_decoder_layers=2, n_heads=4,
            encoder_ff_dim=128, decoder_ff_dim=128, variance_filter_size=32)


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dict_keys(node):
    """The keys of a dict literal, nested dicts as ``outer.inner``; a
    ``**spread`` entry is skipped."""
    keys = set()
    for k, v in zip(node.keys, node.values):
        if k is None:
            continue
        keys.add(k.value)
        if isinstance(v, ast.Dict):
            keys |= {f"{k.value}.{inner}" for inner in _dict_keys(v)}
    return keys


def _reference_payload_keys(name):
    """The keys the reference's ``json.dumps`` call prints (one call)."""
    tree = ast.parse((ROOT / f"{name}.py").read_text(encoding="utf-8"))
    found = [_dict_keys(node.args[0]) for node in ast.walk(tree)
             if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
             and node.args and isinstance(node.args[0], ast.Dict)]
    assert len(found) == 1, name
    return found[0]


def _reference_e2e_keys():
    """The keys of ``bench_end_to_end``'s returned dict in the reference,
    which its main spreads into the line after popping ``frames_per_sec``."""
    tree = ast.parse((ROOT / "bench.py").read_text(encoding="utf-8"))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "bench_end_to_end")
    ret = [n.value for n in ast.walk(fn) if isinstance(n, ast.Return)]
    return _dict_keys(ret[-1]) - {"frames_per_sec"}


def _payload_keys(payload):
    keys = set()
    for k, v in payload.items():
        keys.add(k)
        if isinstance(v, dict) and k != "shape_steps":
            keys |= {f"{k}.{inner}" for inner in v}
    return keys


def _corpus_digest(root: Path):
    wavs = sorted((root / "wavs").glob("*.wav"))
    return ((root / "metadata.csv").read_bytes(),
            [(p.name, hashlib.sha256(p.read_bytes()).hexdigest()) for p in wavs])


def test_bench_corpus_is_the_references(tmp_path):
    bench._build_bench_corpus(tmp_path / "port")
    _reference("bench")._build_bench_corpus(tmp_path / "ref")
    port, ref = _corpus_digest(tmp_path / "port"), _corpus_digest(tmp_path / "ref")
    assert len(port[1]) == 480 and port[0].decode("utf-8").count("\n") == 479
    assert port == ref


def test_constants_are_the_references():
    ref = _reference("bench")
    assert bench.BASELINE_FRAMES_PER_SEC == ref.BASELINE_FRAMES_PER_SEC == 18000.0
    assert issubclass(bench.E2ETimeout, Exception)
    src = (ROOT / "bench.py").read_text(encoding="utf-8")
    # the reference's compute-only batch, steps a call and timed calls
    assert (bench.B, bench.L, bench.T, bench.K) == (32, 96, 512, 16)
    assert "B, L, T, M = 32, 96, 512, config.n_mels" in src and "K = 16" in src
    assert (bench.WARM_CALLS, bench.TIMED_CALLS, bench.VOCAB) == (2, 4, 128)
    assert "n_calls = 4" in src and "for i in range(2):" in src and "VOCAB = 128" in src
    ref_inf = (ROOT / "bench_inference.py").read_text(encoding="utf-8")
    assert "L, MAX_FRAMES = 128, 1024" in ref_inf and "VOCAB = 128" in ref_inf
    assert (bench_inference.L, bench_inference.MAX_FRAMES, bench_inference.VOCAB) == (
        128, 1024, 128)
    assert bench_inference.STREAMS == (8, 32) and bench_inference.VOCODE_CHUNK == 8
    assert bench_inference.HIFIGAN_WEIGHTS == ROOT / "docs" / "hifigan_v1_int8.npz"


def test_e2e_overrides_are_the_references_but_scan_steps():
    """Every override of the reference's end-to-end phase but ``scan_steps``
    (read from its ``base = dict(...)`` literal), at the reference's values;
    the port's preset takes each of them."""
    from kokoro_tpu_torch.config import get_high_performance_config

    tree = ast.parse((ROOT / "bench.py").read_text(encoding="utf-8"))
    call = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "base")
    ref = {kw.arg: kw.value for kw in call.keywords}
    port = bench.e2e_overrides(Path("c"), Path("o"))
    assert set(ref) - set(port) == {"scan_steps"} and set(port) <= set(ref)
    for name, node in ref.items():
        if name not in ("data_dir", "output_dir", "scan_steps"):
            value = eval(compile(ast.Expression(node), "bench.py", "eval"))  # 10**9, tuples
            assert port[name] == value, name
    _, cfg = get_high_performance_config(**port)
    assert cfg.mel_bucket_sizes == port["mel_bucket_sizes"] and cfg.max_batch_size == 32


def test_census_summary_from_a_known_census():
    census = {((32, 512, 80), 1): 3, ((16, 896, 80), 1): 2, ((2, 8, 432, 80), 1): 1}
    steps, eff = bench.census_summary(census, total_frames=20000, epochs=2)
    assert steps == {"B32xT512xk1": 3, "B16xT896xk1": 2, "B8xT432xk1": 1}
    padded = 32 * 512 * 3 + 16 * 896 * 2 + 8 * 432
    assert eff == round(40000 / padded, 3)
    assert bench.census_summary({}, 10, 1) == ({}, 10.0)


def test_census_matches_the_jax_trainer(tmp_path, monkeypatch):
    """One epoch of each trainer over the parity corpus, configuration and
    seed: the port's ``_shape_counts`` equals the JAX trainer's at
    ``scan_steps=1``.  Both assembled batches carry the leading microbatch
    axis of two accumulated microbatches, so the keys agree whole (the
    reference's key would gain a scan axis at ``scan_steps`` > 1, which the
    port has no counterpart of)."""
    import kokoro_tpu.training.trainer as jt
    import kokoro_tpu_torch.training.trainer as pt
    from kokoro_tpu.config import get_default_config as ref_config
    from kokoro_tpu_torch.config import get_default_config as port_config
    from kokoro_tpu_torch.scripts.quality_run import build_corpus
    from tests.torch_quality_parity import N_UTTS, _overrides

    monkeypatch.setattr(jt, "_make_writer", jt._JsonlWriter)
    monkeypatch.setattr(pt, "_make_writer", pt._JsonlWriter)
    corpus = tmp_path / "corpus"
    build_corpus(corpus, N_UTTS)
    ref = jt.KokoroTrainer(ref_config(mesh_shape=(1,), scan_steps=1,
                                      **_overrides(corpus, tmp_path / "jax", 1)))
    ref.train_epoch(0)
    port = pt.KokoroTrainer(*port_config(**_overrides(corpus, tmp_path / "port", 1)),
                            device="cpu")
    port.train_epoch(0)

    def by_bt(census):
        out = {}
        for (shape, k), steps in census.items():
            assert k == 1
            out[(shape[-3], shape[-2])] = out.get((shape[-3], shape[-2]), 0) + steps
        return out

    assert port._shape_counts and by_bt(port._shape_counts) == by_bt(ref._shape_counts)
    assert port._shape_counts == ref._shape_counts
    assert sum(port._shape_counts.values()) == port.state.opt_step
    assert any(len(shape) == 4 for shape, _ in port._shape_counts)  # (A, B, T, M)


def _small_e2e(real):
    """``bench_end_to_end`` on a 9-utterance corpus at small widths, one
    measured epoch, the trainer's log to JSONL."""
    from kokoro_tpu_torch.scripts.quality_run import build_corpus

    def small(tmp_root, device):
        build_corpus(tmp_root / "bench_corpus_v3", 9)  # present: the bench builds none
        return real(tmp_root, device, measured_epochs=1, max_batch_size=4, **TINY)

    return small


def _small_compute_only(real, seen):
    def small(device):
        seen["compute_only"] = real(device, 2, 16, 64, 2, 1, 1, **TINY)
        return seen["compute_only"]

    return small


def test_bench_main_prints_the_references_line(tmp_path, monkeypatch, capsys):
    import kokoro_tpu_torch.training.trainer as pt

    monkeypatch.setattr(pt, "_make_writer", pt._JsonlWriter)
    seen = {}
    monkeypatch.setattr(bench, "bench_compute_only",
                        _small_compute_only(bench.bench_compute_only, seen))
    monkeypatch.setattr(bench, "bench_end_to_end", _small_e2e(bench.bench_end_to_end))
    out_file = tmp_path / "b.json"
    rc = bench.main(["--device", "cpu", "--work", str(tmp_path / "work"),
                     "--out", str(out_file)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert set(line) == _reference_payload_keys("bench") | _reference_e2e_keys()
    assert line["metric"] == "train_mel_frames_per_sec_per_chip"
    assert line["value"] == round(seen["compute_only"], 1) > 0
    assert line["vs_baseline"] == round(seen["compute_only"] / 18000.0, 3)
    assert line["end_to_end"] > 0 and line["buckets"] == 9
    assert line["shape_steps"] and all(k.startswith("B") and k.endswith("xk1")
                                       for k in line["shape_steps"])
    assert 0 < line["padding_efficiency"] <= 1
    saved = json.loads(out_file.read_text())
    assert saved["device"] == "cpu" and saved["payload"] == line


def test_failed_end_to_end_prints_zero_and_exits_1(tmp_path, monkeypatch, capsys):
    import kokoro_tpu_torch.training.trainer as pt

    def broken(self, epoch):
        raise RuntimeError("planted epoch failure")

    monkeypatch.setattr(pt, "_make_writer", pt._JsonlWriter)
    monkeypatch.setattr(pt.KokoroTrainer, "train_epoch", broken)
    seen = {}
    monkeypatch.setattr(bench, "bench_compute_only",
                        _small_compute_only(bench.bench_compute_only, seen))
    monkeypatch.setattr(bench, "bench_end_to_end", _small_e2e(bench.bench_end_to_end))
    work = tmp_path / "work"
    rc = bench.main(["--device", "cpu", "--work", str(work)])
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert rc == 1 and "planted epoch failure" in captured.err
    assert line["end_to_end"] == 0.0 and line["end_to_end_vs_baseline"] == 0.0
    assert line["value"] == round(seen["compute_only"], 1) > 0
    assert set(line) == _reference_payload_keys("bench")
    assert work.is_dir()  # a named work directory stays


def test_bench_inference_decodes_the_forced_length(monkeypatch, capsys, tmp_path):
    payload = bench_inference.run(CPU, max_frames=16, streams=(2, 3), repeats=1, **TINY)
    assert payload["detail"]["frames"] == 16
    assert payload["detail"]["hifigan_weights"] == "trained (hifigan_v1_int8.npz)"
    assert [payload[k]["frames_total"] for k in ("batched", "batched_3")] == [32, 48]
    for value in (payload["value"], payload["detail"]["frames_per_s"],
                  payload["batched"]["x_realtime_aggregate"]):
        assert math.isfinite(value) and value > 0
    # the reference's keys, its batched blocks at its stream counts (8, 32)
    keys = _payload_keys({**{k: v for k, v in payload.items() if k != "batched_3"},
                          "batched_32": payload["batched_3"]})
    assert keys == _reference_payload_keys("bench_inference")
    # the command line runs the reference's sizes and prints the payload
    seen = {}

    def small(device):
        seen["device"] = device
        return payload

    monkeypatch.setattr(bench_inference, "run", small)
    rc = bench_inference.main(["--device", "cpu", "--out", str(tmp_path / "i.json")])
    assert rc == 0 and seen["device"] == CPU
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == payload
    saved = json.loads((tmp_path / "i.json").read_text())
    assert saved["device"] == "cpu" and saved["max_frames"] == 1024


def test_bench_inference_refuses_another_length(monkeypatch):
    import kokoro_tpu_torch.models.generator as generator

    real = generator.generate

    def short(*args, **kwargs):
        mel, length, expected = real(*args, **kwargs)
        return mel, length - 1, expected

    monkeypatch.setattr(generator, "generate", short)
    with pytest.raises(RuntimeError, match="decoded .* frames, not 8 each"):
        bench_inference.run(CPU, max_frames=8, streams=(2,), repeats=1, **TINY)


def test_missing_hifigan_weights_say_random(tmp_path):
    hifi, name = bench_inference.load_hifigan(CPU, tmp_path / "absent.npz")
    assert name == "random" and next(hifi.parameters()).dtype == torch.bfloat16
    _, trained = bench_inference.load_hifigan(CPU)
    assert trained == "trained (hifigan_v1_int8.npz)"


@pytest.mark.parametrize("name", ["bench_h100.json", "bench_inference_h100.json"])
def test_committed_h100_bench_results(name):
    """The committed card runs name the card and its power limit, carry the
    reference's keys, and positive rates; every synthesis decode at the
    forced 1024 frames, on the committed HiFi-GAN."""
    saved = json.loads((ROOT / "kokoro_tpu_torch" / name).read_text())
    assert "H100" in saved["device"] and saved["device"].endswith(" W")
    line = saved["payload"]
    if name == "bench_h100.json":
        assert set(line) == _reference_payload_keys("bench") | _reference_e2e_keys()
        assert line["value"] > 0 and line["end_to_end"] > 0 and line["buckets"] == 9
        assert 0 < line["padding_efficiency"] <= 1 and line["shape_steps"]
        return
    assert _payload_keys(line) == _reference_payload_keys("bench_inference")
    assert line["value"] > 0 and saved["max_frames"] == 1024
    assert line["detail"]["hifigan_weights"] == "trained (hifigan_v1_int8.npz)"
    assert line["detail"]["frames"] == 1024
    for block, streams in (("batched", 8), ("batched_32", 32)):
        assert line[block]["streams"] == streams
        assert line[block]["frames_total"] == 1024 * streams
