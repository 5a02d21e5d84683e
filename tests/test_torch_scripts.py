"""The port's remaining tools (``kokoro_tpu_torch/scripts/``) against the
reference scripts of the same names, loaded by path, on the CPU.

* The host tools print what the reference scripts print on the same corpus
  and arguments, line for line: the phoneme coverage, the split's length
  statistics, the per-group warm-up table (to its printed precision) and
  the drop-path table; the quick-reference card is the port's own and
  names the port's files and its eager drop path.
* ``verify_setup`` on a machine without CUDA prints ``RESULT: FAIL``,
  names CUDA as missing and exits 1, and reports the port's packages.
* ``bench_serving``, ``bench_batched_decode`` and ``bench_step_shapes`` run
  at a tiny width: their rows have the reference's keys, the request count
  is what was sent, dispatches do not exceed requests, and there is one row
  per shape or stream count; a failing row records its error.
* ``examples_validation`` trains and speaks on the CPU and prints
  ``EXAMPLES: PASS``.
"""

import ast
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from kokoro_tpu_torch.config import KokoroConfig
from kokoro_tpu_torch.convert import model_metadata, save_model_dir
from kokoro_tpu_torch.data.phonemes import RussianPhonemeProcessor
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.scripts import bench_batched_decode, bench_serving, bench_step_shapes
from kokoro_tpu_torch.scripts import check_phoneme_coverage, check_split_lengths
from kokoro_tpu_torch.scripts import examples_validation, quality_run, stochastic_depth_summary
from kokoro_tpu_torch.scripts import verify_setup, warmup_summary

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TINY = dict(hidden_dim=64, n_encoder_layers=2, n_decoder_layers=2, n_heads=4,
            encoder_ff_dim=128, decoder_ff_dim=128, variance_filter_size=32)


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dict_keys(node):
    """The keys of a dict literal, nested dicts as ``outer.inner``."""
    keys = set()
    for k, v in zip(node.keys, node.values):
        keys.add(k.value)
        if isinstance(v, ast.Dict):
            keys |= {f"{k.value}.{inner}" for inner in _dict_keys(v)}
    return keys


def _reference_rows(name):
    """The key sets of the dict literals the reference script appends to
    ``results`` (its rows) or prints with ``json.dumps``."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text(encoding="utf-8"))
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Dict)
                and getattr(node.func, "attr", getattr(node.func, "id", None))
                in ("append", "dumps")):
            found.append(_dict_keys(node.args[0]))
    assert found, name
    return found


def _keys(row):
    keys = set(row)
    for k, v in row.items():
        if isinstance(v, dict) and k == "concurrent":
            keys |= {f"{k}.{inner}" for inner in v}
    return keys


def _run_reference(name, argv, monkeypatch, capsys):
    module = _reference(name)
    monkeypatch.setattr("sys.argv", [f"{name}.py", *argv])
    capsys.readouterr()
    rc = module.main()
    return rc, capsys.readouterr().out


def _run_port(module, argv, capsys):
    capsys.readouterr()
    rc = module.main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    quality_run.build_corpus(root, 12)
    return root


@pytest.mark.parametrize("script, module, argv", [
    ("check_phoneme_coverage", check_phoneme_coverage, ["--corpus", "{corpus}"]),
    ("check_phoneme_coverage", check_phoneme_coverage, ["--corpus", "{corpus}", "--limit", "3"]),
    ("check_split_lengths", check_split_lengths, ["--corpus", "{corpus}"]),
    ("check_split_lengths", check_split_lengths,
     ["--corpus", "{corpus}", "--validation-split", "0.25", "--seed", "7"]),
    ("warmup_summary", warmup_summary, []),
    ("warmup_summary", warmup_summary,
     ["--total-steps", "480", "--learning-rate", "1e-4", "--warmup-steps", "200"]),
    ("stochastic_depth_summary", stochastic_depth_summary, []),
    ("stochastic_depth_summary", stochastic_depth_summary,
     ["--rate", "0.3", "--encoder-layers", "4", "--decoder-layers", "8",
      "--decoder-dropout", "0.1"]),
], ids=lambda v: v if isinstance(v, str) else None)
def test_host_tool_prints_the_references_output(script, module, argv, corpus, monkeypatch,
                                                capsys):
    argv = [a.format(corpus=corpus) for a in argv]
    rc_ref, out_ref = _run_reference(script, argv, monkeypatch, capsys)
    rc, out = _run_port(module, argv, capsys)
    assert rc == rc_ref == 0
    if script == "warmup_summary":  # the reference's rates are f32, the port's f64
        _same_table(out, out_ref)
    else:
        assert out == out_ref
    assert out.count("\n") >= 3


def _same_table(out, ref):
    """Equal lines but for numbers in ``%.2e`` that may differ by one unit
    in their last printed digit."""
    lines, ref_lines = out.splitlines(), ref.splitlines()
    assert len(lines) == len(ref_lines) and lines[0] == ref_lines[0]
    for line, ref_line in zip(lines[1:], ref_lines[1:]):
        (label, *values), (ref_label, *ref_values) = line.split(), ref_line.split()
        assert label == ref_label and len(values) == len(ref_values)
        for v, r in zip(values, ref_values):
            mantissa, exponent = r.split("e")
            assert abs(float(v) - float(r)) <= 1.01e-2 * 10 ** int(exponent), (label, v, r)


def test_coverage_reports_a_corpus_without_metadata(tmp_path, monkeypatch, capsys):
    rc_ref, _ = _run_reference("check_phoneme_coverage", ["--corpus", str(tmp_path)],
                               monkeypatch, capsys)
    rc, _ = _run_port(check_phoneme_coverage, ["--corpus", str(tmp_path)], capsys)
    assert rc == rc_ref == 1


def test_quick_reference_card_is_the_ports(monkeypatch, capsys):
    rc_ref, out_ref = _run_reference("stochastic_depth_summary", ["--quick-ref"],
                                     monkeypatch, capsys)
    rc, out = _run_port(stochastic_depth_summary, ["--quick-ref"], capsys)
    assert rc == rc_ref == 0
    card, table = out.split("Linearly-scaled", 1)
    assert out_ref.endswith("Linearly-scaled" + table)  # the table is the reference's
    assert "kokoro_tpu_torch/config.py" in card and "models/rng.py::drop_path" in card
    assert "eager PyTorch" in card and "under jit" not in card and "kokoro_tpu/" not in card
    assert "max drop probability, LAST layer (0.1)" in card and "Mean ~= 5.0%" in card


def test_verify_setup_fails_without_cuda(corpus, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _run_port(verify_setup, ["--corpus", str(corpus)], capsys)
    assert rc == 1
    assert out.rstrip().endswith("RESULT: FAIL")
    assert "[MISSING] CUDA" in out and "'cuda_available': False" in out
    for mod in ("torch", "numpy", "scipy"):
        assert f"[OK] {mod}" in out
    assert "jax" not in out and "'valid': True" in out


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    cfg = KokoroConfig(vocab_size=59, **TINY)
    model = KokoroModel(cfg).init_weights(torch.Generator().manual_seed(0))
    return save_model_dir(
        tmp_path_factory.mktemp("model"), model.state_dict(), model_metadata(cfg),
        RussianPhonemeProcessor().to_dict(),
        {"max_seq_length": 24, "stop_token_threshold": 0.5, "post_expected_stop_threshold": 0.2},
    )


def test_bench_serving_counts(model_dir, tmp_path, capsys):
    out_file = tmp_path / "serving.json"
    rc, out = _run_port(bench_serving, [
        "--model", str(model_dir), "--clients", "4", "--requests", "10",
        "--vocoder", "griffin_lim", "--device", "cpu", "--out", str(out_file)], capsys)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert _keys(line) == _reference_rows("bench_serving")[0]
    conc = line["concurrent"]
    assert conc["clients"] == 4 and conc["requests"] == 10
    assert 1 <= conc["dispatches"] <= conc["requests"]
    assert line["single_stream_s"] > 0 and conc["p95_s"] >= conc["p50_s"] > 0
    saved = json.loads(out_file.read_text())
    assert saved["device"] == "cpu" and saved["vocoder"] == "griffin_lim"
    assert saved["model"] == str(model_dir) and saved["concurrent"] == conc


def test_bench_batched_decode_rows(monkeypatch, tmp_path, capsys):
    rows = bench_batched_decode.sweep(CPU, (1, 3), 6, repeats=1, **TINY)
    keys = _reference_rows("bench_batched_decode")
    assert [r["streams"] for r in rows] == [1, 3]
    assert all(set(r) == keys[0] for r in rows) and rows[0]["throughput_vs_single"] == 1.0
    for r in rows:
        assert r["frames_per_s"] == pytest.approx(r["streams"] * 6 / r["decode_s"], rel=0.1)
    # the command line: its defaults are the reference's, its line the rows
    seen, real = {}, bench_batched_decode.sweep

    def small(device, streams, frames):
        seen.update(streams=list(streams), frames=frames)
        return real(device, (2,), 4, repeats=1, **TINY)

    monkeypatch.setattr(bench_batched_decode, "sweep", small)
    rc, out = _run_port(bench_batched_decode, ["--device", "cpu", "--out",
                                               str(tmp_path / "d.json")], capsys)
    assert rc == 0 and seen == {"streams": [1, 8, 16, 32, 64], "frames": 1024}
    printed = json.loads(out.strip().splitlines()[-1])
    assert [r["streams"] for r in printed] == [2]
    saved = json.loads((tmp_path / "d.json").read_text())
    assert saved["rows"] == printed and saved["frames"] == 1024 and saved["device"] == "cpu"


def test_bench_step_shapes_rows(monkeypatch):
    shapes = [(2, 16, 64), (4, 16, 96)]
    rows = bench_step_shapes.sweep(CPU, shapes, warm_calls=1, timed_calls=1, **TINY)
    keys = _reference_rows("bench_step_shapes")
    assert [(r["B"], r["L"], r["T"]) for r in rows] == shapes
    for r in rows:
        assert keys[0] <= set(r) and "error" not in r
        assert r["padded_frames_per_sec"] == pytest.approx(
            r["B"] * r["T"] / (r["step_ms"] / 1e3), rel=0.01)
        assert r["launches_per_step"] == {}  # on the CPU the plain attention runs
        assert r["steps_taken"] == (1 + 1) * bench_step_shapes.K
    # a row that fails records its error, as the reference's does
    import kokoro_tpu_torch.training.train_step as train_step

    def broken(*args, **kwargs):
        raise RuntimeError("out of memory (planted)")

    monkeypatch.setattr(train_step, "create_train_state", broken)
    failed = bench_step_shapes.sweep(CPU, shapes[:1], **TINY)
    assert failed == [{"B": 2, "T": 64, "L": 16, "error": "out of memory (planted)"}]
    assert set(failed[0]) == keys[1]
    assert bench_step_shapes.CONFIGS == _reference("bench_step_shapes").CONFIGS
    assert bench_step_shapes.CONFIGS_SHORT == _reference("bench_step_shapes").CONFIGS_SHORT


def test_examples_validation_passes_on_the_cpu(capsys):
    rc, out = _run_port(examples_validation, ["--device", "cpu"], capsys)
    assert rc == 0 and out.rstrip().endswith("EXAMPLES: PASS")
    assert "train result:" in out and "synthesized" in out


@pytest.mark.parametrize("name, script", [
    ("bench_serving_h100.json", "bench_serving"),
    ("batched_decode_h100.json", "bench_batched_decode"),
    ("step_shapes_h100.json", "bench_step_shapes"),
    ("step_shapes_short_h100.json", "bench_step_shapes"),
])
def test_committed_h100_tool_results(name, script):
    """Each committed card run names the card, its model or run directory
    (and its vocoder), has the reference's keys and no error row."""
    saved = json.loads((ROOT / "kokoro_tpu_torch" / "scripts" / name).read_text())
    assert "H100" in saved["device"] and saved["device"].endswith(" W") and saved["model"]
    keys = _reference_rows(script)[0]
    if script == "bench_serving":
        assert "quality_run" in saved["run_directory"]
        assert [r["vocoder"] for r in saved["runs"]] == ["griffin_lim", "hifigan"]
        for run in saved["runs"]:
            line = {k: v for k, v in run.items() if k not in ("vocoder", "vocoder_path")}
            assert _keys(line) == keys and run["concurrent"]["requests"] == 48
            assert run["concurrent"]["dispatches"] <= run["concurrent"]["requests"]
        return
    rows = saved["rows"]
    assert rows and all(keys <= set(r) and "error" not in r for r in rows)
    if script == "bench_batched_decode":
        assert [r["streams"] for r in rows] == list(bench_batched_decode.STREAMS)
        assert saved["frames"] == bench_batched_decode.MAX_FRAMES
    else:
        configs = (bench_step_shapes.CONFIGS_SHORT if "short" in name
                   else bench_step_shapes.CONFIGS)
        assert [(r["B"], r["L"], r["T"]) for r in rows] == configs
        assert all(set(r["launches_per_step"].values()) == {6} for r in rows)
