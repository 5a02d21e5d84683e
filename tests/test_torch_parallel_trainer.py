"""The port's trainer and ``kokoro-train`` on a mesh of processes, on the CPU
over gloo, at the smoke preset's widths (hidden 64, 2+2 layers, 4 heads,
ff 128) with every dropout rate 0, as ``tests/unit/test_parallel.py:137-163``
holds the reference's trainer:

* two epochs at ``(2,)`` and at ``(1, 2)`` against ``(1,)`` (a single
  process): epoch losses within 5e-4, parameters rtol 2e-4 / atol 2e-5,
  the same optimizer step count and validation losses;
* ``_assemble`` pads the batch rows to the mesh multiple and gives each
  data rank its block; validation is sharded over ``data`` (its metrics
  those of the single process); only rank 0 writes logs;
* a checkpoint a single process wrote resumes at ``(2, 2)``, whose
  checkpoint (written by rank 0 alone) resumes in a single process;
* ``kokoro-train --distributed --mesh-shape 2,2 --mesh-axes data,model
  --device cpu`` under ``torch.distributed.run`` (4 processes).
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kokoro_tpu_torch.config import get_smoke_test_config
from kokoro_tpu_torch.data.audio_io import save_wav
from kokoro_tpu_torch.training import trainer as trainer_mod
from tests import torch_parallel_workers as workers

ROOT = Path(__file__).resolve().parents[1]
NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, decoder_input_dropout=0.0,
                  variance_dropout=0.0, use_stochastic_depth=False)
OVERRIDES = dict(NO_DROPOUT, num_epochs=2, batch_size=2, gradient_accumulation_steps=1,
                 validation_split=0.25, use_speed_perturbation=False, use_spec_augment=False,
                 save_every=10, compute_dtype="float32", log_every_steps=1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_corpus")
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


@pytest.fixture
def jsonl_logs(monkeypatch):
    monkeypatch.setattr(trainer_mod, "_make_writer", trainer_mod._JsonlWriter)


def single_trainer(corpus, out, **overrides):
    return trainer_mod.KokoroTrainer(*get_smoke_test_config(
        data_dir=str(corpus), output_dir=str(out), **{**OVERRIDES, **overrides}), device="cpu")


@pytest.fixture(scope="module")
def mesh_runs(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_trainer")
    workers.run_world(workers.trainer_world, 2, out, str(corpus), OVERRIDES,
                      [(2,), (1, 2)], str(out))
    return out, {tag: torch.load(out / f"trainer_{tag}.pt", weights_only=False)
                 for tag in ("2", "1x2")}


def logged(run: Path, tag: str):
    lines = (run / "logs" / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if r.get("tag") == tag]


@pytest.mark.parametrize("tag", ["2", "1x2"])
def test_trainer_on_a_mesh_matches_one_process(corpus, tmp_path, mesh_runs, jsonl_logs, tag):
    one = single_trainer(corpus, tmp_path / "one", mesh_shape=(1,))
    assert one.mesh is not None and one.dp_size == one.tp_size == 1
    epochs = [one.train_epoch(e) for e in range(2)]
    val = one.validate_epoch(1)
    run = mesh_runs[1][tag]
    assert (run["dp_size"], run["tp_size"]) == ((2, 1) if tag == "2" else (1, 2))
    for a, b in zip(epochs, run["epochs"]):
        for key in ("total", "mel"):
            assert abs(a[key] - b[key]) < 5e-4, (tag, key, a[key], b[key])
    for key in ("total", "mel", "spectral_convergence", "mcd"):
        assert abs(val[key] - run["val"][key]) <= 1e-5 * max(1.0, abs(val[key])), key
    assert run["opt_step"] == one.state.opt_step > 0
    for name, param in one.state.params.items():
        torch.testing.assert_close(run["params"][name], param.detach(), rtol=2e-4, atol=2e-5,
                                   msg=name)


def test_assemble_pads_rows_to_the_mesh_multiple(mesh_runs):
    dp = mesh_runs[1]["2"]
    # the quantum is lcm(data ranks, min(4, max_batch_size)); each rank its half
    assert dp["quantum"] == 4 and dp["local_rows"] == 2
    tp = mesh_runs[1]["1x2"]
    assert tp["quantum"] == 4 and tp["local_rows"] == 4


def test_only_rank_zero_writes_logs(mesh_runs):
    out, runs = mesh_runs
    for tag, run in runs.items():
        steps = logged(out / f"run_{tag}", "loss/total")
        assert [r["step"] for r in steps] == list(range(1, run["opt_step"] + 1)), tag


def test_checkpoint_moves_between_one_process_and_2x2(corpus, tmp_path, jsonl_logs):
    run = tmp_path / "run"
    ck = dict(save_every=1, num_epochs=1)
    first = single_trainer(corpus, run, **ck)
    first.train()
    step1 = first.state.opt_step
    workers.run_world(workers.resume_world, 4, tmp_path, str(corpus),
                      dict(OVERRIDES, save_every=1, num_epochs=2), str(tmp_path))
    mesh = torch.load(tmp_path / "resume_2x2.pt", weights_only=False)
    assert mesh["start_epoch"] == 1 and mesh["start_step"] == step1
    assert mesh["opt_step"] > step1 and mesh["writer"] == "_JsonlWriter"
    for name, param in first.state.params.items():
        assert torch.equal(mesh["resumed"][name], param.detach()), name
    assert (run / "checkpoint_epoch_2" / "metadata.json").exists()
    last = single_trainer(corpus, run, save_every=1, num_epochs=3)
    last.train()
    assert last.start_epoch == 2 and last.state.opt_step > mesh["opt_step"]
    saved = torch.load(run / "checkpoint_epoch_2" / "state.pt", weights_only=True)
    for name, value in mesh["final"].items():
        assert torch.equal(saved["model"][name], value), name


def test_kokoro_train_under_torch_distributed_run(corpus, tmp_path):
    """The real entry point, its argument parsing and ``train_model``, on
    4 CPU processes at the smoke widths (``get_default_config`` swapped
    for the smoke preset, since a full-width model does not belong on this
    CPU); ``--standalone`` picks a free localhost port."""
    script = tmp_path / "train_smoke.py"
    script.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from kokoro_tpu_torch import config\n"
        "from kokoro_tpu_torch.cli import args, train\n"
        "from kokoro_tpu_torch.training import trainer\n"
        "args.get_default_config = config.get_smoke_test_config\n"
        "trainer._make_writer = trainer._JsonlWriter\n"
        "raise SystemExit(train.main())\n")
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", str(script), "--distributed", "--mesh-shape", "2,2",
           "--mesh-axes", "data,model", "--device", "cpu", "--data-dir", str(corpus),
           "--output-dir", str(out), "--epochs", "1", "--no-mfa", "--no-spec-augment",
           "--no-speed-perturbation", "--gradient-accumulation", "1", "--save-every", "1"]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE",
                                                                    "LOCAL_RANK", "MASTER"))}
    # a process group of its own, so that a hung run is killed with every rank
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, start_new_session=True)
    try:
        _, stderr = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("kokoro-train on 4 processes did not end within 240 s")
    assert proc.returncode == 0, stderr[-4000:]
    assert "Parallelism: 2-way data x 1-way seq x 2-way tensor x 1-way pipeline" in stderr
    assert (out / "checkpoint_epoch_1" / "metadata.json").exists()
    meta = json.loads((out / "checkpoint_epoch_1" / "metadata.json").read_text())
    assert meta["config"]["mesh_shape"] == [2, 2] and meta["config"]["distributed_init"]
    assert logged(out, "loss/train_total_epoch")  # rank 0 logged the epoch
