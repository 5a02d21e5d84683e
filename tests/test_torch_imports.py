"""The port stands alone: no module of ``kokoro_tpu_torch`` nor
``chip_smoke.py`` imports JAX, flax, optax, orbax, anything of
``kokoro_tpu`` or the repository's ``scripts/``, and the entry points refuse
to run without CUDA unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kokoro_tpu", "scripts")
PORT_FILES = sorted((ROOT / "kokoro_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_port_files_exist():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for required in ("chip_smoke.py", "kokoro_tpu_torch/ops/fused_attention.py",
                     "kokoro_tpu_torch/ops/flash_attention.py", "kokoro_tpu_torch/ops/pitch.py",
                     "kokoro_tpu_torch/ops/energy.py", "kokoro_tpu_torch/data/dataset.py",
                     "kokoro_tpu_torch/data/batching.py",
                     "kokoro_tpu_torch/training/checkpoint.py",
                     "kokoro_tpu_torch/training/trainer.py", "kokoro_tpu_torch/cli/args.py",
                     "kokoro_tpu_torch/cli/train.py", "kokoro_tpu_torch/serving/server.py",
                     "kokoro_tpu_torch/cli/serve.py",
                     # the MFA training data path and the kokoro-infer entry point
                     "kokoro_tpu_torch/data/mfa.py", "kokoro_tpu_torch/native/__init__.py",
                     "kokoro_tpu_torch/native/binding.py", "kokoro_tpu_torch/config.py",
                     "kokoro_tpu_torch/cli/preprocess.py", "kokoro_tpu_torch/cli/precompute.py",
                     "kokoro_tpu_torch/training/tb_events.py", "kokoro_tpu_torch/ops/lengths.py",
                     "kokoro_tpu_torch/models/hifigan.py",
                     "kokoro_tpu_torch/inference/vocoder.py", "kokoro_tpu_torch/inference/tts.py",
                     "kokoro_tpu_torch/utils/profiling.py", "kokoro_tpu_torch/cli/infer.py",
                     "kokoro_tpu_torch/models/model_loader.py",
                     # the trainer's tooling
                     "kokoro_tpu_torch/version.py", "kokoro_tpu_torch/utils/misc.py",
                     "kokoro_tpu_torch/utils/cache_manager.py",
                     "kokoro_tpu_torch/utils/memory_planner.py", "kokoro_tpu_torch/cli/plan.py",
                     # sequence and pipeline parallelism
                     "kokoro_tpu_torch/parallel/pp.py", "kokoro_tpu_torch/parallel/pp_step.py",
                     # the quality run, the regression analyzer and the audio tool
                     "kokoro_tpu_torch/scripts/__init__.py",
                     "kokoro_tpu_torch/scripts/quality_run.py",
                     "kokoro_tpu_torch/scripts/analyze_training_regression.py",
                     "kokoro_tpu_torch/scripts/e2e_audio_artifact.py",
                     # the vocoder's training path and the remaining tools
                     *(f"kokoro_tpu_torch/scripts/{name}.py" for name in PORTED_SCRIPTS)):
        assert required in names
    for source in ("packed_attention.cu", "packed_attention_bwd.cu", "flash_attention.cu",
                   "flash_attention_bwd.cu", "attention_common.cuh", "attention_kernels.cuh",
                   "aligner.cpp"):
        assert (ROOT / "kokoro_tpu_torch" / "csrc" / source).is_file(), source


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    _no_cuda(monkeypatch)
    from kokoro_tpu_torch.cli import serve
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.inference.tts import KokoroTTS
    from kokoro_tpu_torch.inference.vocoder import VocoderManager
    from kokoro_tpu_torch.serving import TTSServer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KokoroTTS(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTSServer.for_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VocoderManager(vocoder_type="griffin_lim")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--model", str(tmp_path), "--port", "0"])
    from kokoro_tpu_torch.cli import train

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--data-dir", str(tmp_path), "--output-dir", str(tmp_path / "run")])
    from kokoro_tpu_torch.cli import infer
    from kokoro_tpu_torch.cli.precompute import precompute_features
    from kokoro_tpu_torch.config import get_default_config

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(["--model", str(tmp_path), "--text", "привет"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        precompute_features(*get_default_config(data_dir=str(tmp_path)))
    assert resolve_device("cpu") == torch.device("cpu")


# the JAX package's parallel/ names whose port has another name (the XLA
# sharding objects become the process-level operations that do their work)
PARALLEL_COUNTERPARTS = {
    "mesh.batch_sharding": "mesh.shard_batch",
    "mesh.replicated": "tp.Layout",  # a parameter outside Layout.splits is replicated
    "mesh.global_batch_from_local": "mesh.shard_batch",
    "mesh.put_batch": "mesh.shard_batch",
    "mesh.make_sharded_train_step": "training.train_step.make_train_step",
    "mesh.make_sharded_eval_step": "training.train_step.make_eval_step",
    "tp.leaf_pspec": "tp.param_split",
    "tp.tree_shardings": "tp.shard_tree",
    "tp.dp_size": "mesh.dp_size",
    "tp.tp_size": "mesh.tp_size",
    "pp.stage_params_sharding": "pp.stage_layers",
}


def _public_names(path: Path, private: bool = False):
    """The top-level function, class and variable names of a module (with
    ``private``, those starting with an underscore too)."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
        else:
            continue
        yield from (n for n in names if private or not n.startswith("_"))


def test_every_public_name_of_the_parallel_package_has_a_counterpart():
    """The AST comparison of ROADMAP.md §1 over ``kokoro_tpu/parallel/``:
    each public name of each module exists in the port's module of the same
    name, or its counterpart in ``PARALLEL_COUNTERPARTS`` exists."""
    import importlib

    missing = []
    for path in sorted((ROOT / "kokoro_tpu" / "parallel").glob("*.py")):
        module = path.stem
        for name in _public_names(path):
            target = PARALLEL_COUNTERPARTS.get(f"{module}.{name}", f"{module}.{name}")
            where, attr = target.rsplit(".", 1)
            port = importlib.import_module(
                f"kokoro_tpu_torch.{'' if where.startswith('training') else 'parallel.'}{where}")
            if not hasattr(port, attr):
                missing.append(f"{module}.{name} -> {target}")
    assert not missing, missing


# the ported scripts' top-level names, command-line options and JAX
# configuration keys whose port has another name, or none (None): the
# reference's own repository path, the JAX platform switch and the JAX
# compile cache (XLA machinery).  ``verify_setup.check_devices`` keeps its
# name; its JAX body (``jax.devices()``) became ``torch.cuda``'s view.
SCRIPT_COUNTERPARTS = {
    "quality_run.REPO": None,  # outputs go under --out, never into docs/
    "analyze_training_regression._force_cpu_jax": None,  # torch.load(map_location="cpu")
    "analyze_training_regression.jax_platforms": None,
    "e2e_audio_artifact.REPO": "DEFAULT_VOCODER",  # the committed docs/hifigan_v1_int8.npz
    "train_hifigan.REPO": None,  # --out and --metrics default outside docs/
    "train_hifigan.--platform": "--device",
    "train_hifigan.jax_platforms": None,
    "quantize_hifigan.REPO": None,
    "quantize_hifigan.--platform": "--device",
    "quantize_hifigan.jax_platforms": None,
    "bench_serving.REPO": None,
    "bench_batched_decode.jax_compilation_cache_dir": None,
    "bench_batched_decode.jax_persistent_cache_min_compile_time_secs": None,
    "bench_step_shapes.jax_compilation_cache_dir": None,
    "bench_step_shapes.jax_persistent_cache_min_compile_time_secs": None,
    "warmup_summary.jax_platforms": None,  # its schedules are plain Python: no device
}
PORTED_SCRIPTS = ("quality_run", "analyze_training_regression", "e2e_audio_artifact",
                  "train_hifigan", "quantize_hifigan", "bench_serving", "bench_batched_decode",
                  "bench_step_shapes", "examples_validation", "check_phoneme_coverage",
                  "check_split_lengths", "warmup_summary", "stochastic_depth_summary",
                  "verify_setup")


def _options(path: Path):
    """The ``--option`` strings of ``add_argument`` calls and the keys of
    ``jax.config.update`` calls in a script."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        attr = getattr(node.func, "attr", None)
        if attr == "add_argument":
            yield from (a.value for a in node.args
                        if isinstance(a, ast.Constant) and str(a.value).startswith("--"))
        elif attr == "update" and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("script", PORTED_SCRIPTS)
def test_every_name_of_a_ported_script_has_a_counterpart(script):
    """Each top-level name of ``scripts/<script>.py`` (public and private)
    and each of its command-line options and JAX configuration keys exists
    in ``kokoro_tpu_torch/scripts/<script>.py`` under its own name or its
    ``SCRIPT_COUNTERPARTS`` name, or is listed there as dropped; the
    top-level names that the port keeps come in the reference's order."""
    ref_path = ROOT / "scripts" / f"{script}.py"
    port_path = ROOT / "kokoro_tpu_torch" / "scripts" / f"{script}.py"
    ref = list(_public_names(ref_path, private=True))
    port = list(_public_names(port_path, private=True))
    port_all = port + list(_options(port_path))
    missing = []
    for name in ref + list(_options(ref_path)):
        target = SCRIPT_COUNTERPARTS.get(f"{script}.{name}", name)
        if target is not None and target not in port_all:
            missing.append(f"{script}.{name} -> {target}")
    assert not missing, missing
    kept = [n for n in ref if n in port]
    assert kept == [n for n in port if n in kept], "functions out of the reference's order"
    ported = [n for n in ref if SCRIPT_COUNTERPARTS.get(f"{script}.{n}", n) is not None]
    assert len(kept) >= min(2, len(ported))
