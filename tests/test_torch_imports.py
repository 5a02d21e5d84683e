"""The port stands alone: no module of ``kokoro_tpu_torch`` nor
``chip_smoke.py`` imports JAX, flax, optax, orbax or anything of
``kokoro_tpu``, and the entry points refuse to run without CUDA unless the
caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kokoro_tpu")
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
                     "kokoro_tpu_torch/models/model_loader.py"):
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
