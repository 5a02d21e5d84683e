"""The port's ``utils/`` against the JAX package's: ``misc`` (size format,
training-time estimate, parameter counts), ``cache_manager`` (status on one
cache directory, clear, the CLI), ``profiling`` (``InterbatchProfiler``
and ``compare_dtype_policies`` with a stub step, the
A/B's synthetic batch and model fields) and ``memory_planner.count_params``
equal to the reference's at the smoke and the flagship widths."""


import numpy as np
import pytest
import torch

from kokoro_tpu import config as ref_config
from kokoro_tpu.utils import cache_manager as ref_cache
from kokoro_tpu.utils import misc as ref_misc
from kokoro_tpu.utils import profiling as ref_profiling
from kokoro_tpu.utils.memory_planner import count_params as ref_count_params
from kokoro_tpu_torch import config as port_config
from kokoro_tpu_torch.data.dataset import FEATURE_CACHE_VERSION
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.utils import cache_manager, misc, profiling
from kokoro_tpu_torch.utils.memory_planner import count_params


@pytest.mark.parametrize("n", [0, 999, 1500, 2_500_000, 49_432_788, 3_000_000_000])
def test_format_model_size(n):
    assert misc.format_model_size(n) == ref_misc.format_model_size(n)


def test_estimate_training_time():
    assert misc.estimate_training_time(120, 30, 0.25) == ref_misc.estimate_training_time(
        120, 30, 0.25)


def test_count_parameters_of_module_and_state_dict():
    m, _ = port_config.get_smoke_test_config()
    model = KokoroModel(m)
    n = misc.count_parameters(model)
    assert n == misc.count_parameters(model.state_dict()) == count_params(m, m.vocab_size)
    assert misc.format_model_size(n).endswith("K")


def test_device_info_without_cuda(monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info = misc.device_info()
    assert info["backend"] == "cpu" and info["device_count"] == 0
    with caplog.at_level("INFO", logger="kokoro_tpu_torch.utils.misc"):
        misc.log_device_info()
    assert "backend cpu" in caplog.text


@pytest.mark.parametrize("preset", ["get_smoke_test_config", "get_default_config"])
def test_count_params_matches_reference(preset):
    m, _ = getattr(port_config, preset)()
    ref = getattr(ref_config, preset)()
    assert count_params(m, 60) == ref_count_params(ref, 60)


# -- cache_manager ------------------------------------------------------------------------
def _cache(tmp_path, version=FEATURE_CACHE_VERSION):
    corpus = tmp_path / "corpus"
    cache = corpus / ".feature_cache_torch"
    cache.mkdir(parents=True)
    for i in range(3):
        np.savez(cache / f"s{i}.npz", cache_version=version, mel_spec=np.zeros((4, 80)))
    (cache / "broken.npz").write_bytes(b"not a zip")
    return corpus, cache


def test_cache_status_matches_reference(tmp_path):
    corpus, cache = _cache(tmp_path)
    ours = cache_manager.cache_status(str(corpus))
    assert ours == ref_cache.cache_status(str(corpus), str(cache))
    assert (ours["entries"], ours["sampled_corrupt"]) == (4, 1)
    assert cache_manager.cache_status(str(tmp_path / "none")) == {
        "exists": False, "path": str(tmp_path / "none" / ".feature_cache_torch")}


def test_cache_status_counts_other_versions_as_corrupt(tmp_path):
    corpus, _ = _cache(tmp_path, version=FEATURE_CACHE_VERSION + 1)
    assert cache_manager.cache_status(str(corpus))["sampled_corrupt"] == 4


def test_cache_manager_cli(tmp_path, capsys):
    corpus, cache = _cache(tmp_path)
    assert cache_manager.main(["--corpus", str(corpus), "--status"]) == 0
    assert "'entries': 4" in capsys.readouterr().out
    assert cache_manager.main(["--corpus", str(corpus), "--clear"]) == 0
    assert not cache.exists()
    assert cache_manager.cache_clear(str(corpus)) is False


# -- profiling ----------------------------------------------------------------------------
def test_interbatch_profiler_matches_reference(monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.25))
    fake = lambda: next(clock)  # noqa: E731
    reports = []
    for mod in (profiling, ref_profiling):
        monkeypatch.setattr(mod.time, "perf_counter", fake)
        ib = mod.InterbatchProfiler(report_interval=2)
        for _ in range(3):
            ib.start("data")
            ib.end("data")
            ib.start("step")
            ib.end("step")
        ib.end("never_started")
        reports.append((ib.report(), sorted(ib.phases)))
    assert reports[0] == reports[1]
    assert reports[0][1] == ["data", "step"]


def test_compare_dtype_policies_with_a_stub_step(monkeypatch):
    # a fake clock: each stub step advances it by 2 ms (bf16) or 4 ms (f32),
    # so the A/B reads exactly 2.0 whatever the host's scheduler does
    now = [0.0]

    def make_step(dtype):
        delay = 0.002 if dtype == "bfloat16" else 0.004

        def step():
            now[0] += delay

        return step, ()

    for mod in (profiling, ref_profiling):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: now[0])
    ours = profiling.compare_dtype_policies(make_step, n_steps=3)
    theirs = ref_profiling.compare_dtype_policies(make_step, n_steps=3)
    monkeypatch.undo()
    assert ours.keys() == theirs.keys() == {"bfloat16", "float32", "speedup_bf16"}
    assert ours["bfloat16"].keys() == theirs["bfloat16"].keys()
    for result in (ours, theirs):
        assert result["speedup_bf16"]["value"] == pytest.approx(2.0, abs=1e-9)
        assert result["speedup_bf16"]["value"] > 1.0
    step = profiling.profile_step_fn(lambda x: x + 1, (1,), n_steps=2, warmup=1)
    assert step["min_s"] <= step["median_s"] <= step["max_s"]


def test_dtype_ab_batch_is_the_references():
    rng = np.random.default_rng(0)  # the construction of the reference's A/B batch
    B, L, T = 8, 64, 512
    ref = {"phoneme_indices": rng.integers(1, 60, (B, L)),
           "stress_indices": rng.integers(0, 3, (B, L)),
           "mel_specs": rng.normal(size=(B, T, 80)).astype(np.float32),
           "pitch_targets": rng.uniform(size=(B, T)).astype(np.float32),
           "energy_targets": rng.uniform(size=(B, T)).astype(np.float32)}
    ours = profiling.dtype_ab_batch(80, "cpu")
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    assert (ours["phoneme_durations"] == 8).all() and (ours["mel_lengths"] == T).all()


def test_profile_dtype_for_config_builds_the_reference_fields(monkeypatch):
    m, c = port_config.get_high_performance_config(
        hidden_dim=64, n_encoder_layers=1, n_decoder_layers=1, n_heads=4, encoder_ff_dim=128,
        decoder_ff_dim=128, gradient_checkpointing=True)
    built = {}

    def fake_compare(make_step, n_steps):
        for dtype in ("bfloat16", "float32"):
            step, _ = make_step(dtype)
            cell = step.__closure__
            state = next(x.cell_contents for x in cell if hasattr(x.cell_contents, "model"))
            built[dtype] = state.model
        return {"speedup_bf16": {"value": 0.9}}

    monkeypatch.setattr(profiling, "compare_dtype_policies", fake_compare)
    assert profiling.profile_dtype_for_config(m, c, device="cpu") == "float32"
    model = built["bfloat16"]
    cfg = model.config
    assert (cfg.vocab_size, cfg.hidden_dim, cfg.use_flash_attention,
            cfg.use_stochastic_depth, cfg.attention_weight_dropout) == (64, 64, False, False, True)
    dtype = {k: v.decoder_layers[0].self_attn.w_q.compute_dtype for k, v in built.items()}
    assert dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}
    assert c.gradient_checkpointing and c.compute_dtype == "bfloat16"  # the caller's, untouched
