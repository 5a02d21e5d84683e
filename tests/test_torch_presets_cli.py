"""The port's config presets and ``kokoro-train`` command line against the JAX
package's: every field the reference's ``TrainingConfig`` shares with the
port's two dataclasses is equal for the four presets
(``get_default_config``, ``get_low_memory_config``,
``get_high_performance_config``, ``get_smoke_test_config``) and for each of
the reference's arguments the port lacked (``--no-ema``,
``--profile-dtypes``, ``--compile-cache-dir``, ``--mesh-shape``,
``--mesh-axes``, ``--distributed``), the parallel ones with the mesh
fields they set.  ``feature_cache_dir`` is the one deliberate difference:
each package keeps its own cache directory.
"""

import argparse
import dataclasses
import logging
from pathlib import Path

import pytest

from kokoro_tpu import config as ref_config
from kokoro_tpu.cli.args import add_training_arguments as ref_add_arguments
from kokoro_tpu.cli.args import create_config_from_args as ref_config_from_args
from kokoro_tpu_torch import config as port_config
from kokoro_tpu_torch.cli import args as port_args

OWN_CACHE_DIR = "feature_cache_dir"
SHARED = sorted(
    {f.name for f in dataclasses.fields(ref_config.TrainingConfig)}
    & ({f.name for f in dataclasses.fields(port_config.KokoroConfig)}
       | {f.name for f in dataclasses.fields(port_config.TrainingConfig)}))


def _assert_shared_equal(ours, theirs):
    model_cfg, train_cfg = ours
    for name in SHARED:
        mine = getattr(train_cfg if hasattr(train_cfg, name) else model_cfg, name)
        if name == OWN_CACHE_DIR:  # <data_dir>/.feature_cache_torch against .feature_cache
            assert Path(mine).parent == Path(getattr(theirs, name)).parent
            continue
        assert mine == getattr(theirs, name), name


def test_the_port_shares_the_reference_fields_it_reads():
    # the model widths, the training step's, the trainer's and the new
    # profiling / logging fields are all among them
    for name in ("hidden_dim", "use_flash_attention", "gradient_accumulation_steps",
                 "batch_order", "carry_tail", "pack_mode", "batch_size_multiple",
                 "enable_profiling", "profile_epoch_start", "profile_steps",
                 "enable_interbatch_profiling", "interbatch_report_interval",
                 "histogram_every_steps", "verbose"):
        assert name in SHARED, name


@pytest.mark.parametrize("preset", ["get_default_config", "get_low_memory_config",
                                    "get_high_performance_config", "get_smoke_test_config"])
def test_preset_matches_reference(preset, tmp_path):
    ours = getattr(port_config, preset)(data_dir=str(tmp_path))
    theirs = getattr(ref_config, preset)(data_dir=str(tmp_path))
    _assert_shared_equal(ours, theirs)


def test_high_performance_preset_fields_repaired():
    _, cfg = port_config.get_high_performance_config()
    assert (cfg.gradient_accumulation_steps, cfg.max_frames_per_batch, cfg.max_batch_size,
            cfg.batch_order, cfg.carry_tail, cfg.pack_mode, cfg.batch_size_multiple) == (
        1, 30000, 16, "shape_major", True, "bucket", 8)


def _parse(argv, tmp_path):
    argv = ["--data-dir", str(tmp_path), *argv]
    ours_p, ref_p = argparse.ArgumentParser(), argparse.ArgumentParser()
    port_args.add_training_arguments(ours_p)
    ref_add_arguments(ref_p)
    return (port_args.create_config_from_args(ours_p.parse_args(argv)),
            ref_config_from_args(ref_p.parse_args(argv)))


@pytest.mark.parametrize("argv", [
    ["--no-ema"], ["--profile-dtypes"], ["--compile-cache-dir", "cache"],
    ["--mesh-shape", "1"], ["--mesh-shape", "1,1", "--mesh-axes", "data,model"],
    ["--verbose", "--epochs", "3"],
], ids=["no_ema", "profile_dtypes", "compile_cache_dir", "mesh_shape_1", "mesh_axes",
        "verbose"])
def test_reference_flags_parse_to_the_same_fields(argv, tmp_path):
    ours, theirs = _parse(argv, tmp_path)
    _assert_shared_equal(ours, theirs)


@pytest.mark.parametrize("argv,option", [(["--no-ema"], "--no-ema"),
                                         (["--compile-cache-dir", "c"], "--compile-cache-dir")])
def test_flags_without_effect_warn(argv, option, tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="kokoro_tpu_torch.cli.args"):
        _parse(argv, tmp_path)
    assert sum(option in r.getMessage() for r in caplog.records) == 1


@pytest.mark.parametrize("argv", [["--mesh-shape", "2"], ["--mesh-shape", "4,2"],
                                  ["--distributed"]])
def test_parallel_flags_exit_naming_the_parallel_slice(argv, tmp_path):
    """The flags the parallel slice took over (they used to exit naming it):
    each now parses to the reference's fields, a 2-axis shape naming its
    second axis 'model' at mesh construction."""
    ours, theirs = _parse(argv, tmp_path)
    _assert_shared_equal(ours, theirs)
    _, cfg = ours
    if argv[0] == "--distributed":
        assert cfg.distributed_init is True
    else:
        assert cfg.mesh_shape == tuple(int(x) for x in argv[1].split(","))


def test_profile_dtypes_runs_the_ab_before_training(tmp_path, monkeypatch):
    from kokoro_tpu_torch.cli import train
    from kokoro_tpu_torch.training import trainer
    from kokoro_tpu_torch.utils import profiling

    calls = []
    monkeypatch.setattr(profiling, "profile_dtype_for_config",
                        lambda m, c, device: calls.append(("ab", device)) or "float32")
    monkeypatch.setattr(trainer, "train_model", lambda m, c, device: calls.append(
        ("train", c.compute_dtype)) or {"best_val_loss": 0.0, "best_val_epoch": 0})
    assert train.main(["--data-dir", str(tmp_path), "--device", "cpu", "--profile-dtypes"]) == 0
    assert calls == [("ab", "cpu"), ("train", "float32")]
