"""The quality run's two phases through both trainers, on the CPU, for
``tests/test_torch_quality_run.py`` and ``tests/test_torch_regression_analyzer.py``.

One synthetic corpus of :data:`N_UTTS` short-mode utterances
(``kokoro_tpu_torch.scripts.quality_run.build_corpus``, byte for byte the
reference's) trains under the quality run's configuration
(``quality_run.config_overrides``) at small widths (:data:`SMALL`: hidden 64,
2+2 layers, 2 heads, ff 128) in f32, with dropout, stochastic depth and
SpecAugment off, so that both runs are deterministic; batches of at most 4
rows give two microbatches a step, and every step is logged
(``log_every_steps=1``).  The JAX trainer (``kokoro_tpu.training.trainer``,
on a one-device mesh) runs epochs 1..2, then a second trainer resumes from
``auto`` through epoch 4; the port's ``KokoroTrainer`` does the same from the
JAX trainer's initial parameters (``init_params``, through
``convert.kokoro_state_dict_from_flax``), with the quality run's own
``recording_trainer``.  Both trainers write ``logs/metrics.jsonl`` (the
JSONL writer of each package: the card's machine has no tensorboard, and
the analyzer reads the JSONL first).  Each extracts its own features: the
two extractors agree within ``tests/test_torch_features.py``'s tolerance,
and the runs' histories agree to about 1e-5, so no shared feature cache is
needed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

N_UTTS = 9       # 8 train, 1 validation under the seed-42 split
EPOCHS = 4       # break after epoch 2, where save_every=2 leaves a checkpoint
SMALL = dict(hidden_dim=64, n_encoder_layers=2, n_decoder_layers=2, n_heads=2,
             encoder_ff_dim=128, decoder_ff_dim=128, variance_filter_size=32,
             encoder_dropout=0.0, decoder_dropout=0.0, decoder_input_dropout=0.0,
             variance_dropout=0.0, use_stochastic_depth=False, use_spec_augment=False,
             compute_dtype="float32", max_batch_size=4, log_every_steps=1)


def _overrides(corpus: Path, run_dir: Path, num_epochs: int) -> dict:
    from kokoro_tpu_torch.scripts.quality_run import config_overrides

    out = config_overrides(corpus, run_dir, EPOCHS, long_mode=False)
    out.update(SMALL, num_epochs=num_epochs)
    return out


def run_both(root: Path) -> dict:
    """Both packages' two-phase runs under ``root``; returns what the tests
    compare: the item ids of each step's microbatches, the optimizer steps at
    the break and at the end, the skipped steps, the trainers' results, the
    history rows, the run directories and the JAX trainer's initial
    parameters (flat numpy, flax paths)."""
    from flax.traverse_util import flatten_dict

    import kokoro_tpu.training.trainer as jt
    import kokoro_tpu_torch.training.trainer as pt
    from kokoro_tpu.config import get_default_config as ref_config
    from kokoro_tpu_torch.config import get_default_config as port_config
    from kokoro_tpu_torch.convert import kokoro_state_dict_from_flax
    from kokoro_tpu_torch.scripts.quality_run import build_corpus, history_row, recording_trainer

    corpus = root / "corpus"
    build_corpus(corpus, N_UTTS)
    half = EPOCHS // 2
    out = {"batches": {"jax": [], "port": []}, "history": {"jax": [], "port": []},
           "run_dir": {"jax": root / "jax_run", "port": root / "port_run"}}

    def recording_assemble(cls, key):
        original = cls._assemble

        def _assemble(self, group, rng):
            out["batches"][key].append([[int(i) for i in g] for g in group])
            return original(self, group, rng)

        return _assemble

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jt, "_make_writer", jt._JsonlWriter)
        mp.setattr(pt, "_make_writer", pt._JsonlWriter)
        mp.setattr(jt.KokoroTrainer, "_assemble", recording_assemble(jt.KokoroTrainer, "jax"))
        mp.setattr(pt.KokoroTrainer, "_assemble", recording_assemble(pt.KokoroTrainer, "port"))

        class JaxRecordingTrainer(jt.KokoroTrainer):
            """The reference quality run's ``RecordingTrainer``."""

            def validate_epoch(self, epoch):
                metrics = super().validate_epoch(epoch)
                train = {k: v / max(self._epoch_steps, 1) for k, v in self._epoch_sums.items()}
                out["history"]["jax"].append(
                    history_row(epoch, int(self.state.opt_step), train, metrics))
                return metrics

        def jax_cfg(num_epochs):
            return ref_config(mesh_shape=(1,), **_overrides(corpus, out["run_dir"]["jax"],
                                                            num_epochs))

        first = JaxRecordingTrainer(jax_cfg(half))
        init = {k: np.asarray(v) for k, v in flatten_dict(first.state.params, sep="/").items()}
        first.train()
        jax_break = int(first.state.opt_step)
        second = JaxRecordingTrainer(jax_cfg(EPOCHS))
        jax_result = second.train()
        out["jax"] = dict(step_at_break=jax_break, final_step=int(second.state.opt_step),
                          skipped=int(second.state.skipped_steps), result=jax_result)
        del first, second

        steps, validations = [], []
        Port = recording_trainer(out["history"]["port"], steps, validations)
        init_params = kokoro_state_dict_from_flax(init)

        def port_trainer(num_epochs):
            return Port(*port_config(**_overrides(corpus, out["run_dir"]["port"], num_epochs)),
                        device="cpu", init_params=init_params)

        first = port_trainer(half)
        first.train()
        port_break = first.state.opt_step
        second = port_trainer(EPOCHS)
        port_result = second.train()
        out["port"] = dict(step_at_break=port_break, final_step=second.state.opt_step,
                           skipped=second.state.skipped_steps, result=port_result,
                           resumed_step=second.resumed_step, steps=steps)
    out["init"] = init
    return out
