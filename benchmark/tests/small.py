"""Small cells for the CPU tests: the benchmark's own configurations at
smoke widths (hidden 128, two heads of 64, so that the packed routes are
taken), 2 + 2 layers, with small traffic of the same two kinds."""

from __future__ import annotations

import copy

from benchmark.run import cell

SMOKE_MODEL = dict(hidden_dim=128, n_heads=2, encoder_ff_dim=256, decoder_ff_dim=256,
                   n_encoder_layers=2, n_decoder_layers=2, variance_filter_size=32)


def small_cell(name: str, compute_dtype: str = "bfloat16") -> dict:
    c = copy.deepcopy(cell(name))
    c["config"]["model"].update(SMOKE_MODEL)
    c["config"]["training"]["compute_dtype"] = compute_dtype
    c["cell"].update(block_rows=3, warm_steps=0, profiled_steps=2)
    mix = c["traffic"]
    if mix["kind"] == "corpus":
        mix["clusters"] = [{"count": 10, "seconds": [0.7, 0.9], "phonemes": [10, 16]},
                           {"count": 8, "seconds": [1.1, 1.4], "phonemes": [17, 24]}]
        mix["training"].update(max_seq_length=128, mel_bucket_sizes=[80, 96, 128],
                               phoneme_bucket_sizes=[16, 24], max_frames_per_batch=1024,
                               max_batch_size=8)
    else:
        mix.update(rows=6, phonemes=24, frames=128, mel_lengths=[100, 128],
                   phoneme_lengths=[16, 24])
    return c
