"""Per-layer stochastic-depth (drop-path) rates and the deepest decoder
branch's signal survival; ``--quick-ref`` prints the operator card first.

Port of ``scripts/stochastic_depth_summary.py``: the table is the
reference's line for line; the card names the port's files and says what
the port's drop path does in eager mode.  A host tool.

    python -m kokoro_tpu_torch.scripts.stochastic_depth_summary [--rate 0.1] \\
        [--encoder-layers 6] [--decoder-layers 6] [--decoder-dropout 0.2] [--quick-ref]
"""

from __future__ import annotations

import argparse

#: Operator quick-reference (the reference's card, re-expressed for the
#: port's file map and its eager drop path).
QUICK_REF = """\
STOCHASTIC DEPTH — QUICK REFERENCE
==================================
What: randomly drops whole transformer residual branches per sample during
training (dropout for layers).  Inference always runs every layer.

Config (kokoro_tpu_torch/config.py, KokoroConfig):
  use_stochastic_depth: bool   — enable/disable
  stochastic_depth_rate: float — max drop probability, LAST layer ({rate})
  Drop rate scales linearly with depth: layer i of n drops at
  (i / (n-1)) * rate; layer 0 never drops.  Mean ~= {mean_pct:.1f}%.

Where it lives:
  models/rng.py::drop_path   — per-SAMPLE branch gating, scaled 1/keep
  models/blocks.py           — applied to each residual branch's output
                               (folded stream drop_path_<i> per branch)
  models/kokoro.py           — linear per-layer rate assignment
  (eager PyTorch: every branch is still computed for the whole batch and
  then multiplied by a per-row bernoulli mask (torch.where); no branch is
  skipped, so there is NO wall-clock saving, only the regularization effect)

Tuning:  0.1 conservative (default) / 0.2 moderate / 0.3 aggressive.
Interactions: effective deepest-branch signal survival ~=
  (1-rate) x (1-decoder_dropout); see the table below.
Constraints: pipeline parallelism ('stage' mesh axis) requires
  use_stochastic_depth=False (config.validate_stage_axis; all stages share
  one DecoderBlock, parallel/pp_step.py).
Tests: tests/test_torch_training.py (steps with dropout on),
  tests/test_torch_parallel_pipeline.py (the 'stage' constraint),
  tests/test_torch_scripts.py (this table)
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rate", type=float, default=0.1)
    parser.add_argument("--encoder-layers", type=int, default=6)
    parser.add_argument("--decoder-layers", type=int, default=6)
    parser.add_argument("--decoder-dropout", type=float, default=0.20)
    parser.add_argument("--quick-ref", action="store_true",
                        help="print the operator quick-reference card")
    args = parser.parse_args(argv)

    def rates(n):
        return [(i / max(n - 1, 1)) * args.rate for i in range(n)]

    if args.quick_ref:
        print(QUICK_REF.format(rate=args.rate, mean_pct=100 * args.rate / 2))
    print("Linearly-scaled drop-path rates (reference model/model.py:100-107):")
    print(f"  encoder: {[round(r, 3) for r in rates(args.encoder_layers)]}")
    print(f"  decoder: {[round(r, 3) for r in rates(args.decoder_layers)]}")
    # survival estimate per decoder residual branch: keep_path x (1 - dropout)
    last = args.rate
    survival = (1 - last) * (1 - args.decoder_dropout)
    print(f"  deepest decoder branch signal survival ~= "
          f"(1-{last})(1-{args.decoder_dropout}) = {survival:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
