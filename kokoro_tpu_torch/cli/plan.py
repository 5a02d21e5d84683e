"""kokoro-plan of the PyTorch port: the training step's device memory per
bucket and batch-size advice, before anything is allocated.

    python -m kokoro_tpu_torch.cli.plan [training arguments] [--hbm-gib G] [--json]

Port of ``kokoro_tpu/cli/plan.py`` on ``utils/memory_planner.py``'s H100
model: the same table (or, with ``--json``, the same document) from the
configured buckets.  The budget is ``--hbm-gib`` or the card's
(``live_hbm_bytes``); with neither, it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="kokoro-plan-torch",
        description="Estimate the training step's device memory per bucket and recommend "
                    "batch sizes (advisory)")
    from kokoro_tpu_torch.cli.args import add_training_arguments, create_config_from_args

    add_training_arguments(parser)
    parser.add_argument("--hbm-gib", type=float, default=None,
                        help="usable device memory in GiB (default: the card's)")
    parser.add_argument("--safety-margin", type=float, default=0.9,
                        help="fraction of the device memory the plan may fill (default 0.9)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit the plan as one JSON document")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    model_config, config = create_config_from_args(args)

    from kokoro_tpu_torch.utils.memory_planner import (
        _bucket_lists, count_params, estimate_train_step_hbm, live_hbm_bytes, plan_buckets,
        recommend_settings,
    )

    if args.hbm_gib is not None:
        hbm = int(args.hbm_gib * 1024**3)
    else:
        hbm = live_hbm_bytes()
        if hbm is None:
            parser.error("no CUDA device to read the memory of: pass --hbm-gib")
    n_params = count_params(model_config, vocab_size=128)
    rows = plan_buckets(model_config, config, hbm, n_params=n_params,
                        safety_margin=args.safety_margin)
    rec = recommend_settings(model_config, config, hbm, n_params=n_params)
    if args.as_json:
        print(json.dumps({"hbm_bytes": hbm, "buckets": rows, "recommendation": rec}, indent=2))
        return 0

    print(f"HBM budget: {hbm / 1024**3:.2f} GiB (safety margin {args.safety_margin})")
    print(f"Model parameters: {rec['n_params']:,}")
    print()
    print(f"{'mel T':>7} {'phon L':>7} {'cfg B':>6} {'est GiB':>8} {'fits':>5} {'max B':>6}  flags")
    for r in rows:
        flags = ",".join(f for f, on in (("flash", r["flash_active"]),
                                         ("remat", r["remat_active"])) if on) or "-"
        print(f"{r['mel_frames']:>7} {r['phoneme_len']:>7} {r['configured_batch']:>6} "
              f"{r['estimate_gib']:>8.2f} {str(r['configured_fits']):>5} "
              f"{r['max_batch']:>6}  {flags}")
    print()
    print("Recommendation at the largest bucket:")
    for k, v in rec.items():
        if k != "notes":
            print(f"  {k}: {v}")
    for note in rec["notes"]:
        print(f"  note: {note}")
    mels, phons = _bucket_lists(config)
    est = estimate_train_step_hbm(model_config, config, config.batch_size, mels[-1], phons[-1],
                                  n_params=n_params)
    print(f"  configured-step estimate: {est.summary()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
