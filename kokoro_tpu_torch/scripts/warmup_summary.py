"""Print the per-group learning-rate schedule table: the rate of each of the
ten parameter groups at step 0, mid-warm-up, the end of warm-up and 25, 50,
90 and 100 % of the run.

Port of ``scripts/warmup_summary.py`` on the port's
``training/optimizer.{GROUP_LABELS, make_group_schedule}``, whose schedules
are plain Python functions of the step: there is no device to keep them off
(the reference forces JAX onto the CPU).  The table is the reference's line
for line.

    python -m kokoro_tpu_torch.scripts.warmup_summary [--total-steps 20310] \\
        [--learning-rate 5e-5] [--warmup-steps 1200]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--total-steps", type=int, default=20310)
    parser.add_argument("--learning-rate", type=float, default=5e-5)
    parser.add_argument("--warmup-steps", type=int, default=1200)
    args = parser.parse_args(argv)

    from kokoro_tpu_torch.config import get_default_config
    from kokoro_tpu_torch.training.optimizer import GROUP_LABELS, make_group_schedule

    _, cfg = get_default_config(learning_rate=args.learning_rate,
                                warmup_steps=args.warmup_steps)
    total = args.total_steps
    probes = [0, args.warmup_steps // 2, args.warmup_steps,
              int(0.25 * total), int(0.5 * total), int(0.9 * total), total - 1]
    print(f"{'group':24} " + " ".join(f"{p:>10}" for p in probes))
    for label in GROUP_LABELS:
        sched = make_group_schedule(cfg, total, label)
        row = " ".join(f"{float(sched(p)):.2e}" for p in probes)
        print(f"{label:24} {row}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
