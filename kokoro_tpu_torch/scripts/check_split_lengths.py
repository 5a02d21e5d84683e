"""Train/validation split length check: are the mel and phoneme length
statistics of the seed-42 split comparable between its two sides?

Port of ``scripts/check_split_lengths.py`` on the port's
``data/dataset.{RuslanDataset, train_val_split}``; its output is the
reference's line for line.  The port's ``get_default_config`` returns
``(KokoroConfig, TrainingConfig)``, where the reference's returns one
config.  A host tool: lengths come from the WAV headers and the G2P, on the
CPU.

    python -m kokoro_tpu_torch.scripts.check_split_lengths --corpus DIR \\
        [--validation-split 0.1] [--seed 42]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--corpus", required=True)
    parser.add_argument("--validation-split", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    from kokoro_tpu_torch.config import get_default_config
    from kokoro_tpu_torch.data.dataset import RuslanDataset, train_val_split

    model_cfg, cfg = get_default_config(data_dir=args.corpus, use_mfa=False)
    ds = RuslanDataset(args.corpus, model_cfg, cfg, is_training=False)
    train_idx, val_idx = train_val_split(len(ds), args.validation_split, args.seed)

    def stats(indices):
        if not indices:
            return {"n": 0}
        frames = np.array([ds.lengths(i)[0] for i in indices])
        phons = np.array([ds.lengths(i)[1] for i in indices])
        return {
            "n": len(indices),
            "frames_mean": round(float(frames.mean()), 1),
            "frames_p50": int(np.median(frames)),
            "frames_max": int(frames.max()),
            "phonemes_mean": round(float(phons.mean()), 1),
        }

    tr, va = stats(train_idx), stats(val_idx)
    print("train:", tr)
    print("val:  ", va)
    if tr["n"] and va["n"]:
        drift = abs(tr["frames_mean"] - va["frames_mean"]) / max(tr["frames_mean"], 1)
        print(f"mean-frame drift: {drift*100:.1f}%", "(OK)" if drift < 0.1 else "(WARN)")
    else:
        print("split too small for drift statistics (empty side)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
