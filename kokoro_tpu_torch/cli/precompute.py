"""kokoro-precompute of the PyTorch port: fill the feature cache ahead of
training.

    python -m kokoro_tpu_torch.cli.precompute --data-dir <corpus> [--mfa-alignment-dir <dir>] [--device cpu]

Port of ``kokoro_tpu/cli/precompute.py``.  Every utterance's log-mel, pitch
and energy are computed in torch on the device (``FeatureExtractor``) and
written, with its durations (MFA when the alignments are there), into the
``.npz`` cache the trainer reads; entries that are up to date are skipped.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
from kokoro_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def precompute_features(model_config: KokoroConfig, config: TrainingConfig,
                        device: str | torch.device = "cuda") -> dict:
    """Touch every utterance to fill the on-disk feature cache, skipping the
    entries that load; returns the reference's stats (``total``,
    ``computed``, ``skipped``, ``failed``, ``cache_version``,
    ``cache_size_mb``, ``elapsed_s``).  ``device`` defaults to CUDA and
    raises without it."""
    from kokoro_tpu_torch.data.dataset import FEATURE_CACHE_VERSION, RuslanDataset
    from kokoro_tpu_torch.data.mfa import MFAIntegration

    device = resolve_device(device)
    mfa = None
    if config.use_mfa and Path(config.mfa_alignment_dir).exists():
        mfa = MFAIntegration(alignment_dir=config.mfa_alignment_dir,
                             hop_length=model_config.hop_length,
                             sample_rate=model_config.sample_rate)
    dataset = RuslanDataset(config.data_dir, model_config, config, is_training=False,
                            device=device, mfa=mfa)
    rng = np.random.default_rng(config.seed)
    t0 = time.time()
    computed = skipped = failed = 0
    for idx in range(len(dataset)):
        stem = dataset.samples[idx]["audio_file"]
        if ((dataset.feature_cache_dir / f"{stem}.npz").exists()
                and dataset._load_cached(stem) is not None):
            skipped += 1
            continue
        try:
            dataset.get_features(idx, rng)
            computed += 1
        except Exception as err:
            failed += 1
            logger.error("Feature computation failed for %s: %s", stem, err)
        if (computed + skipped) % 500 == 0:
            logger.info("precompute: %d/%d done (%.1f/s)", computed + skipped, len(dataset),
                        (computed + skipped) / max(time.time() - t0, 1e-9))
    size_mb = sum(f.stat().st_size for f in dataset.feature_cache_dir.glob("*.npz")) / 1e6
    stats = {
        "total": len(dataset), "computed": computed, "skipped": skipped, "failed": failed,
        "cache_version": FEATURE_CACHE_VERSION, "cache_size_mb": round(size_mb, 1),
        "elapsed_s": round(time.time() - t0, 1),
    }
    logger.info("Precompute summary: %s", stats)
    return stats


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="kokoro-precompute-torch",
        description="Precompute mel/pitch/energy features and durations into the cache")
    from kokoro_tpu_torch.cli.args import add_training_arguments, create_config_from_args

    add_training_arguments(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    precompute_features(*create_config_from_args(args), device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
