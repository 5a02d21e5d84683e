"""Feature-cache status and clearing.

    python -m kokoro_tpu_torch.utils.cache_manager --corpus DIR [--cache-dir DIR] --status|--clear

Port of ``kokoro_tpu/utils/cache_manager.py``.  The default cache is the
port's ``<corpus>/.feature_cache_torch`` (``config.TrainingConfig``); the
health check samples up to 50 entries and counts as corrupt one that does
not load or whose ``cache_version`` is not the port's
``FEATURE_CACHE_VERSION`` (the dataset recomputes such an entry).
"""

from __future__ import annotations

import argparse
import logging
import shutil
from pathlib import Path
from typing import Optional

import numpy as np

from kokoro_tpu_torch.data.dataset import FEATURE_CACHE_VERSION

logger = logging.getLogger(__name__)


def _cache_path(corpus_dir: str, cache_dir: Optional[str]) -> Path:
    return Path(cache_dir) if cache_dir else Path(corpus_dir) / ".feature_cache_torch"


def cache_status(corpus_dir: str, cache_dir: Optional[str] = None) -> dict:
    cache = _cache_path(corpus_dir, cache_dir)
    if not cache.exists():
        return {"exists": False, "path": str(cache)}
    files = list(cache.glob("*.npz"))
    corrupt = 0
    for f in files[:50]:  # sample-based health check
        try:
            with np.load(f, allow_pickle=False) as z:
                if int(z["cache_version"]) != FEATURE_CACHE_VERSION:
                    corrupt += 1
        except (OSError, ValueError, KeyError):
            corrupt += 1
    return {
        "exists": True,
        "path": str(cache),
        "entries": len(files),
        "size_mb": round(sum(f.stat().st_size for f in files) / 1e6, 1),
        "sampled_corrupt": corrupt,
    }


def cache_clear(corpus_dir: str, cache_dir: Optional[str] = None) -> bool:
    cache = _cache_path(corpus_dir, cache_dir)
    if cache.exists():
        shutil.rmtree(cache)
        logger.info("Cleared feature cache at %s", cache)
        return True
    logger.info("No feature cache at %s", cache)
    return False


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Feature cache management")
    parser.add_argument("--corpus", required=True)
    parser.add_argument("--cache-dir", default=None)
    action = parser.add_mutually_exclusive_group(required=True)
    action.add_argument("--status", action="store_true")
    action.add_argument("--clear", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.status:
        print(cache_status(args.corpus, args.cache_dir))
    else:
        cache_clear(args.corpus, args.cache_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
