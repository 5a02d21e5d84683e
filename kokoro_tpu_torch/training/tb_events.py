"""Log hygiene on crash-resume: purge the records past the restored step.

Port of ``kokoro_tpu/training/tb_events.py``.  A crash after the last
checkpoint leaves scalars logged PAST its step; the resumed run would log
those steps again into the same logdir.  Each existing event file is
rewritten in place (atomic tmp + rename), keeping only records at or before
the restored step; TensorBoard merges the event files of one logdir by step,
so the old files and the resumed run's new file form one monotonic,
duplicate-free series per tag.  The filter works on raw event records
(scalars, images and histograms alike).  The ``metrics.jsonl`` the trainer
writes when tensorboard is not installed is purged the same way.
tensorboard is imported only when a tfevents file is there to purge.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Dict

logger = logging.getLogger(__name__)


def _purge_tfevents_file(path: Path, max_step: int) -> int:
    """Rewrite one events.out.tfevents.* file, dropping summary records with
    step > max_step.  Returns the number of dropped records."""
    from tensorboard.backend.event_processing.event_file_loader import (
        RawEventFileLoader,
    )
    from tensorboard.compat.proto import event_pb2
    from tensorboard.summary.writer.record_writer import RecordWriter

    kept, dropped = [], 0
    for raw in RawEventFileLoader(str(path)).Load():
        ev = event_pb2.Event.FromString(raw)
        # Step-less bookkeeping records (file_version, graph defs, custom
        # scalar layouts carry step 0) always survive; only stepped summary
        # payloads past the restore point are dropped.
        if ev.HasField("summary") and ev.step > max_step:
            dropped += 1
            continue
        kept.append(raw)
    if not dropped:
        return 0
    tmp = path.with_name(path.name + ".purge_tmp")
    with open(tmp, "wb") as f:
        writer = RecordWriter(f)
        for raw in kept:
            writer.write(raw)
        writer.flush()
    os.replace(tmp, path)
    return dropped


def _purge_jsonl_file(path: Path, max_step: int) -> int:
    """Purge the fallback ``metrics.jsonl`` writer's log with the same
    step <= max_step filter."""
    kept, dropped = [], 0
    for line in path.read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        try:
            if int(json.loads(line).get("step", 0)) > max_step:
                dropped += 1
                continue
        except (ValueError, TypeError):
            pass  # unparseable lines survive (same spirit as step-less records)
        kept.append(line)
    if dropped:
        tmp = path.with_name(path.name + ".purge_tmp")
        tmp.write_text("\n".join(kept) + ("\n" if kept else ""), encoding="utf-8")
        os.replace(tmp, path)
    return dropped


def purge_events_after(logdir: Path, max_step: int) -> Dict[str, int]:
    """Purge every event file in ``logdir`` of records past ``max_step``.

    Call with all writers into ``logdir`` CLOSED.  Returns per-file dropped
    counts (empty dict when nothing needed purging).  Best-effort per file: a
    corrupt file is left untouched rather than failing the resume."""
    logdir = Path(logdir)
    stats: Dict[str, int] = {}
    if not logdir.is_dir():
        return stats
    for path in sorted(logdir.iterdir()):
        if not path.is_file():
            continue
        try:
            if "tfevents" in path.name:
                dropped = _purge_tfevents_file(path, max_step)
            elif path.name == "metrics.jsonl":
                dropped = _purge_jsonl_file(path, max_step)
            else:
                continue
        except Exception as err:
            logger.warning("TB purge skipped %s: %s", path.name, err)
            continue
        if dropped:
            stats[path.name] = dropped
    if stats:
        logger.info(
            "Purged %d stale event record(s) past step %d from %d file(s): %s",
            sum(stats.values()), max_step, len(stats), dict(stats),
        )
    return stats
