"""Phoneme-vocabulary coverage over a corpus: which vocabulary tokens occur,
the most frequent ones, and any phoneme the G2P produces outside the
vocabulary.

Port of ``scripts/check_phoneme_coverage.py`` on the port's copies of
``data/mfa._read_metadata``, ``data/text_utils.flatten_with_sil`` and
``data/phonemes.RussianPhonemeProcessor``; its output is the reference's
line for line.  A host tool: it touches no device.

    python -m kokoro_tpu_torch.scripts.check_phoneme_coverage --corpus DIR [--limit N]

Exits 1 when the corpus has no metadata or the G2P produced an unknown
phoneme.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--corpus", required=True)
    parser.add_argument("--limit", type=int, default=0, help="max utterances")
    args = parser.parse_args(argv)

    from kokoro_tpu_torch.data import text_utils
    from kokoro_tpu_torch.data.mfa import _read_metadata
    from kokoro_tpu_torch.data.phonemes import RussianPhonemeProcessor

    proc = RussianPhonemeProcessor()
    metadata = _read_metadata(Path(args.corpus))
    if args.limit:
        metadata = metadata[: args.limit]
    if not metadata:
        print("no metadata found", file=sys.stderr)
        return 1

    counts: Counter = Counter()
    unknown: Counter = Counter()
    for _stem, text in metadata:
        raw = proc.process_text(text)
        for ph in text_utils.flatten_with_sil(raw, proc.phoneme_to_id):
            if ph in proc.phoneme_to_id:
                counts[ph] += 1
            else:
                unknown[ph] += 1

    vocab = set(proc.phoneme_to_id)
    used = set(counts)
    print(f"Utterances: {len(metadata)}")
    print(f"Vocab size: {len(vocab)}, used: {len(used)} "
          f"({len(used)/len(vocab)*100:.1f}% coverage)")
    unused = sorted(vocab - used)
    if unused:
        print(f"Unused tokens ({len(unused)}): {unused}")
    if unknown:
        print(f"UNKNOWN phonemes produced by G2P: {dict(unknown)}")
        return 1
    print("Top 15:", counts.most_common(15))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
