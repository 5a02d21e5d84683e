"""kokoro-preprocess of the PyTorch port: corpus validation and the MFA
alignment workflow.

    python -m kokoro_tpu_torch.cli.preprocess --corpus <corpus> --output ./mfa_output
    python -m kokoro_tpu_torch.cli.preprocess --corpus <corpus> --output ./mfa_output --validate-only

Port of ``kokoro_tpu/cli/preprocess.py``.  Without ``--skip-mfa`` or
``--validate-only`` it runs ``setup_mfa_for_corpus`` (the ``mfa`` binary,
its ``russian_mfa`` models, corpus staging and ``mfa align``) and writes
``<output>/alignments/<stem>.TextGrid``, the directory training reads
(``--mfa-alignment-dir``).  ``--validate-only`` prints the alignment coverage
of ``MFAIntegration.validate_alignments`` as one JSON line.  Host code only:
nothing runs on the card.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

logger = logging.getLogger(__name__)


def validate_corpus(corpus_dir: str) -> dict:
    """Structure validation: metadata and wavs present, counts consistent."""
    corpus = Path(corpus_dir)
    issues = []
    meta = next((corpus / name for name in ("metadata_RUSLAN_22200.csv", "metadata.csv")
                 if (corpus / name).exists()), None)
    if meta is None:
        issues.append("no metadata CSV (metadata_RUSLAN_22200.csv / metadata.csv)")
    wav_dir = next((corpus / name for name in ("wavs", "wav", "audio")
                    if (corpus / name).is_dir()), None)
    if wav_dir is None:
        issues.append("no wavs/ directory")
    n_meta = n_wavs = n_matched = 0
    if meta is not None and wav_dir is not None:
        stems = set()
        for line in meta.read_text(encoding="utf-8").splitlines():
            parts = line.split("|")
            if len(parts) >= 2:
                n_meta += 1
                stems.add(parts[0].strip())
        wavs = {p.stem for p in wav_dir.glob("*.wav")}
        n_wavs = len(wavs)
        n_matched = len(stems & wavs)
        if n_matched == 0:
            issues.append("no metadata entries match any wav file")
    return {"valid": not issues, "issues": issues, "metadata_entries": n_meta,
            "wav_files": n_wavs, "matched": n_matched}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="kokoro-preprocess-torch",
        description="Validate the corpus and run MFA forced alignment")
    parser.add_argument("--corpus", required=True, help="corpus directory")
    parser.add_argument("--output", default="./mfa_output")
    parser.add_argument("--metadata", default="metadata_RUSLAN_22200.csv")
    parser.add_argument("--num-jobs", type=int, default=4)
    parser.add_argument("--skip-mfa", action="store_true")
    parser.add_argument("--validate-only", action="store_true",
                        help="report alignment coverage without running MFA")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    report = validate_corpus(args.corpus)
    logger.info("Corpus validation: %s", report)
    if not report["valid"]:
        return 1
    if args.validate_only:
        from kokoro_tpu_torch.data.mfa import MFAIntegration

        mfa = MFAIntegration(alignment_dir=str(Path(args.output) / "alignments"))
        meta = Path(args.corpus) / args.metadata
        if not meta.exists():
            meta = Path(args.corpus) / "metadata.csv"
        print(json.dumps(mfa.validate_alignments(str(meta))), flush=True)
        return 0
    if args.skip_mfa:
        logger.info("--skip-mfa: corpus validated, MFA skipped")
        return 0

    from kokoro_tpu_torch.data.mfa import setup_mfa_for_corpus

    setup_mfa_for_corpus(args.corpus, args.output, metadata_file=args.metadata,
                         num_jobs=args.num_jobs)
    logger.info("MFA alignment complete: %s/alignments", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
