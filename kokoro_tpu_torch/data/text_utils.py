"""Phoneme-sequence assembly utilities.

Parity with reference data/audio_utils.py ``PhonemeProcessorUtils``:

* ``flatten_with_sil`` (:203-262): inter-word ``<sil>`` + prosody punct tokens
  — token order ``[word phonemes] [<punct>] [<sil>] [next word ...]`` so the
  training input matches MFA's phone-tier distribution,
* ``stress_indices_with_sil`` (:265-335): a parallel stress-ID sequence
  (0 = unstressed/special, 1 = primary stress, 2 = reserved secondary),
* ``phonemes_to_indices`` (:338-356): vocab lookup with unk fallback.

The PyTorch port's own copy of ``kokoro_tpu/data/text_utils.py``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_VOWEL_PREFIXES = ("ja", "jo", "ju", "je", "jɐ", "jɪ", "jə",
                   "a", "o", "u", "ɨ", "e", "i", "ə", "ɐ", "ɪ")


def is_vowel_phoneme(ph: str) -> bool:
    return any(ph.startswith(v) for v in _VOWEL_PREFIXES)


def flatten_plain(raw_output: Sequence[Tuple]) -> List[str]:
    """Concatenate word phoneme lists with no separators."""
    out: List[str] = []
    for item in raw_output:
        if isinstance(item, tuple) and len(item) >= 2 and isinstance(item[1], list):
            out.extend(p for p in item[1] if isinstance(p, str) and p)
    return out


def flatten_with_sil(
    raw_output: Sequence[Tuple], phoneme_to_id: Dict[str, int]
) -> List[str]:
    """Flatten ``process_text`` output with inter-word ``<sil>`` and prosody
    tokens.  Falls back to plain flattening when the vocab predates ``<sil>``."""
    if "<sil>" not in phoneme_to_id:
        logger.warning(
            "flatten_with_sil: '<sil>' missing from vocab; plain flatten"
        )
        return flatten_plain(raw_output)
    out: List[str] = []
    n_words = 0
    for item in raw_output:
        if not (isinstance(item, tuple) and len(item) >= 3 and isinstance(item[1], list)):
            out.extend(flatten_plain([item]))
            continue
        phonemes = item[1]
        punct: Optional[str] = (
            item[3] if len(item) >= 4 and isinstance(item[3], str) else None
        )
        if n_words > 0:
            out.append("<sil>")
        out.extend(p for p in phonemes if isinstance(p, str) and p)
        if punct:
            out.append(punct)
        n_words += 1
    return out


def stress_indices_with_sil(
    raw_output: Sequence[Tuple], phoneme_to_id: Dict[str, int]
) -> List[int]:
    """Stress-ID sequence exactly parallel to :func:`flatten_with_sil`."""
    has_sil = "<sil>" in phoneme_to_id
    out: List[int] = []
    n_words = 0
    for item in raw_output:
        if not (isinstance(item, tuple) and len(item) >= 3 and isinstance(item[1], list)):
            continue
        phonemes, stress_info = item[1], item[2]
        punct: Optional[str] = (
            item[3] if len(item) >= 4 and isinstance(item[3], str) else None
        )
        if has_sil and n_words > 0:
            out.append(0)
        stressed_pos = stress_info.position if stress_info is not None else -1
        vowel_count = 0
        emitted = False
        for ph in phonemes:
            if not isinstance(ph, str) or not ph:
                continue
            if is_vowel_phoneme(ph):
                if not emitted and vowel_count == stressed_pos:
                    out.append(1)
                    emitted = True
                else:
                    out.append(0)
                vowel_count += 1
            else:
                out.append(0)
        if punct:
            out.append(0)
        n_words += 1
    return out


def phonemes_to_indices(
    phoneme_sequence: Sequence[str], phoneme_to_id: Dict[str, int]
) -> List[int]:
    """Vocab lookup with 1:1 length mapping; unknown -> <unk>/<sil>/0."""
    unk = phoneme_to_id.get("<unk>", phoneme_to_id.get("<sil>", 0))
    out: List[int] = []
    for p in phoneme_sequence:
        if p in phoneme_to_id:
            out.append(phoneme_to_id[p])
        else:
            logger.warning("Phoneme %r not in vocab; mapped to %d", p, unk)
            out.append(unk)
    if not out:
        raise ValueError("No valid phoneme indices generated")
    return out
