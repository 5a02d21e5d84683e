"""Montreal Forced Aligner integration: TextGrid parsing, phone normalization,
and Needleman-Wunsch duration alignment.

Port of ``kokoro_tpu/data/mfa.py`` (framework-free there too; the port keeps
its own copy):

* 26-entry MFA phone normalization (dental diacritics, palatal symbols,
  length marks),
* DP alignment with costed ops: match 0 / mismatch 3 / skip-MFA 1.5 (frames
  pool into ``pending``) / insert ``<sil>`` 0.05 / prosody 0 / real phone 2 /
  iotation j+V -> jV merge 0 / geminate Xː -> X X split 0 / ``spn`` 1:N
  expansion 0.2/phone (max 40) — output length == text phoneme length,
* ``get_aligned_durations`` strips outer silences into neighbors,
* frames = int(seconds * sample_rate / hop_length),
* binary discovery incl. conda paths, model download, corpus prep, ``mfa
  align`` subprocess with timeout.

The Python DP below is the reference semantics; ``align_durations`` runs the
C++ DP of ``csrc/aligner.cpp`` (``kokoro_tpu_torch.native``) when it builds,
and falls back to the Python one, with a warning, when it does not.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import subprocess
import unicodedata
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Phone label normalization (MFA russian_mfa inventory -> our G2P inventory)
# ---------------------------------------------------------------------------

MFA_PHONE_MAP: Dict[str, str] = {
    "s̪": "s", "t̪": "t", "n̪": "n", "d̪": "d", "z̪": "z",
    "t̪s̪": "ts",
    "ɫ": "l", "ʎ": "lʲ",
    "ɲ": "nʲ",
    "ʂ": "ʃ", "ɕː": "ʃtʃ", "ç": "xʲ",
    "ɡ": "g", "c": "kʲ", "ɟ": "gʲ",
    "tɕ": "tʃ", "tʂː": "tʃ", "dʐː": "ʐ", "ʑː": "zʲ",
    "ɛ": "e", "ʊ": "u", "æ": "a", "ʉ": "u", "ɵ": "o",
}

# MFA splits iotated vowels into j + vowel; our G2P emits single tokens.
IOTATED = {"ja": "a", "jo": "o", "ju": "u", "je": "e",
           "jɐ": "ɐ", "jɪ": "ɪ", "jə": "ə"}

PROSODY_TOKENS = frozenset({"<period>", "<exclaim>", "<question>", "<comma>"})

LENGTH_MARK = "ː"


def normalize_mfa_phone(label: str) -> str:
    """Map an MFA phone label into the G2P inventory (reference :74-108)."""
    if label in MFA_PHONE_MAP:
        return MFA_PHONE_MAP[label]
    nfc = unicodedata.normalize("NFC", label)
    if nfc in MFA_PHONE_MAP:
        return MFA_PHONE_MAP[nfc]
    if nfc.endswith(LENGTH_MARK):
        base = normalize_mfa_phone(nfc[:-1])
        if base != nfc[:-1]:
            return base + LENGTH_MARK
    stripped = "".join(
        ch for ch in nfc if unicodedata.category(ch) not in ("Mn", "Mc", "Me")
    )
    if stripped != nfc:
        return MFA_PHONE_MAP.get(stripped, stripped)
    return label


def phones_equivalent(mfa_phone: str, g2p_phone: str) -> bool:
    if mfa_phone == g2p_phone:
        return True
    # geminate: Xː matches a single X
    return mfa_phone.endswith(LENGTH_MARK) and mfa_phone[:-1] == g2p_phone


# ---------------------------------------------------------------------------
# Needleman-Wunsch alignment with TTS-specific ops
# ---------------------------------------------------------------------------

# Cost constants (trained-in behavior, reference :157-168)
COST_MATCH = 0.0
COST_MISMATCH = 3.0
COST_SKIP_MFA = 1.5
COST_SKIP_SIL = 0.05
COST_SKIP_PROSODY = 0.0
COST_SKIP_PHONE = 2.0
COST_IOTATION = 0.0
COST_GEMINATE = 0.0
COST_SPN_PER_PHONE = 0.2
MAX_SPN_SPAN = 40


def align_durations(
    mfa_labeled: List[Tuple[str, int]],
    text_phones: List[str],
    use_native: bool = True,
) -> Optional[List[int]]:
    """Align (phone, frames) pairs from MFA onto the G2P phoneme sequence.

    Guarantees ``len(result) == len(text_phones)``; total frames are conserved
    (dropped MFA frames pool into the next matched phone; a trailing pool goes
    into the last phone).  Returns None only when no path exists.

    Dispatches to the C++ DP core (``csrc/aligner.cpp``) when it builds; this
    Python implementation is the reference semantics and the fallback.
    """
    if use_native:
        try:
            from kokoro_tpu_torch.native import native_align_durations, native_available

            if native_available():
                return native_align_durations(
                    mfa_labeled, text_phones,
                    phones_equivalent=phones_equivalent,
                    iotated=IOTATED,
                    prosody_tokens=PROSODY_TOKENS,
                    length_mark=LENGTH_MARK,
                )
        except Exception as err:  # never let the native path break alignment
            logger.warning("Native aligner failed (%s); using Python DP", err)

    n, m = len(mfa_labeled), len(text_phones)
    if m == 0:
        return []
    if n == 0:
        return [0] * m

    INF = float("inf")
    dp = [[INF] * (m + 1) for _ in range(n + 1)]
    back: List[List[Optional[Tuple[int, int, str]]]] = [
        [None] * (m + 1) for _ in range(n + 1)
    ]
    dp[0][0] = 0.0

    def relax(ni: int, nj: int, cost: float, src_i: int, src_j: int, op: str):
        if cost < dp[ni][nj]:
            dp[ni][nj] = cost
            back[ni][nj] = (src_i, src_j, op)

    for i in range(n + 1):
        for j in range(m + 1):
            here = dp[i][j]
            if here == INF:
                continue
            if i < n and j < m:
                step = (
                    COST_MATCH
                    if phones_equivalent(mfa_labeled[i][0], text_phones[j])
                    else COST_MISMATCH
                )
                relax(i + 1, j + 1, here + step, i, j, "match")
            if i < n:
                relax(i + 1, j, here + COST_SKIP_MFA, i, j, "skip_mfa")
            if j < m:
                tp = text_phones[j]
                gap = (
                    COST_SKIP_PROSODY
                    if tp in PROSODY_TOKENS
                    else COST_SKIP_SIL if tp == "<sil>" else COST_SKIP_PHONE
                )
                relax(i, j + 1, here + gap, i, j, "skip_text")
            # j + V -> jV iotation merge
            if (
                i + 1 < n
                and j < m
                and text_phones[j] in IOTATED
                and mfa_labeled[i][0] == "j"
                and mfa_labeled[i + 1][0] == IOTATED[text_phones[j]]
            ):
                relax(i + 2, j + 1, here + COST_IOTATION, i, j, "iotation")
            # Xː -> X X geminate split
            if i < n and j + 1 < m and LENGTH_MARK in mfa_labeled[i][0]:
                base = mfa_labeled[i][0].replace(LENGTH_MARK, "")
                if text_phones[j] == base and text_phones[j + 1] == base:
                    relax(i + 1, j + 2, here + COST_GEMINATE, i, j, "geminate")
            # spn -> K phones
            if i < n and mfa_labeled[i][0] == "spn":
                for k in range(1, min(m - j, MAX_SPN_SPAN) + 1):
                    relax(
                        i + 1, j + k, here + COST_SPN_PER_PHONE * k, i, j, f"spn{k}"
                    )

    if dp[n][m] == INF:
        return None

    ops: List[Tuple[int, int, str]] = []
    ci, cj = n, m
    while ci or cj:
        entry = back[ci][cj]
        if entry is None:
            return None
        ops.append(entry)
        ci, cj = entry[0], entry[1]
    ops.reverse()

    durations = [0] * m
    pending = 0
    for pi, pj, op in ops:
        if op == "match":
            durations[pj] = mfa_labeled[pi][1] + pending
            pending = 0
        elif op == "skip_mfa":
            pending += mfa_labeled[pi][1]
        elif op == "skip_text":
            durations[pj] = 0
        elif op == "iotation":
            durations[pj] = mfa_labeled[pi][1] + mfa_labeled[pi + 1][1] + pending
            pending = 0
        elif op == "geminate":
            total = mfa_labeled[pi][1] + pending
            durations[pj] = total // 2
            durations[pj + 1] = total - total // 2
            pending = 0
        elif op.startswith("spn"):
            k = int(op[3:])
            total = mfa_labeled[pi][1] + pending
            pending = 0
            per, rem = divmod(total, k)
            for off in range(k):
                durations[pj + off] = per + (1 if off < rem else 0)
    if pending:
        durations[-1] += pending
    return durations


# ---------------------------------------------------------------------------
# TextGrid parsing (dependency-free)
# ---------------------------------------------------------------------------

@dataclass
class PhonemeAlignment:
    phoneme: str
    start_time: float
    end_time: float
    sample_rate: int = 22050
    hop_length: int = 256

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    @property
    def duration_frames(self) -> int:
        """frames = seconds * sr / hop (reference :294-297)."""
        return int(self.duration * self.sample_rate / self.hop_length)


_ITEM_RE = re.compile(r'item\s*\[\d+\]\s*:')
_NAME_RE = re.compile(r'name\s*=\s*"([^"]*)"')
_XMIN_RE = re.compile(r"xmin\s*=\s*([\d.eE+-]+)")
_XMAX_RE = re.compile(r"xmax\s*=\s*([\d.eE+-]+)")
_TEXT_RE = re.compile(r'text\s*=\s*"([^"]*)"')


def parse_textgrid(
    path: Path, sample_rate: int = 22050, hop_length: int = 256
) -> Tuple[List[PhonemeAlignment], List[Tuple[float, float]]]:
    """Parse a (long-format) Praat TextGrid.

    Returns (phone_alignments, word_boundaries).  Empty / 'sil' / 'sp' phone
    labels become '<sil>' (reference :611-617).
    """
    content = Path(path).read_text(encoding="utf-8", errors="replace")
    tiers: Dict[str, List[Tuple[float, float, str]]] = {}
    # split into item blocks
    blocks = _ITEM_RE.split(content)
    for block in blocks[1:]:
        name_match = _NAME_RE.search(block)
        if not name_match:
            continue
        tier_name = name_match.group(1)
        intervals: List[Tuple[float, float, str]] = []
        # every "intervals [k]" sub-block contributes xmin/xmax/text triples
        for sub in re.split(r"intervals\s*\[\d+\]\s*:", block)[1:]:
            xmin = _XMIN_RE.search(sub)
            xmax = _XMAX_RE.search(sub)
            text = _TEXT_RE.search(sub)
            if xmin and xmax and text is not None:
                intervals.append(
                    (float(xmin.group(1)), float(xmax.group(1)), text.group(1).strip())
                )
        tiers[tier_name] = intervals

    phones: List[PhonemeAlignment] = []
    for start, end, label in tiers.get("phones", []):
        if not label or label.lower() in ("sil", "sp", ""):
            label = "<sil>"
        phones.append(
            PhonemeAlignment(label, start, end, sample_rate, hop_length)
        )
    words = [
        (start, end) for start, end, label in tiers.get("words", []) if label
    ]
    return phones, words


def write_textgrid(
    path: Path, phones: List[Tuple[float, float, str]],
    words: List[Tuple[float, float, str]] = (),
) -> None:
    """Write a long-format Praat TextGrid, as ``mfa align`` does: a
    ``words`` tier (when given) and a ``phones`` tier of ``(xmin, xmax,
    label)`` intervals, an empty label for silence."""
    xmax = phones[-1][1] if phones else 0.0
    tiers = [(name, iv) for name, iv in (("words", list(words)), ("phones", list(phones))) if iv]
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0", f"xmax = {xmax!r}", "tiers? <exists>", f"size = {len(tiers)}",
             "item []:"]
    for t, (name, intervals) in enumerate(tiers, 1):
        lines += [f"    item [{t}]:", '        class = "IntervalTier"',
                  f'        name = "{name}"', "        xmin = 0", f"        xmax = {xmax!r}",
                  f"        intervals: size = {len(intervals)}"]
        for i, (a, b, label) in enumerate(intervals, 1):
            lines += [f"        intervals [{i}]:", f"            xmin = {a!r}",
                      f"            xmax = {b!r}", f'            text = "{label}"']
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")


# ---------------------------------------------------------------------------
# MFA workflow (binary discovery, alignment subprocess)
# ---------------------------------------------------------------------------

class MFAIntegration:
    """Drives the external ``mfa`` tool and serves aligned durations."""

    def __init__(
        self,
        alignment_dir: str = "./mfa_output/alignments",
        acoustic_model: str = "russian_mfa",
        dictionary: str = "russian_mfa",
        hop_length: int = 256,
        sample_rate: int = 22050,
    ):
        self.alignment_dir = Path(alignment_dir)
        self.acoustic_model = acoustic_model
        self.dictionary = dictionary
        self.hop_length = hop_length
        self.sample_rate = sample_rate
        self.mfa_binary = self._find_mfa_binary()

    # -- binary discovery (reference :349-433) --------------------------
    @staticmethod
    def _find_mfa_binary() -> Optional[str]:
        found = shutil.which("mfa")
        if found:
            return found
        candidates = [
            Path.home() / "miniconda3/envs/aligner/bin/mfa",
            Path.home() / "anaconda3/envs/aligner/bin/mfa",
            Path("/", "opt", "conda", "envs", "aligner", "bin", "mfa"),  # system-wide conda
            Path("/usr/local/bin/mfa"),
        ]
        for c in candidates:
            if c.exists():
                return str(c)
        return None

    @property
    def available(self) -> bool:
        return self.mfa_binary is not None

    def download_models(self) -> bool:
        """``mfa model download acoustic/dictionary`` (reference :434-470)."""
        if not self.available:
            return False
        for kind, name in (
            ("acoustic", self.acoustic_model),
            ("dictionary", self.dictionary),
        ):
            try:
                subprocess.run(
                    [self.mfa_binary, "model", "download", kind, name],
                    check=True, capture_output=True, timeout=600,
                )
            except (subprocess.SubprocessError, OSError) as err:
                logger.error("MFA model download failed (%s %s): %s", kind, name, err)
                return False
        return True

    def prepare_corpus(self, corpus_dir: str, staging_dir: str) -> Path:
        """Symlink wavs + write cleaned transcript .txt files (reference :472-533)."""
        corpus = Path(corpus_dir)
        staging = Path(staging_dir)
        staging.mkdir(parents=True, exist_ok=True)
        metadata = _read_metadata(corpus)
        wav_dir = _find_wav_dir(corpus)
        linked = 0
        for stem, text in metadata:
            wav = wav_dir / f"{stem}.wav"
            if not wav.exists():
                continue
            link = staging / f"{stem}.wav"
            if not link.exists():
                try:
                    os.symlink(wav.resolve(), link)
                except OSError:
                    shutil.copy2(wav, link)
            (staging / f"{stem}.txt").write_text(
                _clean_transcript(text), encoding="utf-8"
            )
            linked += 1
        logger.info("Prepared %d utterances for MFA in %s", linked, staging)
        return staging

    def run_alignment(
        self, staging_dir: str, num_jobs: int = 4, timeout: int = 3600
    ) -> bool:
        """``mfa align`` subprocess with a 1h timeout (reference :535-596)."""
        if not self.available:
            logger.error("MFA binary not found; cannot align")
            return False
        self.alignment_dir.mkdir(parents=True, exist_ok=True)
        cmd = [
            self.mfa_binary, "align", str(staging_dir),
            self.dictionary, self.acoustic_model, str(self.alignment_dir),
            "--num_jobs", str(num_jobs), "--clean", "--overwrite",
        ]
        try:
            result = subprocess.run(
                cmd, capture_output=True, text=True, timeout=timeout
            )
        except subprocess.TimeoutExpired:
            logger.error("MFA alignment timed out after %ds", timeout)
            return False
        if result.returncode != 0:
            logger.error("MFA alignment failed: %s", result.stderr[-2000:])
            return False
        return True

    # -- duration service (reference :791-840) ---------------------------
    def aligned_phones(self, audio_file_stem: str) -> Optional[List[Tuple[str, int]]]:
        """The (normalized MFA phone, frames) pairs of ``stem``'s TextGrid,
        outer silences folded into their neighbours; None without one."""
        textgrid = self.alignment_dir / f"{audio_file_stem}.TextGrid"
        if not textgrid.exists():
            return None
        phones, _ = parse_textgrid(textgrid, self.sample_rate, self.hop_length)
        if not phones:
            return None
        flat: List[Tuple[str, int]] = [
            (p.phoneme, p.duration_frames) for p in phones
        ]
        # Strip outer silences into neighbors (frame-count preserving)
        while len(flat) > 1 and flat[0][0] == "<sil>":
            _, dur = flat.pop(0)
            flat[0] = (flat[0][0], flat[0][1] + dur)
        while len(flat) > 1 and flat[-1][0] == "<sil>":
            _, dur = flat.pop()
            flat[-1] = (flat[-1][0], flat[-1][1] + dur)
        return [(normalize_mfa_phone(lbl), d) for lbl, d in flat]

    def get_aligned_durations(
        self, audio_file_stem: str, phoneme_sequence: List[str]
    ) -> Optional[List[int]]:
        flat = self.aligned_phones(audio_file_stem)
        if flat is None:
            return None
        return align_durations(flat, phoneme_sequence)

    def validate_alignments(self, metadata_file: str) -> Dict:
        """Coverage statistics over the corpus metadata (reference :840-889)."""
        total = aligned = 0
        failed: List[str] = []
        all_durs: List[int] = []
        for stem, _text in _read_metadata_file(Path(metadata_file)):
            total += 1
            tg = self.alignment_dir / f"{stem}.TextGrid"
            if not tg.exists():
                failed.append(stem)
                continue
            phones, _ = parse_textgrid(tg, self.sample_rate, self.hop_length)
            if phones:
                aligned += 1
                all_durs.extend(p.duration_frames for p in phones)
            else:
                failed.append(stem)
        return {
            "total_files": total,
            "aligned_files": aligned,
            "failed_files": len(failed),
            "alignment_rate": aligned / total if total else 0.0,
            "failed_file_list": failed[:10],
            "avg_duration_frames": (
                sum(all_durs) / len(all_durs) if all_durs else 0
            ),
            "min_duration_frames": min(all_durs, default=0),
            "max_duration_frames": max(all_durs, default=0),
        }


def setup_mfa_for_corpus(
    corpus_dir: str,
    output_dir: str,
    metadata_file: str = "metadata_RUSLAN_22200.csv",
    num_jobs: int = 4,
) -> MFAIntegration:
    """Full workflow: discover -> download models -> prep -> align
    (reference :892-987)."""
    out = Path(output_dir)
    mfa = MFAIntegration(alignment_dir=str(out / "alignments"))
    if not mfa.available:
        raise RuntimeError(
            "MFA binary not found. Install montreal-forced-aligner "
            "(conda install -c conda-forge montreal-forced-aligner)."
        )
    if not mfa.download_models():
        raise RuntimeError("Failed to download MFA models")
    staging = mfa.prepare_corpus(corpus_dir, str(out / "corpus"))
    if not mfa.run_alignment(str(staging), num_jobs=num_jobs):
        raise RuntimeError("MFA alignment failed")
    return mfa


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _read_metadata(corpus: Path) -> List[Tuple[str, str]]:
    for name in ("metadata_RUSLAN_22200.csv", "metadata.csv"):
        f = corpus / name
        if f.exists():
            return _read_metadata_file(f)
    return []


def _read_metadata_file(path: Path) -> List[Tuple[str, str]]:
    out = []
    try:
        for line in path.read_text(encoding="utf-8").splitlines():
            parts = line.split("|")
            if len(parts) >= 2:
                out.append((parts[0].strip(), parts[1].strip()))
    except OSError as err:
        logger.error("Cannot read metadata %s: %s", path, err)
    return out


def _find_wav_dir(corpus: Path) -> Path:
    for name in ("wavs", "wav", "audio"):
        d = corpus / name
        if d.is_dir():
            return d
    return corpus


def _clean_transcript(text: str) -> str:
    text = re.sub(r"[^\w\s,.!?а-яА-ЯёЁ-]", " ", text)
    return re.sub(r"\s+", " ", text).strip()
