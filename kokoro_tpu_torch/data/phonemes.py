"""Russian grapheme-to-phoneme front-end.

Produces the same phoneme inventory and sequence conventions as the reference
G2P (reference data/russian_phoneme_processor.py) so that MFA phone mapping and
checkpoint vocabularies are compatible:

* IPA-ish inventory: plain + palatalized consonants (``pʲ`` …), plain + iotated
  vowels (``ja`` …), reduced vowels ``ɐ/ɪ/ə`` (+ iotated ``jɐ/jɪ/jə``),
* number-to-words expansion with Russian case grammar (:224-317),
* abbreviation/unit expansion with case selection (:319-361),
* Unicode normalization preserving stress marks (:363-405),
* stress detection: explicit marks -> dictionary -> suffix heuristics
  (:406-523),
* vowel reduction by distance from the stressed syllable (:525-545),
* consonant assimilation: genitive -ого -> -ово, г->х clusters, affricate
  merges, silent clusters, regressive voicing, final devoicing (:547-646),
* palatalization + iotated-vowel contextual mapping (:648-730),
* per-word pronunciation exceptions (:155-162),
* punctuation -> prosody tokens ``<period>/<question>/<exclaim>/<comma>``
  (:37),
* vocabulary incl. ``<pad>/<sil>/<sp>`` + prosody tokens (:924-959),
* dict round-trip with forward-compat token injection (:975-1040).

Implementation is our own: rule passes are table-driven and the whole front-end
is host-side pure Python (G2P runs on the host before any tensor exists).

This is the PyTorch port's own copy of ``kokoro_tpu/data/phonemes.py``: the
port imports nothing of the JAX package, and a processor is carried across as
the ``to_dict()`` JSON (``phoneme_processor.json``), never as a pickle.
"""

from __future__ import annotations

import logging
import re
import unicodedata
from dataclasses import dataclass
from functools import lru_cache
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

STRESS_MARKS = ("́", "̀", "́")
_STRESS_MARK_SET = set(STRESS_MARKS)
_COMBINING_RE = re.compile(r"[̀-ͯ]")

VOWEL_LETTERS = set("аоуыэяёюие")

PUNCT_TO_TOKEN = {
    ".": "<period>",
    "?": "<question>",
    "!": "<exclaim>",
    ",": "<comma>",
}

# --- Letter -> phoneme tables -------------------------------------------------

VOWEL_PHONEMES = {
    "а": "a", "о": "o", "у": "u", "ы": "ɨ", "э": "e",
    "я": "ja", "ё": "jo", "ю": "ju", "и": "i", "е": "je",
}
# After a consonant the iotated vowels lose their glide (the consonant carries
# palatalization instead).
IOTATED_AFTER_CONSONANT = {"я": "a", "ю": "u", "е": "e", "ё": "o"}

CONSONANT_PHONEMES = {
    "б": "b", "в": "v", "г": "g", "д": "d", "ж": "ʐ", "з": "z",
    "к": "k", "л": "l", "м": "m", "н": "n", "п": "p", "р": "r",
    "с": "s", "т": "t", "ф": "f", "х": "x", "ц": "ts", "ч": "tʃ",
    "ш": "ʃ", "щ": "ʃtʃ", "й": "j",
}
PALATALIZED_PHONEMES = {
    c: CONSONANT_PHONEMES[c] + "ʲ"
    for c in "бвгдзклмнпрстфх"
}
ALWAYS_HARD = set("жшц")
ALWAYS_SOFT = set("чщй")
SOFTENING_LETTERS = set("еиёюяь")

VOICED = set("бвгджз")
VOICELESS = set("пфктшсхцчщ")
VOICE_PAIRS = {
    "б": "п", "в": "ф", "г": "к", "д": "т", "ж": "ш", "з": "с",
    "п": "б", "ф": "в", "к": "г", "т": "д", "ш": "ж", "с": "з",
}

REDUCED_VOWELS = ("ɐ", "ɪ", "ə", "jɐ", "jɪ", "jə")

# --- Cyrillic rewrite rules (applied before letter->phoneme mapping) ---------

# Words whose final -ого/-его keeps a hard г (reference :564-569)
HARD_G_WORDS = frozenset(
    "много немного строго дорого лого иго благо танго манго лего карго арго "
    "индиго фламинго маренго конго альтер-эго убого полого разноголосо гюго "
    "чикаго живаго сан-диего ого".split()
)

# Ordered cluster rewrites; each (pattern, replacement) applies everywhere in
# the word (reference :571-617)
CLUSTER_REWRITES = (
    ("легк", "лехк"), ("мягк", "мяхк"), ("легч", "лехч"), ("мягч", "мяхч"),
    ("сч", "щ"), ("зч", "щ"), ("отч", "оч"), ("дчик", "чик"),
    ("рдц", "рц"), ("стл", "сл"), ("нтск", "нск"), ("ндск", "нск"),
    ("вств", "ств"),
    ("ться", "ця"), ("тся", "ца"),
    ("стн", "сн"), ("здн", "зн"),
    ("тск", "цк"), ("дск", "цк"),
    ("лнц", "нц"),
)

# Pronunciation exceptions: full IPA strings (reference :155-162)
EXCEPTIONS = {
    "что": "ʃto",
    "чтобы": "ʃtobi",
    "конечно": "kɐnʲeʃnə",
    "скучно": "skutʃnə",
    "его": "jɪvo",
    "сегодня": "sʲɪvodʲnʲə",
}

# Built-in stress dictionary: word -> 0-based stressed syllable
DEFAULT_STRESS_DICT = {
    "дом": 0, "кот": 0, "мир": 0, "лес": 0,
    "говорить": 2, "работать": 1, "человек": 2,
    "хорошо": 2, "плохо": 1, "быстро": 1,
    "медленно": 1, "красиво": 2, "интересно": 2,
    "делает": 1, "говорит": 2, "работает": 1,
    "понимает": 2, "знает": 1, "играет": 1,
    "привет": 1, "как": 0, "дела": 1, "молоко": 2, "сегодня": 1,
}

# --- Number expansion ---------------------------------------------------------

_ONES = ["", "один", "два", "три", "четыре", "пять", "шесть", "семь",
         "восемь", "девять"]
_ONES_F = ["", "одна", "две", "три", "четыре", "пять", "шесть", "семь",
           "восемь", "девять"]
_TEENS = ["десять", "одиннадцать", "двенадцать", "тринадцать", "четырнадцать",
          "пятнадцать", "шестнадцать", "семнадцать", "восемнадцать",
          "девятнадцать"]
_TENS = ["", "", "двадцать", "тридцать", "сорок", "пятьдесят", "шестьдесят",
         "семьдесят", "восемьдесят", "девяносто"]
_HUNDREDS = ["", "сто", "двести", "триста", "четыреста", "пятьсот", "шестьсот",
             "семьсот", "восемьсот", "девятьсот"]

# scale name -> (feminine?, nominative sg, genitive sg, genitive pl)
_SCALES = [
    (10**12, (False, "триллион", "триллиона", "триллионов")),
    (10**9, (False, "миллиард", "миллиарда", "миллиардов")),
    (10**6, (False, "миллион", "миллиона", "миллионов")),
    (10**3, (True, "тысяча", "тысячи", "тысяч")),
]

# unit abbreviation -> (feminine?, nom sg, gen sg, gen pl)
UNIT_FORMS: Dict[str, tuple] = {
    "млрд": (False, "миллиард", "миллиарда", "миллиардов"),
    "млн": (False, "миллион", "миллиона", "миллионов"),
    "тыс": (True, "тысяча", "тысячи", "тысяч"),
    "км": (False, "километр", "километра", "километров"),
    "кг": (False, "килограмм", "килограмма", "килограммов"),
    "мм": (False, "миллиметр", "миллиметра", "миллиметров"),
    "см": (False, "сантиметр", "сантиметра", "сантиметров"),
    "руб": (False, "рубль", "рубля", "рублей"),
    "коп": (True, "копейка", "копейки", "копеек"),
    "мин": (True, "минута", "минуты", "минут"),
    "сек": (True, "секунда", "секунды", "секунд"),
    "чел": (False, "человек", "человека", "человек"),
    "г": (False, "грамм", "грамма", "граммов"),
    "м": (False, "метр", "метра", "метров"),
    "л": (False, "литр", "литра", "литров"),
}

# standalone abbreviations -> expansion
ABBREVIATIONS = [
    (re.compile(r"\bт\.\s*е\.", re.IGNORECASE), "то есть"),
    (re.compile(r"\bт\.\s*д\.", re.IGNORECASE), "так далее"),
    (re.compile(r"\bт\.\s*п\.", re.IGNORECASE), "тому подобное"),
    (re.compile(r"\bмлрд\b", re.IGNORECASE), "миллиардов"),
    (re.compile(r"\bмлн\b", re.IGNORECASE), "миллионов"),
    (re.compile(r"\bтыс\b", re.IGNORECASE), "тысяч"),
    (re.compile(r"\bкм\b", re.IGNORECASE), "километров"),
    (re.compile(r"\bкг\b", re.IGNORECASE), "килограммов"),
    (re.compile(r"\bмм\b", re.IGNORECASE), "миллиметров"),
    (re.compile(r"\bсм\b", re.IGNORECASE), "сантиметров"),
    (re.compile(r"\bкв\b", re.IGNORECASE), "квадратных"),
    (re.compile(r"\bруб\b", re.IGNORECASE), "рублей"),
    (re.compile(r"\bкоп\b", re.IGNORECASE), "копеек"),
    (re.compile(r"\bмин\b", re.IGNORECASE), "минут"),
    (re.compile(r"\bсек\b", re.IGNORECASE), "секунд"),
    (re.compile(r"\bчел\b", re.IGNORECASE), "человек"),
    (re.compile(r"\bул\b", re.IGNORECASE), "улица"),
    (re.compile(r"\bпр\b", re.IGNORECASE), "проспект"),
]


def number_to_words(n: int, feminine: bool = False) -> str:
    """Russian cardinal for 0 <= n < 10^15."""
    if n == 0:
        return "ноль"
    if n < 0:
        return "минус " + number_to_words(-n, feminine)

    parts: List[str] = []

    def under_1000(k: int, fem: bool) -> List[str]:
        words = []
        if k >= 100:
            words.append(_HUNDREDS[k // 100])
            k %= 100
        if 10 <= k < 20:
            words.append(_TEENS[k - 10])
            return words
        if k >= 20:
            words.append(_TENS[k // 10])
            k %= 10
        if k:
            words.append((_ONES_F if fem else _ONES)[k])
        return words

    for scale, (fem, nom, gen_sg, gen_pl) in _SCALES:
        if n >= scale:
            count = n // scale
            n %= scale
            parts.extend(under_1000(count, fem))
            parts.append(_select_case_form(count, nom, gen_sg, gen_pl))
    if n:
        parts.extend(under_1000(n, feminine))
    return " ".join(w for w in parts if w)


def _select_case_form(n: int, nom_sg: str, gen_sg: str, gen_pl: str) -> str:
    """Russian numeric agreement: 1 -> nom sg; 2-4 -> gen sg; 5-20, 0 -> gen pl
    (by the last two digits)."""
    tail = n % 100
    if 11 <= tail <= 19:
        return gen_pl
    last = n % 10
    if last == 1:
        return nom_sg
    if 2 <= last <= 4:
        return gen_sg
    return gen_pl


def expand_numbers_and_abbrevs(text: str) -> str:
    """Digit groups -> words; "N unit" -> words with case agreement."""

    def num_with_unit(m: re.Match) -> str:
        n = int(m.group(1))
        unit = m.group(2).lower().rstrip(".")
        if unit in UNIT_FORMS:
            fem, nom, gen_sg, gen_pl = UNIT_FORMS[unit]
            return (
                number_to_words(n, feminine=fem)
                + " "
                + _select_case_form(n, nom, gen_sg, gen_pl)
            )
        return m.group(0)

    unit_alt = "|".join(sorted(UNIT_FORMS, key=len, reverse=True))
    # Do NOT consume a trailing "." — it may be sentence-final punctuation that
    # must survive for prosody-token extraction.
    text = re.sub(rf"\b(\d+)\s*({unit_alt})\b", num_with_unit, text)
    text = re.sub(r"\d+", lambda m: number_to_words(int(m.group(0))), text)
    for pattern, repl in ABBREVIATIONS:
        text = pattern.sub(repl, text)
    return text


@dataclass(frozen=True)
class StressInfo:
    """Stress descriptor: 0-based stressed syllable + character index of the
    stressed vowel in the clean word (reference :11-22)."""

    position: int
    vowel_index: int
    is_marked: bool


class RussianPhonemeProcessor:
    """G2P front-end: text -> per-word phoneme sequences + stress info."""

    PUNCT_MAP = PUNCT_TO_TOKEN

    def __init__(self, stress_dict_path: Optional[str] = None):
        self.vowels = dict(VOWEL_PHONEMES)
        self.consonants = dict(CONSONANT_PHONEMES)
        self.palatalized = dict(PALATALIZED_PHONEMES)
        self.hard_consonants = set(ALWAYS_HARD)
        self.soft_consonants = set(ALWAYS_SOFT)
        self.voiced_consonants = set(VOICED)
        self.voiceless_consonants = set(VOICELESS)
        self.voicing_map = dict(VOICE_PAIRS)
        self.exceptions = dict(EXCEPTIONS)
        self.stress_patterns = dict(DEFAULT_STRESS_DICT)
        if stress_dict_path:
            self._load_stress_file(stress_dict_path)
        self.phoneme_to_id = self._build_vocab()
        self._normalize_cached = lru_cache(maxsize=2048)(self._normalize_impl)
        self._word_cached = lru_cache(maxsize=4096)(self._process_word_impl)

    # ------------------------------------------------------------------
    # Normalization
    # ------------------------------------------------------------------
    def normalize_text(self, text: str) -> str:
        return self._normalize_cached(text)

    @staticmethod
    def _normalize_impl(text: str) -> str:
        if not text:
            return ""
        text = text.lower().replace("ё", "е́")  # ё is inherently stressed
        text = unicodedata.normalize("NFD", text)
        allowed = set("абвгдежзийклмнопрстуфхцчшщъыьэюя ")
        kept = []
        for ch in text:
            if ch in allowed or ch in _STRESS_MARK_SET:
                kept.append(ch)
            elif ch == "̆":  # breve: й decomposes to и + U+0306
                kept.append(ch)
            else:
                kept.append(" ") if not unicodedata.combining(ch) else None
        text = unicodedata.normalize("NFC", "".join(kept))
        return re.sub(r"\s+", " ", text).strip()

    # ------------------------------------------------------------------
    # Stress
    # ------------------------------------------------------------------
    def detect_stress(self, word: str) -> StressInfo:
        if not word:
            return StressInfo(0, 0, False)

        clean_chars: List[str] = []
        marked_vowel_idx = -1
        for ch in word:
            if ch in _STRESS_MARK_SET:
                if clean_chars and clean_chars[-1] in VOWEL_LETTERS:
                    marked_vowel_idx = len(clean_chars) - 1
            else:
                clean_chars.append(ch)
        clean = "".join(clean_chars)

        if marked_vowel_idx >= 0:
            return StressInfo(
                self._syllable_of_char(clean, marked_vowel_idx),
                marked_vowel_idx,
                True,
            )

        bare = _COMBINING_RE.sub("", word).lower()
        if bare in self.stress_patterns:
            pos = self.stress_patterns[bare]
            return StressInfo(pos, self._char_of_syllable(bare, pos), False)

        return self._stress_heuristic(clean)

    @staticmethod
    def _syllable_of_char(word: str, char_idx: int) -> int:
        count = 0
        for i, ch in enumerate(word):
            if ch in VOWEL_LETTERS:
                if i == char_idx:
                    return count
                count += 1
        return 0

    @staticmethod
    def _char_of_syllable(word: str, syllable: int) -> int:
        count = 0
        last = 0
        for i, ch in enumerate(word):
            if ch in VOWEL_LETTERS:
                if count == syllable:
                    return i
                count += 1
                last = i
        return last

    def _stress_heuristic(self, word: str) -> StressInfo:
        """Suffix-pattern heuristics (reference :497-523): infinitives stress
        the ending, adjectival/nominal suffixes stress the penult."""
        n_syll = sum(1 for ch in word if ch in VOWEL_LETTERS)
        if n_syll <= 1:
            return StressInfo(0, self._char_of_syllable(word, 0), False)
        pos = n_syll - 2  # default: penultimate
        if word.endswith(("ать", "еть", "ить", "ыть", "уть", "ять")):
            pos = n_syll - 1
        elif word.endswith(("ие", "ые", "ая", "яя", "ое", "ее", "ую", "ею",
                            "ость", "есть", "ий", "ние", "тие")):
            pos = max(0, n_syll - 2)
        pos = min(pos, n_syll - 1)
        return StressInfo(pos, self._char_of_syllable(word, pos), False)

    # ------------------------------------------------------------------
    # Cyrillic rewrites (assimilation)
    # ------------------------------------------------------------------
    def apply_consonant_assimilation(self, word: str) -> str:
        word = _COMBINING_RE.sub("", word.lower())

        if word.endswith(("ого", "его")) and word not in HARD_G_WORDS:
            word = word[:-3] + word[-3:].replace("г", "в")

        for pat, repl in CLUSTER_REWRITES:
            if pat in word:
                word = word.replace(pat, repl)

        # Regressive voicing assimilation between consonant pairs
        chars = list(word)
        for i in range(len(chars) - 1):
            cur, nxt = chars[i], chars[i + 1]
            if cur not in CONSONANT_PHONEMES or nxt not in CONSONANT_PHONEMES:
                continue
            if cur in VOICED and nxt in VOICELESS:
                repl = VOICE_PAIRS.get(cur)
                if repl in VOICELESS:
                    chars[i] = repl
            elif cur in VOICELESS and nxt in VOICED and nxt != "в":
                repl = VOICE_PAIRS.get(cur)
                if repl in VOICED:
                    chars[i] = repl

        # Word-final devoicing
        if chars and chars[-1] in VOICED:
            repl = VOICE_PAIRS.get(chars[-1])
            if repl in VOICELESS:
                chars[-1] = repl
        return "".join(chars)

    # ------------------------------------------------------------------
    # Letter -> phoneme with palatalization
    # ------------------------------------------------------------------
    def apply_palatalization(self, word: str) -> List[str]:
        out: List[str] = []
        for i, ch in enumerate(word):
            ch = ch.lower()
            if ch in VOWEL_LETTERS:
                out.append(self._vowel_phoneme(word, i))
            elif ch in CONSONANT_PHONEMES:
                softened = (
                    i + 1 < len(word) and word[i + 1].lower() in SOFTENING_LETTERS
                )
                if ch in ALWAYS_HARD or ch in ALWAYS_SOFT:
                    out.append(CONSONANT_PHONEMES[ch])
                elif softened and ch in PALATALIZED_PHONEMES:
                    out.append(PALATALIZED_PHONEMES[ch])
                else:
                    out.append(CONSONANT_PHONEMES[ch])
            # ь / ъ produce no phoneme of their own
        return [p for p in out if p]

    @staticmethod
    def _vowel_phoneme(word: str, pos: int) -> str:
        ch = word[pos].lower()
        if ch in ("я", "ю", "е", "ё"):
            if pos == 0:
                return VOWEL_PHONEMES[ch]
            prev = word[pos - 1].lower()
            if prev in VOWEL_LETTERS or prev in ("ъ", "ь"):
                return VOWEL_PHONEMES[ch]
            if prev in CONSONANT_PHONEMES:
                return IOTATED_AFTER_CONSONANT[ch]
            return VOWEL_PHONEMES[ch]
        if ch == "и" and pos > 0 and word[pos - 1].lower() in ALWAYS_HARD:
            return "ɨ"  # ши/жи/ци -> ы sound
        return VOWEL_PHONEMES[ch]

    # ------------------------------------------------------------------
    # Vowel reduction
    # ------------------------------------------------------------------
    @staticmethod
    def apply_vowel_reduction(
        phonemes: List[str], stressed_syllable: int
    ) -> List[str]:
        """Pre-tonic syllable: о/а -> ɐ, е/и -> ɪ; elsewhere unstressed -> ə
        (reference :525-545)."""
        bases = {"a", "o", "u", "ɨ", "e", "i", "ja", "jo", "ju", "je"}
        out = list(phonemes)
        syllable = 0
        for i, ph in enumerate(out):
            if ph not in bases:
                continue
            if syllable != stressed_syllable:
                iotated = ph.startswith("j") and len(ph) > 1
                base = ph[1:] if iotated else ph
                if syllable == stressed_syllable - 1:
                    red = "ɐ" if base in ("o", "a") else "ɪ" if base in ("e", "i") else None
                else:
                    red = "ə" if base in ("o", "a", "e", "i") else None
                if red is not None:
                    out[i] = ("j" + red) if iotated else red
            syllable += 1
        return out

    # ------------------------------------------------------------------
    # Word / text processing
    # ------------------------------------------------------------------
    def _process_word_impl(self, word: str) -> Tuple[Tuple[str, ...], StressInfo]:
        bare = _COMBINING_RE.sub("", word).lower()
        if bare in self.exceptions:
            phs = tuple(self.tokenize_ipa(self.exceptions[bare]))
            if bare in self.stress_patterns:
                pos = self.stress_patterns[bare]
                info = StressInfo(pos, self._char_of_syllable(bare, pos), True)
            else:
                info = StressInfo(0, 0, True)
            return phs, info
        stress = self.detect_stress(word)
        rewritten = self.apply_consonant_assimilation(word)
        phonemes = self.apply_palatalization(rewritten)
        phonemes = self.apply_vowel_reduction(phonemes, stress.position)
        return tuple(phonemes), stress

    def process_word(self, word: str) -> Tuple[List[str], StressInfo]:
        normalized = self.normalize_text(word)
        if not normalized:
            return [], StressInfo(0, 0, False)
        phs, info = self._word_cached(normalized)
        return list(phs), info

    @staticmethod
    def _punct_after_words(text: str) -> List[Optional[str]]:
        """First PUNCT_MAP character after each Cyrillic word (reference
        :783-806)."""
        out: List[Optional[str]] = []
        i, n = 0, len(text)
        is_cyr = lambda c: "Ѐ" <= c <= "ӿ"
        while i < n:
            if not is_cyr(text[i]):
                i += 1
                continue
            while i < n and (is_cyr(text[i]) or text[i] in _STRESS_MARK_SET):
                i += 1
            punct = None
            while i < n and not is_cyr(text[i]):
                if punct is None and text[i] in PUNCT_TO_TOKEN:
                    punct = PUNCT_TO_TOKEN[text[i]]
                i += 1
            out.append(punct)
        return out

    def process_text(self, text: str) -> List[Tuple]:
        """-> list of (word, phonemes, StressInfo, punct_token_or_None)."""
        if not text:
            return []
        text = expand_numbers_and_abbrevs(text)
        punct = self._punct_after_words(text)
        normalized = self.normalize_text(text)
        results = []
        for idx, word in enumerate(normalized.split()):
            try:
                phs, info = self._word_cached(word)
            except Exception as err:  # per-word isolation (reference :836-840)
                logger.error("G2P failed for %r: %s", word, err)
                phs, info = (), StressInfo(0, 0, False)
            results.append(
                (word, list(phs), info, punct[idx] if idx < len(punct) else None)
            )
        return results

    # ------------------------------------------------------------------
    # IPA tokenization and vocab
    # ------------------------------------------------------------------
    @property
    def _multi_char_phonemes(self) -> List[str]:
        extras = ["ts", "tʃ", "ʃtʃ", "dʑ", "dz", "tɕ", "ɐ", "ə", "ɪ", "ɨ",
                  "ja", "jo", "ju", "je", "jɐ", "jɪ", "jə"]
        return sorted(
            list(self.palatalized.values()) + extras, key=len, reverse=True
        )

    def tokenize_ipa(self, ipa: str) -> List[str]:
        multi = self._multi_char_phonemes
        out: List[str] = []
        i = 0
        while i < len(ipa):
            for m in multi:
                if ipa.startswith(m, i):
                    out.append(m)
                    i += len(m)
                    break
            else:
                out.append(ipa[i])
                i += 1
        return [p for p in out if p and p not in _STRESS_MARK_SET and p not in ("ˈ", "ˌ", "ʲ")]

    def _build_vocab(self) -> Dict[str, int]:
        phonemes = {"<pad>", "<sil>", "<sp>"}
        phonemes.update(PUNCT_TO_TOKEN.values())
        phonemes.update(self.vowels.values())
        phonemes.update(self.consonants.values())
        phonemes.update(self.palatalized.values())
        phonemes.update(REDUCED_VOWELS)
        for ipa in self.exceptions.values():
            phonemes.update(self.tokenize_ipa(ipa))
        phonemes.discard("")
        phonemes -= {"ʲ", "ˈ", "ˌ"}
        return {p: i for i, p in enumerate(sorted(phonemes))}

    def get_vocab_size(self) -> int:
        return len(self.phoneme_to_id)

    def get_phoneme_list(self) -> List[str]:
        return sorted(self.phoneme_to_id)

    def text_to_indices(self, text: str) -> List[int]:
        out = []
        for _, phonemes, *_ in self.process_text(text):
            for p in phonemes:
                idx = self.phoneme_to_id.get(p)
                if idx is not None:
                    out.append(idx)
                else:
                    logger.warning("Unknown phoneme %r", p)
        return out

    # ------------------------------------------------------------------
    # Serialization (reference :975-1040)
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "vowels": self.vowels,
            "consonants": self.consonants,
            "palatalized": self.palatalized,
            "hard_consonants": sorted(self.hard_consonants),
            "soft_consonants": sorted(self.soft_consonants),
            "voiced_consonants": sorted(self.voiced_consonants),
            "voiceless_consonants": sorted(self.voiceless_consonants),
            "voicing_map": self.voicing_map,
            "stress_patterns": self.stress_patterns,
            "exceptions": self.exceptions,
            "phoneme_to_id": self.phoneme_to_id,
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "RussianPhonemeProcessor":
        inst = cls()
        inst.vowels = data.get("vowels", inst.vowels)
        inst.consonants = data.get("consonants", inst.consonants)
        inst.palatalized = data.get("palatalized", inst.palatalized)
        inst.hard_consonants = set(data.get("hard_consonants", inst.hard_consonants))
        inst.soft_consonants = set(data.get("soft_consonants", inst.soft_consonants))
        inst.voiced_consonants = set(
            data.get("voiced_consonants", inst.voiced_consonants)
        )
        inst.voiceless_consonants = set(
            data.get("voiceless_consonants", inst.voiceless_consonants)
        )
        inst.voicing_map = data.get("voicing_map", inst.voicing_map)
        inst.stress_patterns = data.get("stress_patterns", inst.stress_patterns)
        inst.exceptions = data.get("exceptions", inst.exceptions)
        inst.phoneme_to_id = data.get("phoneme_to_id", inst.phoneme_to_id)
        # Forward-compat: inject tokens added after old pickles were written
        required = (
            ["<pad>", "<sil>", "<sp>"]
            + list(PUNCT_TO_TOKEN.values())
            + ["jɐ", "jɪ", "jə"]
        )
        next_id = max(inst.phoneme_to_id.values(), default=-1) + 1
        for tok in required:
            if tok not in inst.phoneme_to_id:
                inst.phoneme_to_id[tok] = next_id
                next_id += 1
        inst._normalize_cached.cache_clear()
        inst._word_cached.cache_clear()
        return inst

    def _load_stress_file(self, path: str) -> None:
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    parts = line.split()
                    if len(parts) >= 2:
                        self.stress_patterns[parts[0].lower()] = int(parts[1])
        except OSError as err:
            logger.warning("Could not load stress dictionary %s: %s", path, err)


def load_processor_json(path: str | Path) -> RussianPhonemeProcessor:
    """Processor from the ``to_dict()`` JSON that ``convert.save_model_dir``
    writes beside the weights."""
    with open(path, "r", encoding="utf-8") as f:
        return RussianPhonemeProcessor.from_dict(json.load(f))
