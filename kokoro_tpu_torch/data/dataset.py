"""RUSLAN corpus dataset: metadata, feature extraction, the feature cache and
the train/val split.

Port of ``kokoro_tpu/data/dataset.py``:

* a pipe-separated ``metadata_RUSLAN_22200.csv`` / ``metadata.csv`` with a
  ``wavs/`` directory, or ``.wav`` + ``.txt`` pairs; per-utterance
  (mel frames, phonemes) estimates from the wav header and the G2P, cached as
  JSON; samples sorted by estimated length before the split indices apply,
  so index i names the same utterance as in the JAX package;
* features: wav read, resample, peak-normalise, optional speed perturbation
  (training items, cache bypass), log-mel, YIN pitch and mel energy
  (:class:`FeatureExtractor`, torch on the caller's device), G2P with
  inter-word ``<sil>`` and stress ids;
* durations: the MFA alignment of the utterance's TextGrid
  (:class:`~kokoro_tpu_torch.data.mfa.MFAIntegration`, when ``mfa`` is given
  and ``use_mfa`` is set), rescaled to the frame count under speed
  perturbation, the frame sum reconciled into the last phoneme and every
  duration at least 1; :func:`build_fallback_durations` when there is no
  TextGrid or no alignment path;
* a two-tier cache: per-utterance ``.npz`` files plus a bounded in-RAM LRU.
  As in the reference, an entry is keyed on the stem alone: a cache filled
  before the alignments existed keeps its fallback durations.
"""

from __future__ import annotations

import json
import logging
import random
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
from kokoro_tpu_torch.data import audio_io, text_utils
from kokoro_tpu_torch.data.mfa import MFAIntegration
from kokoro_tpu_torch.data.phonemes import RussianPhonemeProcessor
from kokoro_tpu_torch.ops.pitch import extract_pitch, masked_quantile
from kokoro_tpu_torch.ops.stft import log_mel_spectrogram

logger = logging.getLogger(__name__)

FEATURE_CACHE_VERSION = 1
AUDIO_BUCKET_SAMPLES = 16384  # ~0.74 s at 22.05 kHz
MEMORY_CACHE_ENTRIES = 30000
MEMORY_CACHE_BYTES = 8192 * 1024 * 1024


def build_fallback_durations(num_phonemes: int, num_mel_frames: int) -> np.ndarray:
    """Uniform durations with an exact frame sum (reference dataset.py:581-606)."""
    num_phonemes = max(0, int(num_phonemes))
    num_mel_frames = max(0, int(num_mel_frames))
    if num_phonemes == 0:
        return np.zeros((0,), dtype=np.int32)
    base, rem = divmod(num_mel_frames, num_phonemes)
    out = np.full((num_phonemes,), base, dtype=np.int32)
    out[:rem] += 1
    return out


class FeatureExtractor:
    """log-mel ``(T, n_mels)``, pitch ``(T,)`` and energy ``(T,)`` of one
    utterance, computed with torch on ``device``.

    The audio is zero-padded to a multiple of ``AUDIO_BUCKET_SAMPLES``, as
    the reference pads it to bound its compiles: the STFT windows of the last
    frames reach into that padding, so keeping it keeps the features equal
    to the reference's.  The energy's percentile normalisation and the pitch
    voicing thresholds count the T real frames only."""

    def __init__(self, model_config: KokoroConfig, config: TrainingConfig,
                 device: str | torch.device = "cpu"):
        self.model_config = model_config
        self.config = config
        self.device = torch.device(device)

    @torch.no_grad()
    def __call__(self, audio: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        cfg, mcfg = self.config, self.model_config
        hop = mcfg.hop_length
        orig = max(audio.shape[0], cfg.win_length)
        T = min(orig // hop + 1, cfg.max_seq_length)  # true frame count (centered STFT)
        bucket = -(-orig // AUDIO_BUCKET_SAMPLES) * AUDIO_BUCKET_SAMPLES
        max_samples = cfg.max_seq_length * hop + cfg.win_length
        bucket = min(bucket, -(-max_samples // AUDIO_BUCKET_SAMPLES) * AUDIO_BUCKET_SAMPLES)
        padded = np.zeros(bucket, np.float32)
        padded[: min(orig, bucket)] = audio[: min(audio.shape[0], bucket)]
        x = torch.from_numpy(padded).to(self.device)

        log_mel = log_mel_spectrogram(x, mcfg.sample_rate, cfg.n_fft, hop, cfg.win_length,
                                      mcfg.n_mels, cfg.f_min, cfg.f_max)
        valid = torch.arange(log_mel.shape[0], device=x.device)[None, :] < T
        # energy from the LINEAR mel power (reference dataset.py:808-813)
        energy_raw = torch.log1p(torch.clamp(torch.exp(log_mel).mean(-1), min=0.0))[None, :]
        floor = masked_quantile(energy_raw, valid, 0.05)
        ceil = masked_quantile(energy_raw, valid, 0.95)
        energy = torch.clamp((energy_raw - floor) / torch.clamp(ceil - floor, min=1e-8),
                             0.0, 1.0)[0]
        pitch = extract_pitch(x, mcfg.sample_rate, hop, cfg.pitch_extract_fmin,
                              cfg.pitch_extract_fmax, valid_frames=T)
        log_mel = log_mel[:T].cpu().numpy().astype(np.float32)
        pitch = np.pad(pitch[:T].cpu().numpy().astype(np.float32), (0, max(0, T - pitch.shape[0])))
        energy = np.pad(energy[:T].cpu().numpy().astype(np.float32),
                        (0, max(0, T - energy.shape[0])))
        # >1.5 re-normalisation guard (reference dataset.py:826-841)
        if pitch.size and pitch.max() > 1.5:
            logger.error("Unnormalized pitch detected; force-normalizing")
            pitch = np.clip(pitch / pitch.max(), 0.0, 1.0)
        if energy.size and energy.max() > 1.5:
            logger.error("Unnormalized energy detected; force-normalizing")
            energy = np.clip(energy / energy.max(), 0.0, 1.0)
        return log_mel, pitch, energy


class RuslanDataset:
    """Corpus access and per-utterance features with caching."""

    def __init__(
        self, data_dir: str, model_config: KokoroConfig, config: TrainingConfig,
        phoneme_processor: Optional[RussianPhonemeProcessor] = None,
        indices: Optional[Sequence[int]] = None, is_training: bool = True,
        device: str | torch.device = "cpu", mfa: Optional[MFAIntegration] = None,
    ):
        self.data_dir = Path(data_dir)
        self.config = config
        self.mfa = mfa
        self.hop_length = model_config.hop_length
        self.sample_rate = model_config.sample_rate
        self.is_training = is_training
        self.phoneme_processor = phoneme_processor or RussianPhonemeProcessor()
        self.extractor = FeatureExtractor(model_config, config, device)
        self.feature_cache_dir = Path(config.feature_cache_dir)
        if config.use_feature_cache:
            self.feature_cache_dir.mkdir(parents=True, exist_ok=True)
        self._memory_cache: OrderedDict[str, Dict] = OrderedDict()
        self._memory_cache_bytes = 0
        self.cache_requests = 0
        self.cache_misses = 0

        self.samples = self._load_samples()
        self._lengths = self._load_length_metadata()
        # stable sort by estimated mel length BEFORE the split indices apply
        self.samples.sort(key=lambda s: self._lengths[s["audio_file"]][0])
        if indices is not None:
            self.samples = [self.samples[i] for i in indices]

    # -- corpus ---------------------------------------------------------------
    def _load_samples(self) -> List[Dict]:
        samples: List[Dict] = []
        meta = next((self.data_dir / name for name in ("metadata_RUSLAN_22200.csv", "metadata.csv")
                     if (self.data_dir / name).exists()), None)
        wav_dir = next((self.data_dir / name for name in ("wavs", "wav", "audio", ".")
                        if (self.data_dir / name).is_dir()
                        and any((self.data_dir / name).glob("*.wav"))), None)
        if meta is not None:
            for line in meta.read_text(encoding="utf-8").splitlines():
                parts = line.split("|")
                if len(parts) < 2:
                    continue
                stem, text = parts[0].strip(), parts[1].strip()
                path = (wav_dir or self.data_dir) / f"{stem}.wav"
                if path.exists():
                    samples.append({"audio_file": stem, "audio_path": path, "text": text})
        elif wav_dir is not None:
            for wav in sorted(wav_dir.glob("*.wav")):
                txt = wav.with_suffix(".txt")
                if txt.exists():
                    samples.append({"audio_file": wav.stem, "audio_path": wav,
                                    "text": txt.read_text(encoding="utf-8").strip()})
        if not samples:
            raise FileNotFoundError(f"No corpus found under {self.data_dir} (need metadata CSV "
                                    "or wavs/*.wav + *.txt)")
        return samples

    def _phonemes(self, text: str):
        raw = self.phoneme_processor.process_text(text)
        return raw, text_utils.flatten_with_sil(raw, self.phoneme_processor.phoneme_to_id)

    def _load_length_metadata(self) -> Dict[str, Tuple[int, int]]:
        """(mel frames, phonemes) per stem, cached in ``.cache/audio_lengths.json``."""
        cache_file = self.data_dir / ".cache" / "audio_lengths.json"
        cached: Dict[str, Tuple[int, int]] = {}
        if cache_file.exists():
            try:
                cached = {k: tuple(v) for k, v in json.loads(cache_file.read_text()).items()}
            except (OSError, ValueError):
                cached = {}
        updated = False
        for s in self.samples:
            if s["audio_file"] in cached:
                continue
            n_samples = audio_io.wav_num_samples(s["audio_path"])
            n_frames = min(n_samples // self.hop_length + 1, self.config.max_seq_length)
            cached[s["audio_file"]] = (n_frames, len(self._phonemes(s["text"])[1]))
            updated = True
        if updated:
            try:
                cache_file.parent.mkdir(parents=True, exist_ok=True)
                cache_file.write_text(json.dumps(cached))
            except OSError as err:
                logger.warning("Could not persist the audio length cache: %s", err)
        return cached

    def lengths(self, idx: int) -> Tuple[int, int]:
        """(mel_frames, phoneme_count) estimate for batching."""
        return self._lengths[self.samples[idx]["audio_file"]]

    def __len__(self) -> int:
        return len(self.samples)

    # -- feature cache ----------------------------------------------------------
    def _load_cached(self, stem: str) -> Optional[Dict]:
        if stem in self._memory_cache:
            self._memory_cache.move_to_end(stem)
            return dict(self._memory_cache[stem])
        path = self.feature_cache_dir / f"{stem}.npz"
        if not path.exists():
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                if int(z["cache_version"]) != FEATURE_CACHE_VERSION:
                    return None
                payload = {k: z[k] for k in z.files if k != "cache_version"}
        except (OSError, ValueError, KeyError) as err:
            logger.warning("Corrupt feature cache %s: %s", path, err)
            return None
        self._memory_put(stem, payload)
        return dict(payload)

    def _memory_put(self, stem: str, payload: Dict) -> None:
        if not self.config.use_memory_cache:
            return
        old = self._memory_cache.pop(stem, None)
        if old is not None:
            self._memory_cache_bytes -= sum(v.nbytes for v in old.values())
        self._memory_cache[stem] = payload
        self._memory_cache_bytes += sum(v.nbytes for v in payload.values())
        while self._memory_cache and (len(self._memory_cache) > MEMORY_CACHE_ENTRIES
                                      or self._memory_cache_bytes > MEMORY_CACHE_BYTES):
            _, evicted = self._memory_cache.popitem(last=False)
            self._memory_cache_bytes -= sum(v.nbytes for v in evicted.values())

    def _save_cached(self, stem: str, payload: Dict) -> None:
        if self.config.use_feature_cache:
            try:
                np.savez(self.feature_cache_dir / f"{stem}.npz",
                         cache_version=FEATURE_CACHE_VERSION, **payload)
            except OSError as err:
                logger.warning("Could not write feature cache for %s: %s", stem, err)
        self._memory_put(stem, payload)

    # -- features ---------------------------------------------------------------
    def get_features(self, idx: int, rng: np.random.Generator) -> Dict:
        sample = self.samples[idx]
        stem = sample["audio_file"]
        self.cache_requests += 1
        cfg = self.config
        perturb = (self.is_training and cfg.use_speed_perturbation
                   and rng.random() < cfg.speed_perturb_prob)
        factor = (1.0 + rng.uniform(-cfg.speed_perturb_range, cfg.speed_perturb_range)
                  if perturb else 1.0)
        if factor == 1.0:
            cached = self._load_cached(stem)
            if cached is not None:
                return dict(cached, text=sample["text"], audio_file=stem)

        self.cache_misses += 1
        sr, audio = audio_io.read_wav(sample["audio_path"])
        if sr != self.sample_rate:
            audio = audio_io.resample(audio, sr, self.sample_rate)
        audio = audio_io.peak_normalize(audio)
        if factor != 1.0:
            audio = audio_io.apply_speed_perturbation(audio, self.sample_rate, factor)
        log_mel, pitch, energy = self.extractor(audio)
        num_frames = log_mel.shape[0]

        raw, phoneme_seq = self._phonemes(sample["text"])
        p2i = self.phoneme_processor.phoneme_to_id
        phoneme_indices = np.asarray(text_utils.phonemes_to_indices(phoneme_seq, p2i), np.int32)
        stress = text_utils.stress_indices_with_sil(raw, p2i)
        stress = (stress + [0] * len(phoneme_indices))[: len(phoneme_indices)]
        durations = self._aligned_durations(stem, phoneme_seq, num_frames, factor)
        if durations is None:
            durations = build_fallback_durations(len(phoneme_indices), num_frames)
        payload = {
            "mel_spec": log_mel,
            "phoneme_indices": phoneme_indices,
            "stress_indices": np.asarray(stress, np.int32),
            "phoneme_durations": durations.astype(np.int32),
            "pitch": pitch,
            "energy": energy,
            "mel_length": np.int32(num_frames),
            "phoneme_length": np.int32(len(phoneme_indices)),
        }
        if factor == 1.0:
            self._save_cached(stem, payload)
        return dict(payload, text=sample["text"], audio_file=stem)


    def _aligned_durations(self, stem: str, phoneme_seq: List[str], num_frames: int,
                           factor: float) -> Optional[np.ndarray]:
        """The MFA durations of ``stem`` fitted to ``num_frames`` (reference
        dataset.py:462-479), or None without an alignment."""
        if self.mfa is None or not self.config.use_mfa:
            return None
        aligned = self.mfa.get_aligned_durations(stem, phoneme_seq)
        if aligned is None:
            return None
        durations = np.asarray(aligned, np.int64)
        total = durations.sum()
        if factor != 1.0 and total > 0:
            # proportional rescale to the perturbed frame count
            durations = np.maximum(np.round(durations * (num_frames / total)).astype(np.int64), 1)
        diff = num_frames - durations.sum()  # the frame sum goes into the last phoneme
        if diff != 0 and durations.size:
            durations[-1] = max(1, durations[-1] + diff)
        return np.maximum(durations, 1)


def train_val_split(n: int, validation_split: float = 0.1,
                    seed: int = 42) -> Tuple[List[int], List[int]]:
    """The reference's split (trainer.py:286-293): shuffle ``range(n)`` with
    Python's Mersenne Twister seeded ``seed``; train is the first
    ``int(n * (1 - split))`` of the permutation, validation the tail."""
    indices = list(range(n))
    random.Random(seed).shuffle(indices)
    split_idx = int(n * (1 - validation_split))
    return indices[:split_idx], indices[split_idx:]
