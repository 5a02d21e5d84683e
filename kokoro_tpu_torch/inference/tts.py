"""KokoroTTS: model directory -> text -> waveform.

Port of ``kokoro_tpu/inference/tts.py``: sentence split <= 150 chars, per
chunk G2P -> ``<sil>``-flatten -> indices + stress padded up to
``PHONEME_PAD_BUCKETS`` -> AR generation -> NaN / flat-output health checks
-> clamp [-11.5, 2] -> adaptive trailing-silence trim -> vocoder -> 0.15 s
silence between chunks.  ``synthesize_mel_batch`` decodes every text of one
phoneme bucket in one batched AR run; ``batch_text_to_speech`` writes one
``output_{i:04d}.wav`` per text (kokoro-infer's file mode).

The model directory is the port's (``convert.save_model_dir``): ``model.pt``,
``metadata.json``, ``phoneme_processor.json``; or a trainer's run directory,
whose checkpoint gives the EMA or the raw weights (``use_ema_weights``: auto
| ema | model; auto takes the EMA when the checkpoint recorded EMA updates).
"""

from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from kokoro_tpu_torch.config import KokoroConfig
from kokoro_tpu_torch.convert import PROCESSOR_FILE, load_model_dir
from kokoro_tpu_torch.data import text_utils
from kokoro_tpu_torch.data.audio_io import save_wav
from kokoro_tpu_torch.data.phonemes import load_processor_json
from kokoro_tpu_torch.device import resolve_device
from kokoro_tpu_torch.inference.vocoder import VocoderManager
from kokoro_tpu_torch.models.generator import generate
from kokoro_tpu_torch.models.kokoro import KokoroModel

logger = logging.getLogger(__name__)

PHONEME_PAD_BUCKETS = (32, 64, 96, 128, 192, 256)
REPO_DOCS = Path(__file__).resolve().parents[2] / "docs"


class KokoroTTS:
    def __init__(
        self,
        model_dir: str,
        device: str | torch.device = "cuda",
        vocoder_type: str = "hifigan",
        vocoder_path: Optional[str] = None,
        use_ema_weights: str = "auto",
        max_len: Optional[int] = None,
        stop_threshold: Optional[float] = None,
        min_len_ratio: Optional[float] = None,
        min_len_floor: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.model_dir = Path(model_dir)
        self.phoneme_processor = load_processor_json(self.model_dir / PROCESSOR_FILE)
        state, meta = load_model_dir(self.model_dir, use_ema_weights)
        self.metadata = meta
        config = KokoroConfig.from_metadata(meta, use_stochastic_depth=False)
        self.model = KokoroModel(config)
        self.model.load_state_dict(state)
        self.model.to(self.device).eval()

        controls = dict(meta.get("inference_controls", {}))
        # explicit arguments take precedence over the checkpoint's values
        self.max_frames = int(max_len or controls.get("max_seq_length", 1800))
        self.stop_threshold = float(
            stop_threshold if stop_threshold is not None
            else controls.get("stop_token_threshold", 0.5)
        )
        self.post_stop_threshold = float(controls.get("post_expected_stop_threshold", 0.2))
        self.min_len_ratio = float(min_len_ratio or 0.7)
        self.min_len_floor = int(min_len_floor or 12)
        self.sample_rate = int(meta.get("sample_rate", 22050))

        if vocoder_type == "hifigan" and vocoder_path is None:
            for cand in (self.model_dir / "vocoder.npz", REPO_DOCS / "hifigan_v1_int8.npz",
                         REPO_DOCS / "hifigan_compact.npz"):
                if cand.exists():
                    vocoder_path = str(cand)
                    logger.info("Using HiFi-GAN weights: %s", vocoder_path)
                    break
        self.vocoder = VocoderManager(
            vocoder_type=vocoder_type, vocoder_path=vocoder_path,
            sample_rate=self.sample_rate, n_mels=int(meta.get("n_mels", 80)),
            hop_length=int(meta.get("hop_length", 256)), device=self.device,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def split_text(text: str, max_chars: int = 150) -> List[str]:
        """Sentence-boundary chunking."""
        pieces = re.split(r"([.!?;\n])", text)
        sentences = [pieces[i] + pieces[i + 1] for i in range(0, len(pieces) - 1, 2)]
        if len(pieces) % 2:
            sentences.append(pieces[-1])
        chunks: List[str] = []
        current = ""
        for s in sentences:
            s = s.strip()
            if not s:
                continue
            if current and len(current) + len(s) > max_chars:
                chunks.append(current.strip())
                current = s
            else:
                current = (current + " " + s).strip()
        if current:
            chunks.append(current.strip())
        return chunks

    def _encode_chunk(self, text: str) -> Optional[Dict[str, np.ndarray]]:
        raw = self.phoneme_processor.process_text(text)
        p2i = self.phoneme_processor.phoneme_to_id
        seq = text_utils.flatten_with_sil(raw, p2i)
        if not seq:
            return None
        indices = text_utils.phonemes_to_indices(seq, p2i)
        stress = text_utils.stress_indices_with_sil(raw, p2i)
        stress = (stress + [0] * len(indices))[: len(indices)]
        L = len(indices)
        bucket = next((b for b in PHONEME_PAD_BUCKETS if L <= b), L)
        pad = bucket - L
        return {
            "phoneme_indices": np.asarray(indices + [0] * pad, np.int64)[None],
            "stress_indices": np.asarray(stress + [0] * pad, np.int64)[None],
            "text_padding_mask": np.asarray([False] * L + [True] * pad, bool)[None],
        }

    def generate_batch(self, encs: List[Dict[str, np.ndarray]]):
        """One AR decode over stacked encodings (one phoneme bucket).  Returns
        ``(mel (B, max_frames, M) numpy, lengths (B,) numpy)``."""
        stacked = {
            k: torch.as_tensor(np.concatenate([e[k] for e in encs], axis=0), device=self.device)
            for k in ("phoneme_indices", "stress_indices", "text_padding_mask")
        }
        mel, length, _ = generate(
            self.model, stacked["phoneme_indices"], stacked["stress_indices"],
            stacked["text_padding_mask"], self.max_frames,
            stop_threshold=self.stop_threshold,
            post_expected_stop_threshold=self.post_stop_threshold,
            min_len_ratio=self.min_len_ratio, min_len_floor=self.min_len_floor,
            max_len_cap=min(1600, self.max_frames),
        )
        return mel.cpu().numpy(), np.atleast_1d(length.cpu().numpy())

    def synthesize_mel(self, text: str) -> Optional[np.ndarray]:
        """One chunk -> trimmed log-mel (T, n_mels)."""
        return self.synthesize_mel_batch([text])[0]

    def synthesize_mel_batch(self, texts: List[str]) -> List[Optional[np.ndarray]]:
        """Single-chunk texts grouped by phoneme bucket, one AR decode per
        group, each row trimmed on its own."""
        encs = [self._encode_chunk(t) for t in texts]
        groups: Dict[int, List[int]] = {}
        for i, enc in enumerate(encs):
            if enc is not None:
                groups.setdefault(enc["phoneme_indices"].shape[1], []).append(i)
        results: List[Optional[np.ndarray]] = [None] * len(texts)
        for idxs in groups.values():
            mel, lengths = self.generate_batch([encs[i] for i in idxs])
            for row, i in enumerate(idxs):
                n = int(lengths[row])
                if n == 0:
                    logger.warning("No mel frames generated for %r", texts[i])
                    continue
                m = mel[row, :n]
                if np.isnan(m).any():
                    logger.error("CRITICAL: mel contains NaNs")
                if m.std() < 1e-5:
                    logger.warning("Mel output has near-zero variance (flat output)")
                results[i] = self._trim_trailing_silence(np.clip(m, -11.5, 2.0))
        return results

    @staticmethod
    def _trim_trailing_silence(mel: np.ndarray) -> np.ndarray:
        """Threshold = mean of the q10/q20 frame means clamped to [-9.8, -9.2];
        keep 24 margin frames and at least 60 frames."""
        frame_means = mel.mean(axis=-1)
        if frame_means.size == 0:
            return mel
        q10 = float(np.quantile(frame_means, 0.10))
        q20 = float(np.quantile(frame_means, 0.20))
        threshold = max(-9.8, min(-9.2, 0.5 * (q10 + q20)))
        voiced = np.nonzero(frame_means > threshold)[0]
        if voiced.size == 0:
            return mel
        end = min(mel.shape[0], int(voiced[-1]) + 24 + 1)
        end = min(max(end, 60), mel.shape[0])
        return mel[:end]

    def text_to_speech(self, text: str, output_path: Optional[str] = None) -> np.ndarray:
        chunks = self.split_text(text)
        segments: List[np.ndarray] = []
        for i, chunk in enumerate(chunks):
            try:
                mel = self.synthesize_mel(chunk)
            except Exception as err:  # per-chunk isolation
                logger.exception("Chunk %d failed: %s", i, err)
                continue
            if mel is None:
                continue
            audio = self.vocoder.mel_to_audio(mel)
            peak = float(np.abs(audio).max()) if audio.size else 0.0
            if peak < 1e-4:
                logger.warning("Generated audio is nearly silent (peak %.2e)", peak)
            segments.append(audio)
            if i < len(chunks) - 1:
                segments.append(np.zeros(int(self.sample_rate * 0.15), np.float32))
        final = np.concatenate(segments) if segments else np.zeros(0, np.float32)
        if output_path:
            save_wav(output_path, final, self.sample_rate)
            logger.info("Saved %s (%.2f s)", output_path, len(final) / self.sample_rate)
        return final

    def batch_text_to_speech(self, texts: List[str], output_dir: str,
                             batched: bool = False) -> None:
        """File mode: ``output_dir/output_{i:04d}.wav`` for text i.  With
        ``batched``, the single-chunk texts decode together through
        ``synthesize_mel_batch`` (one AR decode per phoneme bucket) and the
        multi-chunk ones one after another, as without it."""
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        single = ([i for i, t in enumerate(texts) if len(self.split_text(t)) == 1]
                  if batched else [])
        for i, mel in zip(single, self.synthesize_mel_batch([texts[i] for i in single])):
            if mel is None:
                logger.warning("No output for %r", texts[i])
                continue
            audio = self.vocoder.mel_to_audio(mel)
            path = out / f"output_{i:04d}.wav"
            save_wav(path, audio, self.sample_rate)
            logger.info("Saved %s (%.2f s)", path, len(audio) / self.sample_rate)
        for i in sorted(set(range(len(texts))) - set(single)):
            self.text_to_speech(texts[i], str(out / f"output_{i:04d}.wav"))
