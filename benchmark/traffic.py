"""The one generator of the benchmark's traffic mixes.

A mix is a JSON file under ``benchmark/traffic/``; its ``kind`` says which of
two feeds it describes:

* ``corpus``: a synthetic corpus of utterances in duration clusters (count,
  seconds, phonemes per cluster), their features made on the host from the
  seed; the port's own batcher (``FrameBudgetBatcher``) plans each epoch
  from ``seed + epoch`` under the mix's batching fields, and each step is
  collated with the port's ``collate`` and copied to the device, as the
  trainer does;
* ``resident``: a few batches of fixed shape made on the device from the
  seed, with each row's mel and phoneme lengths drawn in the mix's ranges,
  cycled step after step.

The lengths (each utterance's frames and phonemes) come from the mix's own
``lengths_seed``, so every run does the same work; the run's seed draws the
features, the durations, the order of the rows and the batcher's plans.
Each utterance's durations are positive and sum to its frames, so the length
regulator, K2's key lengths and the losses see real masks.  Features: log-mel
values ``mel_mean + mel_std * N(0, 1)``, pitch and energy uniform in [0, 1],
stress in {0, 1, 2}, phoneme ids in [1, vocab).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

def derive(seed: int, name: str) -> int:
    """A 63-bit seed for the part ``name`` of a run with ``seed``."""
    digest = hashlib.blake2b(f"{int(seed)}/{name}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def compositions(rng: np.random.Generator, frames: np.ndarray, tokens: np.ndarray,
                 width: int) -> np.ndarray:
    """``(N, width)`` int32 durations: row i has ``tokens[i]`` positive
    durations summing to ``frames[i]`` (cut points drawn without
    replacement), zeros after them."""
    out = np.zeros((len(frames), width), np.int32)
    for i, (f, n) in enumerate(zip(frames.tolist(), tokens.tolist())):
        cuts = np.sort(rng.choice(np.arange(1, f), size=n - 1, replace=False))
        out[i, :n] = np.diff(np.concatenate(([0], cuts, [f])))
    return out


def stop_targets(lengths: torch.Tensor, T: int, tail: int, decay: float) -> torch.Tensor:
    """The smoothed stop targets ``collate`` builds: ``decay**k`` at frame
    ``length - 1 - k`` for k = 0..tail."""
    pos = torch.arange(T, device=lengths.device)[None, :]
    k = (lengths[:, None] - 1) - pos
    hit = (k >= 0) & (k <= tail)
    return torch.where(hit, decay ** torch.clamp(k, min=0).float(),
                       torch.zeros((), device=lengths.device))


def corpus_lengths(mix: dict, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Mel frames and phonemes of each utterance of a corpus mix, cluster by
    cluster: seconds and phonemes uniform in the cluster's ranges."""
    hop = mix["sample_rate"] / mix["hop_length"]
    frames, tokens = [], []
    for c in mix["clusters"]:
        secs = rng.uniform(c["seconds"][0], c["seconds"][1], c["count"])
        frames.append(np.floor(secs * hop).astype(np.int64))
        tokens.append(rng.integers(c["phonemes"][0], c["phonemes"][1] + 1, c["count"]))
    return np.concatenate(frames), np.concatenate(tokens)


class CorpusFeed:
    """Steps over a synthetic corpus planned by the port's batcher."""

    def __init__(self, mix: dict, seed: int, model_cfg, train_cfg, device) -> None:
        from kokoro_tpu_torch.data.batching import (
            FrameBudgetBatcher, collate, effective_batch_quantum,
        )

        self.collate, self.cfg, self.device = collate, train_cfg, device
        self.n_mels = model_cfg.n_mels
        frames, tokens = corpus_lengths(mix, np.random.default_rng(mix["lengths_seed"]))
        rng = np.random.default_rng(derive(seed, "corpus"))
        durations = compositions(rng, frames, tokens, int(tokens.max()))
        offsets = np.concatenate(([0], np.cumsum(frames)))
        mel = rng.standard_normal((int(offsets[-1]), self.n_mels), dtype=np.float32)
        mel = mix["mel_mean"] + mix["mel_std"] * mel
        pitch = rng.random(int(offsets[-1]), dtype=np.float32)
        energy = rng.random(int(offsets[-1]), dtype=np.float32)
        ids = rng.integers(1, model_cfg.vocab_size, durations.shape).astype(np.int32)
        stress = rng.integers(0, 3, durations.shape).astype(np.int32)
        self.items = []
        for i, (f, n) in enumerate(zip(frames.tolist(), tokens.tolist())):
            a, b = offsets[i], offsets[i + 1]
            self.items.append({
                "mel_spec": mel[a:b], "pitch": pitch[a:b], "energy": energy[a:b],
                "phoneme_indices": ids[i, :n], "stress_indices": stress[i, :n],
                "phoneme_durations": durations[i, :n], "mel_length": f, "phoneme_length": n,
            })
        self.lengths = list(zip(frames.tolist(), tokens.tolist()))
        self.quantum = effective_batch_quantum(train_cfg.batch_size_multiple,
                                               train_cfg.max_batch_size)
        self.batcher = FrameBudgetBatcher(
            self.lengths, max_frames_per_batch=train_cfg.max_frames_per_batch,
            min_batch_size=train_cfg.min_batch_size, max_batch_size=train_cfg.max_batch_size,
            seed=derive(seed, "plan"), batch_order=train_cfg.batch_order,
            mel_buckets=train_cfg.mel_bucket_sizes,
            phoneme_buckets=train_cfg.phoneme_bucket_sizes, carry_tail=train_cfg.carry_tail,
            pack_mode=train_cfg.pack_mode, batch_quantum=self.quantum)
        self.epoch, self.plan, self.pos = 0, self.batcher.build_batches(0), 0

    def steps_per_epoch(self) -> int:
        return len(self.plan)

    def host_batch(self) -> Tuple[Dict[str, np.ndarray], int]:
        """The next step's collated batch and its epoch."""
        if self.pos == len(self.plan):
            self.epoch += 1
            self.plan, self.pos = self.batcher.build_batches(self.epoch), 0
        indices = self.plan[self.pos]
        self.pos += 1
        rows = -(-len(indices) // self.quantum) * self.quantum
        batch = self.collate([self.items[i] for i in indices], self.cfg, self.n_mels,
                             pad_batch_to=rows)
        return batch, self.epoch

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}


class ResidentFeed:
    """A few batches of one shape made on the device, cycled."""

    def __init__(self, mix: dict, seed: int, model_cfg, train_cfg, device) -> None:
        self.device = device
        B, L, T = mix["rows"], mix["phonemes"], mix["frames"]
        lengths_rng = np.random.default_rng(mix["lengths_seed"])
        rng = np.random.default_rng(derive(seed, "resident"))
        gen = torch.Generator(device=device).manual_seed(derive(seed, "resident_device"))
        self.batches: List[Dict[str, torch.Tensor]] = []
        self.true_frames: List[int] = []
        for _ in range(mix["batches"]):
            mel_len = lengths_rng.integers(mix["mel_lengths"][0], mix["mel_lengths"][1] + 1, B)
            ph_len = lengths_rng.integers(mix["phoneme_lengths"][0],
                                          mix["phoneme_lengths"][1] + 1, B)
            mel_len, ph_len = rng.permutation(mel_len), rng.permutation(ph_len)
            dur = compositions(rng, mel_len, ph_len, L)
            self.true_frames.append(int(mel_len.sum()))
            lengths = torch.as_tensor(mel_len, dtype=torch.int32, device=device)
            frame_ok = torch.arange(T, device=device)[None, :] < lengths[:, None]
            ph_ok = (torch.arange(L, device=device)[None, :]
                     < torch.as_tensor(ph_len, device=device)[:, None])
            mel = mix["mel_mean"] + mix["mel_std"] * torch.randn(
                B, T, model_cfg.n_mels, generator=gen, device=device)
            draws = torch.rand(2, B, T, generator=gen, device=device)
            ids = torch.randint(1, model_cfg.vocab_size, (2, B, L), generator=gen,
                                device=device, dtype=torch.int32)
            self.batches.append({
                "mel_specs": mel * frame_ok[:, :, None],
                "phoneme_indices": ids[0] * ph_ok,
                "stress_indices": torch.remainder(ids[1], 3) * ph_ok,
                "phoneme_durations": torch.as_tensor(dur, device=device),
                "pitch_targets": draws[0] * frame_ok, "energy_targets": draws[1] * frame_ok,
                "stop_token_targets": stop_targets(lengths, T, train_cfg.stop_token_smooth_tail,
                                                   train_cfg.stop_token_smooth_decay),
                "mel_lengths": lengths,
                "phoneme_lengths": torch.as_tensor(ph_len, dtype=torch.int32, device=device),
            })
        self.pos = 0

    def steps_per_epoch(self) -> int:
        return len(self.batches)

    def device_batch(self) -> Tuple[Dict[str, torch.Tensor], int]:
        """The next step's batch and its true frames."""
        i = self.pos % len(self.batches)
        self.pos += 1
        return self.batches[i], self.true_frames[i]


FEEDS = {"corpus": CorpusFeed, "resident": ResidentFeed}


def make_feed(mix: dict, seed: int, model_cfg, train_cfg, device):
    return FEEDS[mix["kind"]](mix, seed, model_cfg, train_cfg, device)


def iterate(feed) -> Iterator[Tuple[Dict[str, torch.Tensor], dict]]:
    """Endless ``(device batch, info)``; ``info`` holds the step's true and
    padded frames, its (B, T, L) and, for a corpus, its epoch and the host
    seconds of collate and copy."""
    import time

    while True:
        if isinstance(feed, CorpusFeed):
            t0 = time.perf_counter()
            host, epoch = feed.host_batch()
            batch = feed.to_device(host)
            info = {"collate_s": time.perf_counter() - t0, "epoch": epoch,
                    "true_frames": int(host["mel_lengths"].sum()), "host": host}
        else:
            batch, frames = feed.device_batch()
            info = {"epoch": (feed.pos - 1) // len(feed.batches), "true_frames": frames,
                    "host": None}
        B, T = batch["mel_specs"].shape[:2]
        info.update(shape=(B, T, batch["phoneme_indices"].shape[1]), padded_frames=B * T)
        yield batch, info
