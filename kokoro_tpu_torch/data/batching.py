"""Frame-budget batching with static length buckets, and collate.

The port's own copy of ``kokoro_tpu/data/batching.py`` (numpy only; the
spans ``kokoro.plan`` and ``kokoro.collate`` and ``collate``'s frame counts
are ``utils/profiling.py``'s): the
reference's ``DynamicFrameBatchSampler`` packing (sqrt(N) quantile length
buckets or per-bucket grouping, greedy packing with ``cost = quantized rows
x max frames``, min/max batch sizes, heavy-batch spreading or shape-major
order), rebuilt each epoch from ``seed + epoch``, so the same lengths, config
and seed give the JAX package's batch plan.  ``collate`` pads a batch to the
config's (mel, phoneme) buckets and builds the smoothed stop-token targets.
Static bucket shapes are kept although PyTorch compiles nothing: they bound
the distinct shapes the kernels and the allocator see, and they keep the
batches identical to the reference's.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from kokoro_tpu_torch.config import TrainingConfig
from kokoro_tpu_torch.utils.profiling import count_batch, span


def _bucket_up(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value (last bucket caps)."""
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def effective_batch_quantum(
    batch_size_multiple: Optional[int], max_batch_size: int, dp_size: int = 1
) -> int:
    """The multiple the padded batch dimension is rounded UP to at staging
    time (trainer) — config quantum lcm'd with the data-parallel degree so
    every shard stays equal-sized."""
    q = (
        int(batch_size_multiple)
        if batch_size_multiple
        else min(4, max(max_batch_size, 1))
    )
    return math.lcm(max(dp_size, 1), q)


class FrameBudgetBatcher:
    """Greedy frame-budget packer with per-epoch shuffling and heavy-batch
    spreading (reference dataset.py:924-1143)."""

    def __init__(
        self,
        lengths: Sequence[Tuple[int, int]],   # (mel_frames, phonemes) per item
        max_frames_per_batch: int = 15000,
        min_batch_size: int = 4,
        max_batch_size: int = 8,
        seed: int = 42,
        drop_incomplete: bool = False,
        batch_order: str = "spread",
        mel_buckets: Optional[Sequence[int]] = None,
        phoneme_buckets: Optional[Sequence[int]] = None,
        carry_tail: bool = False,
        pack_mode: str = "quantile",
        batch_quantum: int = 1,
    ):
        self.lengths = list(lengths)
        self.max_frames = max_frames_per_batch
        self.min_batch = max(1, min_batch_size)
        self.max_batch = max(self.min_batch, max_batch_size)
        self.seed = seed
        self.drop_incomplete = drop_incomplete
        if batch_order not in ("spread", "shape_major"):
            raise ValueError(
                f"batch_order must be 'spread' or 'shape_major', got {batch_order!r}"
            )
        self.batch_order = batch_order
        self.mel_buckets = tuple(mel_buckets) if mel_buckets else None
        self.phoneme_buckets = tuple(phoneme_buckets) if phoneme_buckets else None
        # carry_tail=True: a quantile bucket's ragged last batch carries into
        # the next bucket instead of flushing short (reference flushes per
        # bucket, :1010-1025).  Sorted bucket order keeps carried items
        # adjacent in length, so padding barely grows while nearly every
        # batch reaches full rows (masked tail rows are wasted compute under
        # static batch shapes).
        self.carry_tail = carry_tail
        # pack_mode='bucket': items are grouped by their OWN padded mel bucket
        # before packing, so a batch never mixes items destined for different
        # buckets (quantile packing lets one long straggler drag a whole batch
        # up a bucket).  Requires mel_buckets; falls back to quantile packing
        # without them.
        if pack_mode not in ("quantile", "bucket"):
            raise ValueError(
                f"pack_mode must be 'quantile' or 'bucket', got {pack_mode!r}"
            )
        self.pack_mode = pack_mode
        # batch_quantum: the trainer pads the batch dim UP to this multiple.
        # The budget check therefore prices a candidate batch at its
        # QUANTIZED row count — the device cost — or the packer could emit
        # e.g. 18 rows at T896 that pad to 24x896 and exceed the budget.
        self.batch_quantum = max(1, int(batch_quantum))
        self.epoch = 0

    def _quantized_rows(self, rows: int) -> int:
        q = self.batch_quantum
        return ((rows + q - 1) // q) * q

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self.build_batches(self.epoch))

    def __len__(self) -> int:
        return len(self.build_batches(self.epoch))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def build_batches(self, epoch: int = 0) -> List[List[int]]:
        with span("plan"):
            n = len(self.lengths)
            if n == 0:
                return []
            rng = np.random.default_rng(self.seed + epoch)

            if self.pack_mode == "bucket" and self.mel_buckets:
                # group by each item's own padded mel bucket; no cross-bucket
                # mixing.  The per-group budget check uses the BUCKET size, not
                # the running max — the padded cost is what the device pays.
                groups: Dict[int, List[int]] = {}
                for i in range(n):
                    groups.setdefault(
                        _bucket_up(self.lengths[i][0], self.mel_buckets), []
                    ).append(i)
                buckets = [groups[k] for k in sorted(groups)]
                for b in buckets:
                    rng.shuffle(b)
                batches: List[List[int]] = []
                current: List[int] = []
                for bucket_len, bucket in zip(sorted(groups), buckets):
                    for idx in bucket:
                        if current and (
                            self._quantized_rows(len(current) + 1) * bucket_len
                            > self.max_frames
                            or len(current) >= self.max_batch
                        ):
                            batches.append(current)
                            current = []
                        current.append(idx)
                    # carry_tail: a group's ragged tail rides into the NEXT
                    # (larger) bucket group — those few items pad up one bucket,
                    # which costs far less than a whole batch of padded rows.
                    # Without carry, flush per group (one ragged batch each).
                    if not self.carry_tail:
                        if current and (
                            len(current) >= self.min_batch
                            or not self.drop_incomplete
                        ):
                            batches.append(current)
                        current = []
                if current and (
                    len(current) >= self.min_batch or not self.drop_incomplete
                ):
                    batches.append(current)
                if self.batch_order == "shape_major":
                    return self._shape_major(batches, rng)
                return self._spread_heavy(batches, rng)

            # sqrt(N) quantile buckets over mel length (<= 16) keep batchmates
            # similar-length, minimizing padding (reference :951-1010)
            order = sorted(range(n), key=lambda i: self.lengths[i][0])
            n_buckets = min(16, max(1, int(math.sqrt(n))))
            bucket_size = math.ceil(n / n_buckets)
            buckets = [
                order[k : k + bucket_size] for k in range(0, n, bucket_size)
            ]
            for b in buckets:
                rng.shuffle(b)

            batches: List[List[int]] = []
            current: List[int] = []
            current_max = 0
            for bucket in buckets:
                for idx in bucket:
                    mel_len = self.lengths[idx][0]
                    new_max = max(current_max, mel_len)
                    cost = self._quantized_rows(len(current) + 1) * new_max
                    if current and (
                        cost > self.max_frames or len(current) >= self.max_batch
                    ):
                        batches.append(current)
                        current, current_max = [], 0
                        new_max = mel_len
                    current.append(idx)
                    current_max = new_max
                if not self.carry_tail:
                    if current and (
                        len(current) >= self.min_batch or not self.drop_incomplete
                    ):
                        batches.append(current)
                    current, current_max = [], 0
            if current and (
                len(current) >= self.min_batch or not self.drop_incomplete
            ):
                batches.append(current)

            if self.batch_order == "shape_major":
                return self._shape_major(batches, rng)
            return self._spread_heavy(batches, rng)

    def _padded_shape(self, batch: List[int]) -> Tuple[int, int]:
        """The static (mel_bucket, phoneme_bucket) this batch pads to."""
        mel = max(self.lengths[i][0] for i in batch)
        ph = max(self.lengths[i][1] for i in batch)
        if self.mel_buckets:
            mel = _bucket_up(mel, self.mel_buckets)
        if self.phoneme_buckets:
            ph = _bucket_up(ph, self.phoneme_buckets)
        return mel, ph

    def _shape_major(
        self, batches: List[List[int]], rng: np.random.Generator
    ) -> List[List[int]]:
        """Shape-major order: group batches by padded shape so consecutive
        same-shape runs are maximal.  The reference's global heavy-batch spreading
        (:1078-1126) would interleave shapes and break every run; its intent
        — don't cluster the costliest batches — is preserved WITHIN each
        shape group, and group order is shuffled per epoch so no shape
        always leads an epoch."""
        groups: Dict[Tuple[int, int], List[List[int]]] = {}
        for b in batches:
            groups.setdefault(self._padded_shape(b), []).append(b)
        keys = sorted(groups)
        rng.shuffle(keys)
        out: List[List[int]] = []
        for key in keys:
            out.extend(self._spread_heavy(groups[key], rng))
        return out

    def _spread_heavy(
        self, batches: List[List[int]], rng: np.random.Generator
    ) -> List[List[int]]:
        """Place the top-sqrt(B) costliest batches at evenly spaced anchors
        (reference :1078-1126)."""
        if len(batches) <= 2:
            return batches
        cost = lambda b: len(b) * max(self.lengths[i][0] for i in b)
        by_cost = sorted(range(len(batches)), key=lambda k: -cost(batches[k]))
        n_heavy = max(1, int(math.sqrt(len(batches))))
        heavy = set(by_cost[:n_heavy])
        light = [batches[k] for k in range(len(batches)) if k not in heavy]
        rng.shuffle(light)
        heavy_batches = [batches[k] for k in by_cost[:n_heavy]]
        total = len(batches)
        anchors = [int(a * total / n_heavy) for a in range(n_heavy)]
        out: List[Optional[List[int]]] = [None] * total
        for anchor, hb in zip(anchors, heavy_batches):
            out[min(anchor, total - 1)] = hb
        it = iter(light)
        for k in range(total):
            if out[k] is None:
                out[k] = next(it)
        return out  # type: ignore[return-value]


class FixedSizeBatcher(FrameBudgetBatcher):
    """Fixed-size batching (reference ``LengthBasedBatchSampler``, :1145):
    delegates to the frame packer with an unbounded budget."""

    def __init__(self, lengths, batch_size: int, seed: int = 42):
        super().__init__(
            lengths,
            max_frames_per_batch=2**31,
            min_batch_size=batch_size,
            max_batch_size=batch_size,
            seed=seed,
        )


def collate(
    features: List[Dict],
    config: TrainingConfig,
    n_mels: int,
    pad_batch_to: Optional[int] = None,
    pad_mel_to: Optional[int] = None,
    pad_phoneme_to: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Pad a list of per-utterance feature dicts to static bucket shapes.

    Returns the train-step batch dict (numpy).  ``n_mels`` is the model's
    (``KokoroConfig.n_mels``).  Mel/phoneme dims round up to
    the config bucket tables; the batch dim optionally rounds up to
    ``pad_batch_to`` (padding rows have zero lengths, fully masked out by the
    loss — same masking semantics as the reference's collate_fn zero padding,
    reference dataset.py:871-922).

    ``pad_mel_to`` / ``pad_phoneme_to`` force the pre-bucketing sequence dims.
    Multi-host data parallelism needs this: every process must produce the
    SAME padded shapes without seeing the other processes' features, so the
    dims come from host-side length metadata instead of the local maxima.
    When forced, longer local samples are clipped (same truncation semantics
    as the reference's max_seq_length cap).  An empty ``features`` list (a
    process whose block is pure padding) is valid only with forced dims.
    """
    with span("collate"):
        B = len(features)
        out_B = max(B, pad_batch_to or B)
        if not features and (pad_mel_to is None or pad_phoneme_to is None):
            raise ValueError("empty collate requires pad_mel_to and pad_phoneme_to")
        mel_max = max((int(f["mel_length"]) for f in features), default=1)
        phon_max = max((int(f["phoneme_length"]) for f in features), default=1)
        if pad_mel_to is not None:
            mel_max = pad_mel_to
        if pad_phoneme_to is not None:
            phon_max = pad_phoneme_to
        # Hard sequence-dim cap (reference trainer.py:2168-2184
        # _cap_batch_sequence_dimensions, config.max_sequence_dim_cap): no batch
        # tensor ever exceeds the cap; over-long samples truncate with clamped
        # lengths.
        cap = int(config.max_sequence_dim_cap)
        if cap > 0:
            mel_max = min(mel_max, cap)
            phon_max = min(phon_max, cap)
        T = _bucket_up(mel_max, config.mel_bucket_sizes)
        L = _bucket_up(phon_max, config.phoneme_bucket_sizes)
        if cap > 0:
            T = min(T, cap)
            L = min(L, cap)
        M = n_mels

        batch = {
            "mel_specs": np.zeros((out_B, T, M), np.float32),
            "phoneme_indices": np.zeros((out_B, L), np.int32),
            "stress_indices": np.zeros((out_B, L), np.int32),
            "phoneme_durations": np.zeros((out_B, L), np.int32),
            "pitch_targets": np.zeros((out_B, T), np.float32),
            "energy_targets": np.zeros((out_B, T), np.float32),
            "stop_token_targets": np.zeros((out_B, T), np.float32),
            "mel_lengths": np.zeros((out_B,), np.int32),
            "phoneme_lengths": np.zeros((out_B,), np.int32),
        }
        tail = config.stop_token_smooth_tail
        decay = config.stop_token_smooth_decay
        for i, f in enumerate(features):
            t = min(int(f["mel_length"]), T)
            l = min(int(f["phoneme_length"]), L)
            batch["mel_specs"][i, :t] = f["mel_spec"][:t]
            batch["phoneme_indices"][i, :l] = f["phoneme_indices"][:l]
            batch["stress_indices"][i, :l] = f["stress_indices"][:l]
            batch["phoneme_durations"][i, :l] = f["phoneme_durations"][:l]
            batch["pitch_targets"][i, :t] = f["pitch"][:t]
            batch["energy_targets"][i, :t] = f["energy"][:t]
            batch["mel_lengths"][i] = t
            batch["phoneme_lengths"][i] = l
            # smoothed stop tail: frame[t-1-k] = decay^k (reference dataset.py:32-65)
            n_tail = min(tail + 1, t)
            ks = np.arange(n_tail, dtype=np.float32)
            batch["stop_token_targets"][i, t - n_tail : t] = (decay**ks)[::-1]
    count_batch(int(batch["mel_lengths"].sum()), out_B * T)
    return batch
