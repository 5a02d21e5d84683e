"""The traffic generator, the bound arithmetic and the step's FLOP count."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import bounds, traffic
from benchmark.attention_share import family
from benchmark.run import cell
from benchmark.tests.small import small_cell

BIG_SEED = 2 ** 40 + 12345  # seeds run past 32 bits


def _configs(c):
    from benchmark.program import configs

    return configs(c["config"], c["traffic"].get("training", {}))


@pytest.mark.parametrize("name", ["hp-ladder", "long-b48-t1408"])
def test_feeds_deterministic_in_seed(name):
    c = small_cell(name)
    m, t = _configs(c)

    def first(seed):
        feed = traffic.make_feed(c["traffic"], seed, m, t, torch.device("cpu"))
        return [b for b, _ in (next(traffic.iterate(feed)) for _ in range(1))][0]

    a, b, other = first(BIG_SEED), first(BIG_SEED), first(BIG_SEED + 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["mel_specs"], other["mel_specs"])


@pytest.mark.parametrize("name", ["hp-ladder", "long-b48-t1408"])
def test_durations_sum_to_frames(name):
    c = small_cell(name)
    m, t = _configs(c)
    feed = traffic.make_feed(c["traffic"], 7, m, t, torch.device("cpu"))
    steps = traffic.iterate(feed)
    for _ in range(4):
        b, info = next(steps)
        d = b["phoneme_durations"]
        assert torch.equal(d.sum(1), b["mel_lengths"].to(d.dtype))
        valid = torch.arange(d.shape[1])[None] < b["phoneme_lengths"][:, None]
        assert bool((d[valid] > 0).all()) and bool((d[~valid] == 0).all())
        assert info["true_frames"] == int(b["mel_lengths"].sum())


def test_ladder_plan_has_one_set_of_shapes():
    """Every epoch's plan of the full ladder uses the shapes of epoch 0's, so
    the set-up's first epoch warms every shape the window meets."""
    from kokoro_tpu_torch.data.batching import (
        FrameBudgetBatcher, _bucket_up, effective_batch_quantum,
    )

    c = cell("hp-ladder")
    m, t = _configs(c)
    frames, tokens = traffic.corpus_lengths(c["traffic"],
                                            np.random.default_rng(c["traffic"]["lengths_seed"]))
    assert len(frames) == 1920 and frames.min() >= 241 and frames.max() <= 896
    q = effective_batch_quantum(t.batch_size_multiple, t.max_batch_size)
    batcher = FrameBudgetBatcher(
        list(zip(frames.tolist(), tokens.tolist())), t.max_frames_per_batch, t.min_batch_size,
        t.max_batch_size, seed=BIG_SEED, batch_order=t.batch_order,
        mel_buckets=t.mel_bucket_sizes, phoneme_buckets=t.phoneme_bucket_sizes,
        carry_tail=t.carry_tail, pack_mode=t.pack_mode, batch_quantum=q)

    def shapes(epoch):
        out = set()
        for b in batcher.build_batches(epoch):
            rows = -(-len(b) // q) * q
            out.add((rows, _bucket_up(max(frames[i] for i in b), t.mel_bucket_sizes),
                     _bucket_up(max(tokens[i] for i in b), t.phoneme_bucket_sizes)))
            assert rows * _bucket_up(max(frames[i] for i in b), t.mel_bucket_sizes) <= 65536
        return out

    first = shapes(0)
    assert 9 <= len(first) <= 14
    for epoch in range(1, 6):
        assert shapes(epoch) == first


def test_attention_bounds_hand_counted():
    k1 = bounds.attention_bound(2, 4, 1, 64, "bfloat16", True)
    assert k1["ops"] == 4 * 64 * 20  # 2 rows x (4 * 5 / 2) visible pairs
    assert k1["bound_s"] == pytest.approx(max(4 * 2 * 4 * 64 * 2 / 3.35e12, 5120 / 989e12))
    k2 = bounds.attention_bound(2, 4, 1, 64, "bfloat16", False, [3, 0])
    assert k2["ops"] == 4 * 64 * 4 * (3 + 4)  # a row of length 0 averages all keys
    k4 = bounds.attention_bound(1, 128, 2, 64, "bfloat16", True, backward=True)
    assert k4["ops"] == 10 * 64 * 2 * (128 * 129 // 2)
    nbytes = 8 * 128 * 2 * 64 * 2 + 4 * 2 * 128
    assert k4["bound_s"] == pytest.approx(max(nbytes / 3.35e12, k4["ops"] / 989e12))
    # K4 at the long cell's shape is bound by its operations
    assert bounds.attention_bound(48, 1408, 8, 64, "bfloat16", True)["bound_by"] == "operations"


def test_kernel_families():
    assert family("void kokoro_attn::tc::fwd_kernel<64, false, true, true, false>(x)") == "packed"
    assert family("void kokoro_attn::tc::bwd_dq_kernel<64, true, false>(x)") == "flash"
    assert family("void kokoro_attn::scores_tc::rows_kernel(x)") == "flash"
    assert family("void at::native::vectorized_elementwise_kernel<4>(x)") is None


def test_forward_flops_equal_the_flop_counter():
    """``forward_flops`` with the causal square counted whole equals
    ``FlopCounterMode`` over a training forward of the port's plain route."""
    from torch.utils.flop_counter import FlopCounterMode

    from kokoro_tpu_torch.config import get_high_performance_config
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.models.rng import Rng
    from benchmark.tests.small import SMOKE_MODEL

    model_cfg, _ = get_high_performance_config(use_flash_attention=False, **SMOKE_MODEL)
    model = KokoroModel(model_cfg).init_weights(torch.Generator().manual_seed(0)).train()
    B, T, L = 2, 96, 16
    g = torch.Generator().manual_seed(1)
    dur = torch.full((B, L), T // L, dtype=torch.int32)
    with FlopCounterMode(display=False) as counter:
        model(phoneme_indices=torch.randint(1, 59, (B, L), generator=g),
              mel_specs=torch.randn(B, T, 80, generator=g), phoneme_durations=dur,
              stress_indices=torch.randint(0, 3, (B, L), generator=g),
              text_padding_mask=torch.zeros(B, L, dtype=torch.bool),
              mel_padding_mask=torch.zeros(B, T, dtype=torch.bool),
              pitch_targets=torch.rand(B, T, generator=g),
              energy_targets=torch.rand(B, T, generator=g), rng=Rng(3))
    m = dict(vars(model_cfg))
    assert bounds.forward_flops(m, B, T, L, causal_full=True) == counter.get_total_flops()
    # the causal triangle: the decoder's self-attention products at T(T+1)/2 pairs a row
    half = bounds.forward_flops(m, B, T, L, causal_full=True) - bounds.forward_flops(m, B, T, L)
    assert half == m["n_decoder_layers"] * 4 * m["hidden_dim"] * B * (T * T - T * (T + 1) // 2)
    assert bounds.step_flops(m, B, T, L) == 3 * bounds.forward_flops(m, B, T, L)
