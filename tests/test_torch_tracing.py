"""The port's spans and counters (``kokoro_tpu_torch/utils/profiling.py``) on
the CPU, on the port's smoke model at hidden 128 with two heads of 64 (so
that the packed attention entry is taken) and batches from its own batcher
and ``collate``:

* one step under ``torch.profiler`` gives exactly the step's spans, nested
  as ``utils/profiling.py`` lists them, those outside the model's parts
  carrying the step's ordinal; ``kokoro.ema`` only on a step that updates
  the EMA; ``kokoro.forward`` and ``kokoro.backward`` once a microbatch; the
  data path's ``kokoro.plan`` and ``kokoro.collate`` once a plan and once a
  batch;
* with no profiler ``span`` is one shared no-op, and the state after two
  steps is bitwise the state of a run whose spans are ``nullcontext``;
* the attention entries' tally equals the benchmark's recorder
  (``benchmark/program.py::attention_recorder``) grouped by the same key;
  ``collate``'s frame counts equal the benchmark's true and padded frames
  over an epoch of its small corpus mix; the counters lose no count to two
  threads;
* ``InterbatchProfiler``'s phases are the spans' names, and it opens no
  range of its own.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kokoro_tpu_torch.config import get_smoke_test_config
from kokoro_tpu_torch.data import batching
from kokoro_tpu_torch.models import kokoro as kokoro_model
from kokoro_tpu_torch.ops import flash_attention as flash
from kokoro_tpu_torch.training import train_step
from kokoro_tpu_torch.training.optimizer import build_preclip_norms
from kokoro_tpu_torch.utils import profiling

# every span of a training step and the span it sits in
STEP_SPANS = {
    "kokoro.train_step": None,
    "kokoro.forward": "kokoro.train_step",
    "kokoro.encoder": "kokoro.forward",
    "kokoro.variance": "kokoro.forward",
    "kokoro.decoder": "kokoro.forward",
    "kokoro.loss": "kokoro.forward",
    "kokoro.backward": "kokoro.train_step",
    "kokoro.optimizer": "kokoro.train_step",
    "kokoro.clip": "kokoro.optimizer",
    "kokoro.host_read": "kokoro.optimizer",
    "kokoro.update": "kokoro.optimizer",
    "kokoro.ema": "kokoro.update",
}
# the model's parts, which take the step from the enclosing kokoro.forward
MODEL_PARTS = {"kokoro.encoder", "kokoro.variance", "kokoro.decoder", "kokoro.loss"}


def _configs(**overrides):
    return get_smoke_test_config(hidden_dim=128, n_heads=2, encoder_ff_dim=256,
                                 decoder_ff_dim=256, use_flash_attention=True, **overrides)


def _features(n_mels, n=12, seed=0):
    """``n`` utterances of 60-120 frames and 10-30 phonemes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        T, L = int(rng.integers(60, 121)), int(rng.integers(10, 31))
        durations = np.full(L, T // L, np.int32)
        durations[-1] += T - durations.sum()
        out.append({"mel_length": T, "phoneme_length": L,
                    "mel_spec": rng.normal(-5.0, 2.0, (T, n_mels)).astype(np.float32),
                    "phoneme_indices": rng.integers(1, 59, L).astype(np.int32),
                    "stress_indices": rng.integers(0, 3, L).astype(np.int32),
                    "phoneme_durations": durations,
                    "pitch": rng.uniform(size=T).astype(np.float32),
                    "energy": rng.uniform(size=T).astype(np.float32)})
    return out


def _batches(model_cfg, train_cfg, features):
    """One epoch of the port's batcher over ``features``, collated."""
    plan = batching.FrameBudgetBatcher(
        [(f["mel_length"], f["phoneme_length"]) for f in features],
        max_frames_per_batch=512, min_batch_size=1, max_batch_size=4,
        mel_buckets=train_cfg.mel_bucket_sizes,
        phoneme_buckets=train_cfg.phoneme_bucket_sizes).build_batches()
    for rows in plan:
        host = batching.collate([features[i] for i in rows], train_cfg, model_cfg.n_mels)
        yield {k: torch.from_numpy(v) for k, v in host.items()}


class _Program:
    """The smoke model's state, step, batches and the step's generator."""

    def __init__(self, ema_every=1, compute_dtype="float32"):
        self.model_cfg, self.train_cfg = _configs(ema_update_every=ema_every,
                                                  compute_dtype=compute_dtype)
        model = kokoro_model.KokoroModel(self.model_cfg).init_weights(
            torch.Generator().manual_seed(0))
        self.state = train_step.create_train_state(model, self.train_cfg, total_steps=100)
        self.step = train_step.make_train_step(
            self.train_cfg, build_preclip_norms(self.state.names, self.train_cfg), 0.99)
        self.features = _features(self.model_cfg.n_mels)
        self.gen = torch.Generator().manual_seed(1)

    def batches(self, n):
        out = list(_batches(self.model_cfg, self.train_cfg, self.features))
        assert len(out) >= n
        return out[:n]

    def run(self, batch):
        return self.step(self.state, batch, self.gen)


def _spans(prof):
    """(start, end, name, thread, inputs) of every ``kokoro.*`` range."""
    return sorted((e.time_range.start, e.time_range.end, e.name, e.thread,
                   list(e.concrete_inputs or [])) for e in prof.events()
                  if e.name.startswith(profiling.SPAN_PREFIX))


def test_step_spans_nested_with_the_step_ordinal():
    program = _Program(ema_every=2)
    batches = program.batches(2)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        for batch in batches:
            program.run(batch)
    spans = _spans(prof)
    outer = [s for s in spans if s[2] == profiling.STEP]
    assert len(outer) == 2
    seen = 0
    for ordinal, (a, b, _, thread, _) in enumerate(outer):
        inside = [s for s in spans if a <= s[0] and s[1] <= b]
        seen += len(inside)
        names = Counter(s[2] for s in inside)
        # ema_update_every=2: the first step (opt_step 0) leaves the EMA alone
        want = set(STEP_SPANS) - ({"kokoro.ema"} if ordinal == 0 else set())
        assert set(names) == want and set(names.values()) == {1}
        assert all(s[3] == thread for s in inside)
        assert all(s[4] == ([] if s[2] in MODEL_PARTS else [ordinal]) for s in inside)
        by_name = {s[2]: s for s in inside}
        for name, parent in STEP_SPANS.items():
            if parent is not None and name in by_name:
                child, up = by_name[name], by_name[parent]
                assert up[0] <= child[0] and child[1] <= up[1], (name, parent)
        for first, second in (("kokoro.encoder", "kokoro.variance"),
                              ("kokoro.variance", "kokoro.decoder"),
                              ("kokoro.decoder", "kokoro.loss"),
                              ("kokoro.forward", "kokoro.backward"),
                              ("kokoro.backward", "kokoro.optimizer"),
                              ("kokoro.clip", "kokoro.host_read"),
                              ("kokoro.host_read", "kokoro.update")):
            assert by_name[first][1] <= by_name[second][0], (first, second)
    assert seen == len(spans)


def test_forward_and_backward_once_a_microbatch():
    program = _Program()
    host = [batching.collate(program.features[i:i + 2], program.train_cfg,
                             program.model_cfg.n_mels, pad_mel_to=128, pad_phoneme_to=32)
            for i in (0, 2)]
    batch = {k: torch.from_numpy(np.stack([h[k] for h in host])) for k in host[0]}
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        program.run(batch)
    names = Counter(s[2] for s in _spans(prof))
    per_micro = {"kokoro.forward", "kokoro.backward"} | MODEL_PARTS
    assert names == {n: 2 if n in per_micro else 1 for n in STEP_SPANS}
    assert {tuple(s[4]) for s in _spans(prof) if s[2] not in MODEL_PARTS} == {(0,)}


def test_data_path_spans_once_a_plan_and_once_a_batch():
    model_cfg, train_cfg = _configs()
    features = _features(model_cfg.n_mels)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        n = sum(1 for _ in _batches(model_cfg, train_cfg, features))
    assert n > 1
    assert Counter(s[2] for s in _spans(prof)) == {"kokoro.collate": n, "kokoro.plan": 1}


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("train_step", 3) is profiling.span("collate")

    def two_steps():
        program = _Program()
        for batch in program.batches(2):
            program.run(batch)
        state, opt = program.state, program.state.optimizer
        return ([p.detach() for p in state.model.parameters()] + list(state.ema.values())
                + list(opt.mu) + list(opt.nu))

    with_spans = two_steps()
    for module in (train_step, kokoro_model, batching):
        monkeypatch.setattr(module, "span", lambda *a, **k: contextlib.nullcontext())
    without = two_steps()
    assert len(with_spans) == len(without)
    assert all(torch.equal(a, b) for a, b in zip(with_spans, without))


def _recorded(calls):
    return dict(Counter((x["kind"], x["B"], x["T"], x["H"], x["Dh"], x["dtype"], x["causal"],
                         x["grad"]) for x in calls))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_attention_tally_equals_the_recorder(compute_dtype):
    from benchmark.program import attention_recorder

    program = _Program(compute_dtype=compute_dtype)
    batches = program.batches(2)
    calls = []
    profiling.reset_counters()
    with attention_recorder(calls):
        for batch in batches:
            program.run(batch)
    assert calls and {x["kind"] for x in calls} == {"packed"}
    assert profiling.counters()["attention"] == _recorded(calls)


def test_flash_entry_tally_equals_the_recorder():
    from benchmark.program import attention_recorder

    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 1, 64, 64, generator=gen, requires_grad=True) for _ in range(3))
    calls = []
    profiling.reset_counters()
    with attention_recorder(calls):
        flash.flash_attention(q, k, v, causal=True, scale=0.125).sum().backward()
        with torch.no_grad():
            flash.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=False,
                                  scale=0.125)
    tally = profiling.counters()["attention"]
    assert tally == _recorded(calls)
    assert tally == {("flash", 2, 64, 1, 64, "float32", True, True): 1,
                     ("flash", 2, 64, 1, 64, "bfloat16", False, False): 1}


def test_collate_counts_equal_the_harness_frames():
    from benchmark import traffic
    from benchmark.program import configs
    from benchmark.tests.small import small_cell

    c = small_cell("hp-ladder", "float32")
    model_cfg, train_cfg = configs(c["config"], c["traffic"].get("training", {}))
    feed = traffic.make_feed(c["traffic"], 2 ** 33 + 7, model_cfg, train_cfg,
                             torch.device("cpu"))
    steps = traffic.iterate(feed)
    profiling.reset_counters()
    true = padded = 0
    for _ in range(feed.steps_per_epoch()):
        _, info = next(steps)
        true += info["true_frames"]
        padded += info["padded_frames"]
    got = profiling.counters()
    assert (got["batches"], got["frames_true"], got["frames_padded"]) == (
        feed.steps_per_epoch(), true, padded)
    assert 0 < true < padded
    profiling.reset_counters()
    assert profiling.counters() == {"batches": 0, "frames_true": 0, "frames_padded": 0,
                                    "attention": {}}


def test_counters_lose_no_count_to_two_threads():
    profiling.reset_counters()
    n = 20000

    def count():
        for _ in range(n):
            profiling.count_batch(3, 4)
            profiling.count_attention("packed", 2, 64, 2, 64, torch.float32, True, False)

    threads = [threading.Thread(target=count) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert profiling.counters() == {
        "batches": 2 * n, "frames_true": 6 * n, "frames_padded": 8 * n,
        "attention": {("packed", 2, 64, 2, 64, "float32", True, False): 2 * n}}
    profiling.reset_counters()


def test_interbatch_phases_are_the_span_names(caplog):
    ib = profiling.InterbatchProfiler(report_interval=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with caplog.at_level(logging.INFO, logger=profiling.__name__):
            for _ in range(2):
                for phase in (profiling.DATA, profiling.STEP):
                    ib.start(phase)
                    ib.end(phase)
    assert (profiling.DATA, profiling.STEP) == ("kokoro.data", "kokoro.train_step")
    assert sorted(ib.phases) == [profiling.DATA, profiling.STEP]
    assert [r.getMessage() for r in caplog.records] == [ib.report()]
    assert "kokoro.data: mean" in ib.report() and "kokoro.train_step: mean" in ib.report()
    assert not _spans(prof)
