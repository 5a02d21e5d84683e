"""Where the time goes on the card: ``torch.profiler`` over the port's paths.

    python -m kokoro_tpu_torch.cli.profile_paths

At full width on seeded random weights (hidden 512, 6+6 layers, 8 heads,
ff 1536, vocab 59) it profiles

* the teacher-forced forward, kernel path, on the batch ``chip_smoke.py``
  drives (``teacher_forced_batch``: B=16, T=512, L=128), f32 and bf16;
* the training step under the throughput preset
  (``config.get_high_performance_config``: bf16 compute on f32 parameters,
  attention-weight dropout in the packed kernels, SpecAugment, no remat) on
  ``training_batch`` (B=32, L=96, T=512), which ``chip_smoke.py`` trains on;
* the long-utterance training step (``LONG_REGIME``: the long configuration
  of ``scripts/quality_run.py --long`` through ``get_default_config``; bf16
  compute, no attention-weight dropout, so the decoder's self-attention runs
  K4, SpecAugment, no remat) on ``training_batch`` at B=12, L=256, T=1408;
* AR decode steps (``KokoroModel.decode_step``) at B=1 and B=4 over a
  400-frame cache;
* HiFi-GAN (committed universal-V1 weights) on 4 x 256 frames;

and prints one JSON line per path: wall ms per call (host clock around work
that ends in ``torch.cuda.synchronize()``, without and with the profiler),
device busy ms per call (sum of kernel self times in the profiled window),
the device's idle share in that window, kernels launched per call, the
device ms per call of the port's attention kernels, and the top kernels by
device time.  Needs CUDA.

    python -m kokoro_tpu_torch.cli.profile_paths --tools

profiles the paths of the benchmark tools instead: training steps of
``scripts/bench_step_shapes.py`` rows (``TOOL_STEP_SHAPES``) and
``scripts/bench_batched_decode.py``'s forced decode at ``TOOL_STREAMS``
streams over ``TOOL_FRAMES`` frames, the decode's numbers also per frame.

    python -m kokoro_tpu_torch.cli.profile_paths --bench

profiles the paths of the headline training benchmark
(``kokoro_tpu_torch/bench.py``): one compute-only call (K=16 steps of the
throughput preset at B=32, T=512) and one end-to-end epoch of the trainer
over the 480-utterance, nine-bucket corpus (built in a temporary directory,
the feature cache filled by a first epoch), their numbers also per step.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]


def teacher_forced_batch(cfg, B: int, T: int, L: int, device) -> dict:
    """A seeded teacher-forced batch: given durations 1-6 per phoneme, rows
    with 0, 8, 16 or 24 padded phonemes, mel frames past each row's total
    duration padded (``chip_smoke.py`` drives the same batch)."""
    g = torch.Generator(device="cpu").manual_seed(1)
    dur = torch.randint(1, 7, (B, L), generator=g)
    pad = torch.zeros(B, L, dtype=torch.bool)
    for b in range(B):
        pad[b, L - (b % 4) * 8:] = b % 4 > 0
    dur = torch.where(pad, 0, dur)
    mel_len = torch.clamp(dur.sum(1), max=T)
    batch = dict(
        phoneme_indices=torch.randint(1, cfg.vocab_size, (B, L), generator=g),
        mel_specs=torch.randn(B, T, cfg.n_mels, generator=g) * 2.0 - 5.0,
        phoneme_durations=dur,
        stress_indices=torch.randint(0, 3, (B, L), generator=g),
        text_padding_mask=pad,
        mel_padding_mask=torch.arange(T)[None, :] >= mel_len[:, None],
    )
    return {k: v.to(device) for k, v in batch.items()}


def training_batch(cfg, B: int, T: int, L: int, device) -> dict:
    """A seeded synthetic training batch of ``bench.py``'s compute-only
    phase: every phoneme lasts T // L frames, every mel frame is valid, stop
    targets zero."""
    g = torch.Generator(device="cpu").manual_seed(0)
    batch = dict(
        phoneme_indices=torch.randint(1, cfg.vocab_size, (B, L), generator=g),
        stress_indices=torch.randint(0, 3, (B, L), generator=g),
        phoneme_durations=torch.full((B, L), T // L, dtype=torch.int32),
        mel_specs=torch.randn(B, T, cfg.n_mels, generator=g),
        pitch_targets=torch.rand(B, T, generator=g),
        energy_targets=torch.rand(B, T, generator=g),
        stop_token_targets=torch.zeros(B, T),
        mel_lengths=torch.full((B,), T, dtype=torch.int32),
        phoneme_lengths=torch.full((B,), L, dtype=torch.int32),
    )
    return {k: v.to(device) for k, v in batch.items()}


# the long configuration of scripts/quality_run.py (make_cfg with --long),
# the overrides it gives the reference's get_default_config
LONG_REGIME = dict(
    use_speed_perturbation=False, validation_split=0.1, log_every_steps=10,
    max_seq_length=1408, mel_bucket_sizes=(1408,), phoneme_bucket_sizes=(256,),
    max_frames_per_batch=18000, max_batch_size=12, batch_size_multiple=12,
    use_flash_attention=True, attention_weight_dropout=False, gradient_checkpointing=False,
)
LONG_SHAPE = dict(B=12, L=256, T=1408)
# (B, L, T) rows of bench_step_shapes: both short rows and a long one of each T
TOOL_STEP_SHAPES = ((16, 64, 288), (48, 64, 288), (16, 128, 896), (32, 192, 1280))
TOOL_STREAMS, TOOL_FRAMES = (1, 8, 64), 128


def long_train_step(device, seed: int = 0, mesh=None, **overrides):
    """(state, step, batch) of the long regime at full width on seeded random
    weights, B=12, L=256, T=1408 (one batch per step, no microbatch axis);
    with ``mesh`` the state is this rank's shards (``parallel/``)."""
    from kokoro_tpu_torch.config import get_default_config
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step

    model_cfg, train_cfg = get_default_config(**{**LONG_REGIME, **overrides})
    model = KokoroModel(model_cfg).init_weights(torch.Generator().manual_seed(seed))
    state = create_train_state(model.to(device), train_cfg, total_steps=20000, mesh=mesh)
    step = make_train_step(train_cfg, build_preclip_norms(state.names, train_cfg),
                           spec_augment=train_cfg.use_spec_augment)
    B, L, T = LONG_SHAPE["B"], LONG_SHAPE["L"], LONG_SHAPE["T"]
    return state, step, training_batch(model_cfg, B, T, L, device)


def preset_train_step(device, seed: int = 0, mesh=None):
    """(state, step, batch) of the throughput preset at full width on seeded
    random weights, B=32, L=96, T=512; with ``mesh`` the state is this
    rank's shards (``parallel/``)."""
    from kokoro_tpu_torch.config import get_high_performance_config
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step

    model_cfg, train_cfg = get_high_performance_config()
    model = KokoroModel(model_cfg).init_weights(torch.Generator().manual_seed(seed))
    state = create_train_state(model.to(device), train_cfg, total_steps=20000, mesh=mesh)
    step = make_train_step(train_cfg, build_preclip_norms(state.names, train_cfg))
    return state, step, training_batch(model_cfg, train_cfg.batch_size, 512, 96, device)


def step_shape_step(device, B: int, L: int, T: int):
    """(state, step, batch) of one ``bench_step_shapes`` row: the throughput
    preset at its vocabulary on seeded random weights, its synthetic batch."""
    from kokoro_tpu_torch.config import get_high_performance_config
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.scripts.bench_step_shapes import VOCAB, synthetic_batch
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step

    model_cfg, train_cfg = get_high_performance_config(vocab_size=VOCAB)
    model = KokoroModel(model_cfg).init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model.to(device), train_cfg, total_steps=20000)
    step = make_train_step(train_cfg, build_preclip_norms(state.names, train_cfg),
                           spec_augment=train_cfg.use_spec_augment)
    return state, step, synthetic_batch(B, L, T, model_cfg.n_mels, VOCAB, device)


def _profile(name: str, fn, calls: int, units: int = 1, unit: str = "call", **meta) -> None:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # kernels only: an operator's entry repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / calls
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    kernels = sum(e.count for e in events) / calls
    per_unit = {} if units == 1 else {
        f"wall_ms_unprofiled_per_{unit}": plain_wall_ms / units,
        f"device_busy_ms_per_{unit}": busy_ms / units if events else "not measured",
        f"kernels_per_{unit}": kernels / units}
    print(json.dumps({
        "path": name, **meta, "calls": calls, "wall_ms_unprofiled": plain_wall_ms,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if events else "not measured",
        "device_idle_share": (1.0 - busy_ms / wall_ms) if events else "not measured",
        "kernels_per_call": kernels, **per_unit,
        # the port's attention kernels (csrc/attention_kernels.cuh, attention_tc.cuh)
        "attention_ms": sum(e.self_device_time_total for e in events
                            if "kokoro_attn" in e.key) / 1e3 / calls,
        "top_kernels": [{"name": e.key[:90], "ms_per_call": e.self_device_time_total / 1e3 / calls,
                         "count_per_call": e.count / calls} for e in top],
    }), flush=True)


def profile_tools(dev) -> None:
    """The benchmark tools' paths (see the module docstring)."""
    from kokoro_tpu_torch.models.generator import generate
    from kokoro_tpu_torch.scripts import bench_batched_decode as decode

    gen = torch.Generator().manual_seed(0)
    for B, L, T in TOOL_STEP_SHAPES:
        state, step, batch = step_shape_step(dev, B, L, T)
        _profile("bench_step_shapes", lambda: step(state, batch, gen), 5,
                 dtype="bf16 compute, f32 params", preset="get_high_performance_config",
                 B=B, L=L, T=T)
        del state, step, batch
        torch.cuda.empty_cache()
    model = decode.build_model(dev)
    forced = dict(stop_threshold=1.1, min_len_ratio=0.0, min_len_floor=TOOL_FRAMES - 1,
                  max_len_cap=TOOL_FRAMES)
    rng = torch.Generator().manual_seed(0)
    for B in TOOL_STREAMS:
        ph = torch.randint(1, decode.VOCAB, (B, decode.L), generator=rng).to(dev)
        st = torch.randint(0, 3, (B, decode.L), generator=rng).to(dev)
        pad = torch.zeros(B, decode.L, dtype=torch.bool, device=dev)
        _profile("bench_batched_decode", lambda: generate(model, ph, st, pad, TOOL_FRAMES,
                                                          **forced),
                 2, units=TOOL_FRAMES, unit="frame", dtype="bf16 compute, f32 params",
                 streams=B, frames=TOOL_FRAMES, L=decode.L)


def profile_bench(dev) -> None:
    """The headline training benchmark's paths (see the module docstring)."""
    import tempfile

    from kokoro_tpu_torch import bench

    state, step, batch = bench.compute_only_step(dev)
    gen = torch.Generator().manual_seed(0)

    def call():
        for _ in range(bench.K):
            step(state, batch, gen)

    _profile("bench_compute_only", call, 1, units=bench.K, unit="step",
             dtype="bf16 compute, f32 params", preset="get_high_performance_config",
             B=bench.B, L=bench.L, T=bench.T, K=bench.K)
    del state, step, batch
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = bench.e2e_trainer(Path(tmp), dev)
        trainer.train_epoch(0)  # fills the feature cache
        epoch = [0]

        def one_epoch():
            epoch[0] += 1
            trainer.train_epoch(epoch[0])

        # _profile runs the epoch once to warm up, once unprofiled, once profiled
        steps = len(trainer.batcher.build_batches(3))
        _profile("bench_end_to_end_epoch", one_epoch, 1, units=steps, unit="step",
                 dtype="bf16 compute, f32 params", preset="get_high_performance_config",
                 corpus="bench._build_bench_corpus (480 utterances, 9 mel buckets)",
                 steps_per_epoch=steps)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Profile the port's paths on the card.")
    parser.add_argument("--tools", action="store_true",
                        help="profile bench_step_shapes rows and bench_batched_decode")
    parser.add_argument("--bench", action="store_true",
                        help="profile the training benchmark's compute-only call and epoch")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_paths: CUDA is not available", file=sys.stderr)
        return 2
    if args.tools:
        profile_tools(torch.device("cuda"))
        return 0
    if args.bench:
        profile_bench(torch.device("cuda"))
        return 0
    from kokoro_tpu_torch.config import KokoroConfig
    from kokoro_tpu_torch.inference.vocoder import VocoderManager
    from kokoro_tpu_torch.models.kokoro import KokoroModel

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    cfg = KokoroConfig(use_flash_attention=True)
    model = KokoroModel(cfg).init_weights(g).to(dev).eval()
    B, T, L = 16, 512, 128
    batch = teacher_forced_batch(cfg, B, T, L, dev)
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            model.to(dtype)
            inputs = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in batch.items()}
            _profile("teacher_forced_forward", lambda: model(**inputs), 3,
                     dtype=str(dtype), B=B, T=T, L=L)
        model.to(torch.float32)
        S = 400
        for Bd in (1, 4):
            mem = torch.randn(Bd, S, 512, generator=g).to(dev)
            cross = model.project_memory_kv(mem)
            mask = torch.zeros(Bd, S, dtype=torch.bool, device=dev)
            caches = [{"k": torch.zeros(Bd, 8, S, 64, device=dev),
                       "v": torch.zeros(Bd, 8, S, 64, device=dev), "index": 0}
                      for _ in range(6)]
            frame = torch.zeros(Bd, 1, 80, device=dev)
            state = {"t": 0}

            def step():
                for c in caches:
                    c["index"] = state["t"] % 200
                model.decode_step(frame, state["t"], caches, cross, mask)
                state["t"] += 1

            _profile("ar_decode_step", step, 50, dtype="torch.float32", B=Bd, cache=S)
        voc = VocoderManager(vocoder_path=str(ROOT / "docs" / "hifigan_v1_int8.npz"), device=dev)
        mels = (torch.rand(4, 256, 80, generator=g) * 9 - 9).numpy()
        _profile("hifigan", lambda: voc.mel_to_audio_batch(mels), 3, B=4, frames=256)
    del model, voc
    torch.cuda.empty_cache()
    state, step, batch = preset_train_step(dev)
    gen = torch.Generator().manual_seed(0)
    B, T = batch["mel_specs"].shape[:2]
    _profile("train_step", lambda: step(state, batch, gen), 5, dtype="bf16 compute, f32 params",
             preset="get_high_performance_config", B=B, T=T, L=batch["phoneme_indices"].shape[1])
    del state, step, batch
    torch.cuda.empty_cache()
    state, step, batch = long_train_step(dev)
    _profile("long_train_step", lambda: step(state, batch, gen), 5,
             dtype="bf16 compute, f32 params", preset="LONG_REGIME", **LONG_SHAPE)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
