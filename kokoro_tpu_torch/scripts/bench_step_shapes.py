"""Sweep the training step's shapes on the card: batch rows B x sequence
length T under the throughput preset.

Port of ``scripts/bench_step_shapes.py``.  The model and step of
``get_high_performance_config`` (bf16 compute on f32 parameters, no remat,
the decoder's attention through the kernels with attention-weight dropout,
SpecAugment) at vocabulary 128 on seeded random weights, one fresh training
state per row from the same initial weights, on the reference's synthetic
batch (numpy seed 0: phonemes, stress, every phoneme T // L frames, normal
mels, uniform pitch and energy, no stop targets).  Each row takes K = 4
consecutive steps a call (the reference's ``lax.scan`` of K steps; the port
takes one step per ``train_step`` call, each ending in its one host read),
2 warm calls, then the best of 4 timed calls, each ended by a value fetch.
``step_ms`` is that best over K, ``padded_frames_per_sec`` B * T * K over it,
and ``compile_s`` the state's creation and the two warm calls (the
reference's compiles; here the kernel build, the allocator and first
calls).  Beside them each row records the steps it took in all, the
attention kernels launched per step and the peak allocated bytes.  A row that fails records its error as
the reference does.  ``CONFIGS`` (B 16-64 x T 896, 1280) by default,
``CONFIGS_SHORT`` with ``--short``.  Prints the reference's JSON list;
``--out`` writes it with the card's name and power limit.

    python -m kokoro_tpu_torch.scripts.bench_step_shapes [--short] [--out FILE] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

CONFIGS = [
    # (B, L, T)
    (16, 128, 896),
    (32, 128, 896),
    (64, 128, 896),
    (16, 192, 1280),
    (32, 192, 1280),
    (64, 192, 1280),
]

# the short buckets at B=16 and more rows: is the short-T padded rate B-bound?
CONFIGS_SHORT = [
    (16, 64, 288),
    (48, 64, 288),
    (16, 96, 512),
    (32, 96, 512),
]
VOCAB = 128
K = 4


def synthetic_batch(B: int, L: int, T: int, n_mels: int, vocab: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The reference's batch of one row of the sweep, from numpy seed 0."""
    rng = np.random.default_rng(0)
    batch = {
        "phoneme_indices": rng.integers(1, vocab, size=(B, L)),
        "stress_indices": rng.integers(0, 3, size=(B, L)),
        "phoneme_durations": np.full((B, L), T // L, np.int32),
        "mel_specs": rng.normal(size=(B, T, n_mels)).astype(np.float32),
        "pitch_targets": rng.uniform(size=(B, T)).astype(np.float32),
        "energy_targets": rng.uniform(size=(B, T)).astype(np.float32),
        "stop_token_targets": np.zeros((B, T), np.float32),
        "mel_lengths": np.full((B,), T, np.int32),
        "phoneme_lengths": np.full((B,), L, np.int32),
    }
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def sweep(device: torch.device, configs: Sequence[Tuple[int, int, int]] = CONFIGS,
          warm_calls: int = 2, timed_calls: int = 4, **overrides) -> List[Dict]:
    """One row per (B, L, T) (see the module docstring); ``overrides`` go to
    ``get_high_performance_config`` (the tests shrink the widths)."""
    from kokoro_tpu_torch.config import get_high_performance_config
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.scripts.quality_run import kernel_launches
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step

    model_cfg, config = get_high_performance_config(**{"vocab_size": VOCAB, **overrides})
    init = KokoroModel(model_cfg).init_weights(torch.Generator().manual_seed(0)).state_dict()
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    results: List[Dict] = []
    for B, L, T in configs:
        batch = synthetic_batch(B, L, T, model_cfg.n_mels, model_cfg.vocab_size, device)
        state = step = None
        try:
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            model = KokoroModel(model_cfg)
            model.load_state_dict(init)
            state = create_train_state(model.to(device), config, total_steps=20000)
            step = make_train_step(config, build_preclip_norms(state.names, config),
                                   spec_augment=config.use_spec_augment)
            gen = torch.Generator().manual_seed(0)

            def call():
                metrics = [step(state, batch, gen) for _ in range(K)]
                sync()
                return metrics[-1]["total"]  # a host float: the value fetch

            for _ in range(warm_calls):
                call()
            t_compile = time.perf_counter() - t0
            times = []
            for _ in range(timed_calls):
                before = kernel_launches()
                t0 = time.perf_counter()
                total = call()
                times.append(time.perf_counter() - t0)
            launched = {name: (count - before[name]) // K
                        for name, count in kernel_launches().items() if count > before[name]}
            if not np.isfinite(total):
                raise RuntimeError(f"non-finite loss {total}")
            best = min(times)
            fps = B * T * K / best
            results.append({
                "B": B, "T": T, "L": L,
                "step_ms": round(best / K * 1e3, 1),
                "padded_frames_per_sec": round(fps, 0),
                "compile_s": round(t_compile, 1),
                "steps_taken": (warm_calls + timed_calls) * K,
                "launches_per_step": launched,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
            })
            log(f"B={B:3d} T={T:5d}: {best / K * 1e3:7.1f} ms/step  "
                f"{fps / 1e3:8.1f}k frames/s  (compile {t_compile:.0f}s)")
        except Exception as err:  # noqa: BLE001 - a row records its failure
            results.append({"B": B, "T": T, "L": L, "error": str(err)[:200]})
            log(f"B={B:3d} T={T:5d}: FAILED {err}")
        finally:
            del state, step, batch
            if cuda:
                torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.scripts.quality_run import payload_device

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--short", action="store_true", help="sweep CONFIGS_SHORT")
    p.add_argument("--out", default=None, help="also write the rows with the card's name")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    configs = CONFIGS_SHORT if args.short else CONFIGS
    results = sweep(device, configs)
    print(json.dumps(results, ensure_ascii=False))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "device": payload_device(device),
            "model": f"get_high_performance_config (bf16 compute, f32 params, kernels with "
                     f"attention dropout, SpecAugment, no remat), vocab {VOCAB}, seeded "
                     f"random weights",
            "steps_per_call": K, "rows": results}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
