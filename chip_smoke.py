#!/usr/bin/env python3
"""Drive the PyTorch port (kokoro_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                          # every phase, the contract lines
    python3 chip_smoke.py --phases kernels_flash,long   # some phases; its last line is
                                                        # {"partial_run": [...], ...}, no "ok"

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``kokoro_tpu_torch/csrc/``, one ``nvcc`` per source,
   all started together; ptxas's registers and spills per kernel and the
   kernels whose ``wgmma`` it serialises, and a failure if a tensor-core
   kernel (the bf16 ``csrc/attention_tc.cuh``, the f32 forward's and
   backward's 3xTF32 ``csrc/attention_tf32.cuh``, whose registers it prints
   by kernel) spills or has its ``wgmma`` serialised; the registers of the 12
   K4 kernels at Dh 192 and 256 (bf16 and f32 forward, dQ and dK/dV; the f32
   ones ``csrc/attention_tf32_wide.cuh``'s), and a
   failure unless all 12 were built; the registers of the 12 K4 kernels
   past Dh 2048 (``csrc/attention_scores.cuh``: each dtype's scores, row
   pass, the two products, the backward's scores and row deltas), and a
   failure unless all 12 were built or one spills; the registers of the 6 K4 cluster
   kernels past Dh 256 (the same six, each CTA of a cluster of
   ceil(Dh / 128) on 128 columns) and the cluster size of each head dim,
   and a failure unless all 6 were built; how many clusters of 3 to 16 CTAs
   of each of the six the card holds at once at its shared memory
   (``cluster_occupancy``, ``cudaOccupancyMaxActiveClusters``; past 8 a
   non-portable size), and a failure where it holds none; and the
   host-side C++ duration aligner (``csrc/aligner.cpp``, ``g++``).
2. kernels: the packed forward kernels (K1 causal, K2 kv-length) against their
   plain PyTorch version (TF32 off), f32 at 2e-5 and bf16 at 2e-2 abs/rel, the
   reference's own forward tolerances; each f32 forward (K1 and K2 at rates 0
   and 0.1, K3, K4 with and without segment ids; Dh 64 and 128, ragged T)
   called twice, and once more with ``torch.backends.cuda.matmul.allow_tf32``
   on: O and lse bit for bit equal, or the phase fails; then kernel_times at
   the decoder's shape B=32, T=512, H=8, Dh=64: each kernel (forward and
   backward, rates 0 and 0.1), its plain version, one PyTorch library call
   (SDPA forward; for a backward, SDPA forward+backward through autograd
   minus its forward; timed as a yardstick only, the port never calls it),
   the bound, the achieved
   TFLOP/s and the share of the bound; a forward row also at rate 0.1 without
   and under grad (what the training step runs) beside SDPA's forward at
   ``dropout_p=0.1`` (its own mask: a yardstick only).  Kernels and library calls are timed
   on the device (20 calls in a CUDA graph, the median of 5 replays), the
   plain versions by CUDA events around the calls.
3. kernels_bwd: the packed forward with in-kernel dropout and the backward
   kernels (rates 0 and 0.1) against the plain versions with the same seed,
   B=4 over the bucket ladder and T=1433, Dh 64 and 128, a kv-length row of
   length 0 included; gradients at f32 1e-4 / bf16 3e-2; each backward twice,
   bit for bit equal; then rows of kv length 1 at rate 0.2 (B=4, T=384).
4. dropout: the packed kernels' dropout semantics, as
   ``scripts/verify_attention_numerics.py`` measures the TPU's.
5. kernels_flash: K4 (``ops/flash_attention.py``) forward and backward
   against their plain versions, Dh 64/128/192/256 x T 1024/1408/1433/1920,
   Dh 320/384/448/512/1024 (the cluster kernels) x T 1024/1433 and Dh
   640/768/896 (clusters of 5, 6 and 7 CTAs) and, at H=2, 1088/1152/1280/
   1408/1536/1664/1792/1920/2048 (clusters of 9 to 16) x T 1433 and past
   2048 (the scores in device memory) 2112/2176/2304/2560/3072/4096 x T 1433
   (2176 and 2560 also T 1024) and, at H=1, 8192
   x causal and not x segment ids none/suffix/interior, f32 and bf16, each
   case called twice (f32 a third time with ``allow_tf32`` on) and bit for
   bit equal, with each head dim's worst share of the allclose bound; then
   its times at the long path's shape B=12, T=1408 at H=8 Dh=64, H=2 Dh=256
   and H=1 Dh=512 (the flagship's hidden 512 over 2 heads and at one), H=4
   Dh=192 and H=2 Dh=384 (hidden 768), H=1 Dh=1024 (the largest portable
   cluster, 8 CTAs), H=1 Dh=1152, 1536 and 2048 (clusters of 9, 12 and 16),
   H=1 Dh=2560 and 4096 (the scores in device memory; 3 device kernels a
   forward, 5 a backward), each with its bound, plain version
   and SDPA in both dtypes (past Dh 256 SDPA's first fused backend that takes
   the call, pinned, and named; past 1024 its memory-efficient backend
   pinned, or the words of its refusal), each kernel's device ms of a call
   (``kernel_split_ms``; the f32 rows at Dh 192 and 256 also on a line of
   their own, the backward's dQ against its dK/dV kernel).  Then
   (``kernels_flash_scores``) the scores path's launch grid against
   ``ops/flash_scores.py``'s, rows that see one key or none at Dh 2112 and
   2560, and the scores path called directly at Dh 1536 and 2048 against
   the plain versions, and (``kernel_times_flash_scores``) its times there at
   B=12 T=1408 H=1 beside the cluster kernels'.  Then the long path's other
   attention kernels, K2 forward and the packed kv-length backward, at its
   cross-attention shape B=12, T=1408, H=8, Dh=64 against their plain
   versions (f32 and bf16, rates 0 and 0.1, kv lengths 1408 as the long batch
   gives them and a mixed set with a row of length 0), and their times there;
   then what a work item of the bf16 forward costs beside its key tiles
   (``forward_item_cost``: K2 at T 128-1408, a line through ms per item).
6. kernels_folded: K3 (the packed kernels on the folded (B*H, T, Dh) view)
   against the plain version, T 128/432/512/848, Dh 64/128, rates 0 and 0.1,
   and bit for bit equal to the packed kernels at rate 0.1; its times at
   B=32, T=512; the launches of one ``fused_attention`` forward and backward.
7. forward: the teacher-forced forward at full width (hidden 512, 6+6
   layers, 8 heads, ff 1536, vocab 59; B=16, T=512, L=128), kernel path
   against plain path, f32 and bf16; each packed forward kernel launched once
   per decoder layer, every other wrapper never.
8. serve: a full-width model directory with seeded random weights and the
   committed HiFi-GAN (docs/hifigan_v1_int8.npz), ``TTSServer`` on
   127.0.0.1, five concurrent Russian texts; every answer a WAV of (the frames
   the pipeline reports) x 256 samples, fewer dispatches than requests; then
   ``POST /profile {"seconds": 1}`` with a request under it: HTTP 200 and a
   ``torch.profiler`` trace file.
9. train: the training step at full width, B=32, L=96, T=512.  (a) kernel path
   against plain path in f32, 3 steps from one init, per-step loss and
   gradient norm, each tensor's gradient at the init and what the steps moved
   the parameters, with a control whose planted dK fault must break a limit;
   (b) the throughput preset: 2 warm-up and 10 timed steps, each packed
   wrapper launched once per decoder layer per step.
10. long: the long-utterance regime of ``scripts/quality_run.py --long`` at
   full width.  (a) ``KokoroTrainer`` on a synthetic 26-utterance corpus of
   16.3 s (every utterance in the 1408-frame bucket), one epoch, then a second
   resumed from ``auto``: every step finite and taken with the stabilization's
   loss scale < 1, K4 and K2 forward and backward launched once per decoder
   layer per microbatch, K1 and K3 never; validation launches K4 and K2
   forward only; the run directory synthesises through ``KokoroTTS``.  (b)
   kernel path against plain path of the long step in f32 (B=4, L=256,
   T=1408) with the limits of (9a), the planted fault on K4's dK.  (c) the
   bf16 long step at B=12, L=256, T=1408: 2 warm-up and 10 timed steps.  (d)
   the same model at ``n_heads=2`` (head dim 256, ``long_head_dim``): (b)
   in f32, a bf16 step kernel path against plain path within
   ``BF16_STEP_LIMIT`` beside the same at 8 heads, and 5 timed bf16 steps;
   K4 forward and backward once per decoder layer a step and no other
   wrapper (the cross-attention at Dh 256 stays on einsum, as in the
   reference).  (e) The same at ``n_heads=1`` (head dim 512, K4's cluster
   kernels), without the 8-head step, 3 timed bf16 steps.  (f) The same
   with the model widened to hidden 1536 at one head (head dim 1536, K4
   over clusters of 12 CTAs), B=12, with the step's peak memory.  (g) The
   same at hidden 2560, one head (head dim 2560, K4 with the scores in
   device memory, ``csrc/attention_scores.cuh``), B=12, 3 timed steps.
11. mfa: the MFA-supervised data path and kokoro-infer.  The long corpus of
   (10), each text ending in a word with a geminate, gets one TextGrid per
   utterance (``write_alignments``); ``cli.preprocess --validate-only``
   reports 100 % coverage; the native C++ aligner equals the Python DP on
   every utterance (and is timed against it); ``precompute_features`` fills
   the feature cache on the card (26 computed); one epoch of the long regime
   through ``KokoroTrainer`` with ``use_mfa``, every item a batch takes
   holding its aligned durations (not the fallback, summing to its frames),
   launches as in (10a); a stale ``metrics.jsonl`` record past the
   checkpoint, as a crash after the save leaves it, gone after the resume
   for a second epoch, whose first step follows the restored one; then
   ``cli.infer`` on the run directory: ``--file --batched`` writes one WAV
   per line, ``--weights ema`` and ``model`` differ, a weight-normed ``.pth``
   made from ``docs/hifigan_v1_int8.npz`` gives the ``.npz``'s audio within
   1e-4, and ``--profile`` on a short run (``--max-len 16``) writes a trace
   with device events.
12. tools: the trainer's tooling on the card.  (a) One epoch of the long
   regime on the corpus of (10) with every diagnostic on
   (``histogram_every_steps=1``, a profiler window over 2 steps, the
   interbatch profiler, ``verbose``): the log holds every scalar family of
   the reference's ``tests/unit/test_observability_tags.py``, ``weights/*``
   (the flax paths of the model's parameters), ``gradients/*`` and
   ``val_predictions/*`` histograms and the four ``spectrogram/*`` images;
   the trace in ``profiler_logs/`` names K4 and the packed kernels among its
   device events; the steps launch K4 and K2 as in (10a); the memory
   preflight, the duration diagnostics and the interbatch report are logged.
   (b) HiFi-GAN V1 on 4 x 256 frames with cuDNN TF32 on (torch's default,
   what ``cli.serve`` and ``cli.infer`` run) and off.  (c) The bf16/f32 A/B
   (``utils/profiling.profile_dtype_for_config``) on the throughput preset,
   whose fixed model fields put the attention on the plain route, and the
   same A/B on the preset's kernel route beside it.
   (d) ``cli.plan`` (table and ``--json``) and ``utils.cache_manager
   --status`` on the corpus's ``.feature_cache_torch``.  (e) The memory
   sweep of ``utils/memory_planner.py`` (``bench.py``'s bucket ladder and
   the long step), one line per shape, and the planner's estimate held
   within 15 % of every measured allocated peak and of the peaks phases
   ``train`` and ``long`` measured.
13. quality: ``python -m kokoro_tpu_torch.scripts.quality_run
   --flash-attention --epochs 4 --utts 96`` at full width: the default
   regime (bucket 384, batches of up to 12, 2 microbatches a step, remat,
   attention dropout drawn in the kernel) on 96 synthetic utterances, the
   resume break after epoch 2, a checkpoint every 2 epochs.  Every step
   taken and finite, K1 and K2 forward launched twice per decoder layer per
   microbatch (remat recomputes the forward) and their backward once, K3
   and K4 never, validation the forwards only; the resume continues from
   the saved step, whose next step is the first of phase 2; the last
   epoch's train and val mel below the first's.  Then
   ``analyze_training_regression`` over the run directory (every
   checkpoint with finite norms, 0 non-finite values, nonzero deltas, the
   finite-weights check not failed) and ``e2e_audio_artifact`` on it (one
   Russian text through the committed HiFi-GAN, not Griffin-Lim: a WAV of
   frames x 256 samples, finite health metrics).  Last, K1, K2 and both
   packed backwards against their plain versions at every (B, T=384, H=8)
   the run called them at, in both dtypes, at rate 0 and the run's rates,
   K2 at the kv lengths the run gave it and at a mixed set with rows of
   length 1 and 0 (``hold_recorded``: each check's worst ratio to the
   allclose bound, and the f32 kv-length backward, kernel and plain version
   each against a float64 recompute, as phases scripts and bench too).
14. vocoder_train: ``python -m kokoro_tpu_torch.scripts.train_hifigan`` at
   full width (HiFi-GAN V1, 512 channels, 13.93 M parameters, batches of 8
   crops of 16384 samples, cuDNN TF32 on for the run) for 300 steps on the
   48-utterance quality corpus: every logged loss finite, the last logged
   mel L1 at most two thirds of the first; the export loads through
   ``VocoderManager`` and vocodes an utterance's T-frame mel to T x 256
   finite samples; ``quantize_hifigan`` on it: int8 round-trip mel L1 within
   0.01 of f32, weights within 0.005 relative.  ms a step and peak memory
   are printed; no attention kernel launches.
15. scripts: the other ported tools at reduced size: ``bench_serving`` (4
   clients, 12 requests, Griffin-Lim) on phase quality's run directory,
   ``bench_batched_decode`` (streams 1 and 8, 128 frames, bf16),
   ``bench_step_shapes`` (the first two ``CONFIGS_SHORT`` rows: each packed
   wrapper 6 launches a step), ``examples_validation``, the host tools
   (phoneme coverage, split lengths, warm-up table, drop-path card) on the
   quality corpus and ``verify_setup``, which must print PASS.  Any error
   row or non-zero exit fails the phase.  Then K1, K2 and the packed
   backwards against their plain versions at the step-shape rows' shapes
   (B=16 and 48, T=288, H=8), as phase quality holds them at its own.
16. bench: the repository's two headline benchmarks on the port, through
   their functions at the flagship widths.  ``kokoro_tpu_torch.bench``'s
   compute-only phase as the reference runs it (B=32, L=96, T=512, K=16
   steps a call, 2 warm and 4 timed calls; each packed wrapper 6 launches a
   step) and its end-to-end phase on the full 480-utterance, nine-bucket
   corpus (``BENCH_E2E_EPOCHS`` measured epochs after the warm one; every
   step taken and finite with 6 launches of each packed wrapper,
   ``end_to_end`` > 0); then K1, K2 and both packed backwards against their
   plain versions at every (B, T, H) those epochs called them at (T up to
   896, at least one T not a multiple of 128), as phase quality holds them
   at its own; then ``kokoro_tpu_torch.bench_inference`` at
   ``BENCH_INFERENCE_FRAMES`` frames, streams 1, 8 and 32: every decode at
   the forced length, HiFi-GAN from the committed npz, finite positive
   rates.
17. parallel: data and tensor parallelism (``kokoro_tpu_torch/parallel/``)
   on the one card.  (a) K1, K2 and the packed backward at B=32, T=512 with
   H = 4 and 2 (the heads a rank holds at tp = 2 and 4; Dh 64); K2 and the
   kv-length backward at the (2, 2) trainer's rows, B=6, T=1408, H=4, kv
   lengths 1408 and a mixed set with a row of length 0; K4 forward and
   backward at B=12 and 6, T=1408, H=4; both dtypes, rates 0 and 0.1 for
   the packed kernels, against the plain versions within ``TOL`` /
   ``GRAD_TOL``, and the dropout semantics at H = 4 and 2.  (b) World size 1 on NCCL (the
   path of a multi-card run): the preset step through the parallel layer on
   a (1, 1) ('data', 'model') mesh equal bit for bit to the unwrapped step
   over 3 steps; ``kokoro-train --distributed`` under ``torch.distributed.run
   --nproc-per-node 1`` for one epoch on the long corpus of (10).  (c) 2 and
   4 ranks on the card over gloo (every rank on cuda:0; NCCL takes one rank
   per card): 3 f32 steps at full width, B=8 (rows of 512 to 256 valid
   frames), L=96, T=512, at (2,) data, (1, 2) data, model and (2, 2),
   against the single process at the reference's limits (loss rtol 1e-5,
   parameters rtol 2e-4 / atol 2e-5) and limits on the gradient at the init
   per tensor, on each step's gradient norm and on what the steps moved each
   tensor (``PARALLEL_LIMIT``), each run at its rate of ``HELD_LR``: the
   reference's learning rate, or a tenth of it (``PARALLEL_LR``) for a run
   that misses the limits at the reference's, whose reading there is
   printed beside it; a control without
   the model-group sum of the q/k/v norm scales' gradients must break a
   limit; K1 and K2 launched once per decoder layer a step at H = 4.  (d) ``KokoroTrainer``
   at (2, 2) in bf16, one epoch of the long regime on (10)'s corpus, 4
   ranks: every step finite, on rank 0 K4 and K2 forward and backward once
   per decoder layer a microbatch at H = 4, rank 0 alone writing the
   checkpoint, which one process resumes for one more step.  Per-rank step
   ms and all_reduce calls and bytes a step are printed; ranks sharing one
   card over gloo are not a scaling measurement.
18. parallel_sp_pp: sequence and pipeline parallelism (the ``seq`` axis of
   ``parallel/mesh.py``, ``parallel/pp.py``, ``parallel/pp_step.py``) on the
   one card, every rank on cuda:0 over gloo, the plain attention route (the
   reference's trainer turns its kernels off under both axes).  (a) 3 f32
   steps at full width, B=8 (rows of 512 to 256 valid frames), L=96, T=512,
   at (1, 2) and (2, 2) ('data', 'seq'), (1, 2, 2) ('data', 'seq', 'model'),
   and (1, 2) and (2, 2) ('data', 'stage') with the rows in 2 microbatches
   (3 decoder layers a stage), against the single process on the same route
   (the whole batch, or the same 2 microbatches through the accumulation
   step) with phase parallel's limits and its gradient at the init
   (``PARALLEL_LIMIT``, each run at its rate of ``HELD_LR``); no kernel
   launched.  Beside them the controls of the same single process at
   ``REFERENCE_LR`` in 2 microbatches: itself run again (bitwise equal or
   not) and itself with every parameter moved one ulp, under the same
   limits.  (b)
   ``KokoroTrainer`` in bf16 on the long corpus of (10), one epoch at (2, 2)
   ('data', 'seq'), 704 frames a rank, then one at (2, 2) ('data',
   'stage'): the reference's "use_flash_attention disabled" line, every step
   finite and taken with 0 attention-kernel launches, validation too.  (c)
   ``kokoro-train --distributed --dist-backend gloo --device cuda:0
   --mesh-shape 1,2 --mesh-axes data,seq`` under ``torch.distributed.run``
   (2 processes), one epoch on the long corpus.  Per-rank step ms, the
   all_reduce and broadcast calls and bytes a step (``Mesh.stats``) and
   each rank's peak allocated bytes are printed.

Then the script's wall time and each phase's, the kernels' JSON line (eight wrappers, each
with the launches of its main-path run: a preset step, a long step or a
kernels_folded call, its device kernels a call (a backward wrapper
launches two), and its bf16 time, TFLOP/s and share of the bound, a
forward's also under grad (``ms_for_backward``: lse and residual written); K2
and its backward also carry ``long_shape``, their times at T=1408 and
launches per long step; the kernels of phases mfa and tools carry
``mfa_path``, ``tools_path`` and ``quality_path``, their launches per
training step there (``quality_path`` also the worst error per dtype at
the quality run's shapes), every kernel ``vocoder_train_path`` (its
launches over phase vocoder_train's run, 0) and ``scripts_path`` (its
launches per ``bench_step_shapes`` step and, for the packed kernels, the
worst error per dtype at those steps' shapes), every kernel ``bench_path``
(its launches per compute-only and per end-to-end step of phase bench and,
for the packed kernels, the worst error per dtype at the end-to-end shapes),
those of phase parallel ``parallel_path``, their launches per step on a
rank of the (2, 2) mesh and the head count, and every kernel ``sp_pp_path``,
its launches per trainer step on the ``seq`` and ``stage`` paths, 0,
and K4's ``head_dims_192_256``, its times at Dh 256 and 192 in both dtypes
(with the backend SDPA picks there, and the backward's dQ and dK/dV
kernels apart, as phase kernels_flash's lines ``kernel_split_bf16_dh192_256``
and ``kernel_split_f32_dh192_256`` print them) and its launches per long
step at ``n_heads=2``, and ``head_dims_320_1024``,
its cluster kernels' times at Dh 384, 512 and 1024 in both dtypes (with SDPA's
backend there) and its launches per long step at ``n_heads=1``, and
``head_dims_1088_2048``, its times at Dh 1152, 1536 and 2048 (SDPA's
memory-efficient time or its refusal) and its launches per long step at
hidden 1536 and one head, and ``head_dims_2112_up``, its times at Dh 2560
and 4096 and its launches per long step at hidden 2560 and one head), the
``nvidia-smi`` line
and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises; nothing falls
back to the CPU or to a plain version.  Exits non-zero without CUDA or
without the repository around it.
"""

from __future__ import annotations

import contextlib
import http.client
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import wave
from concurrent.futures import ThreadPoolExecutor
from io import BytesIO
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
# dense bf16 tensor-core rate; f32-accurate work on the TF32 tensor cores
# (495e12) in three products (3xTF32, csrc/attention_tf32.cuh, both
# directions), the least any f32 kernel could take.  The CUDA cores' f32 FMA
# rate, 67e12, would be the ceiling of a kernel that stayed off the tensor
# cores: its time against this bound could read at most 67/165 = 0.41.
PEAK_OPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # docs/attention_numerics_tpu.json
DROPOUT_LIMITS = {"keep_rate_abs": 0.01, "scale_rel": 1e-3, "fd_rel": 2e-3}  # the same file
# the rate the reference's numerics artifact checks its kernel's dropout at
# (``dropout_semantics``); the preset trains the decoder at decoder_dropout 0.2
RATE = 0.1
# full-width forward, kernel path against plain path (mel and stop logits on
# valid frames): f32 at the port's CPU forward parity tolerance (1e-4,
# tests/test_torch_model.py); bf16 at 0.1, twice the largest difference read
# on the H100 (0.049; PERF.md has the readings)
FORWARD_LIMIT = {"float32": 1e-4, "bfloat16": 0.1}
SERVE_TEXTS = [  # four in the 32-phoneme bucket, one in the 64 bucket
    "Привет, мир!",
    "Кот спит дома.",
    "Как дела у тебя?",
    "Мы идём в лес.",
    "Сегодня хорошая погода, и мы идём гулять в большой парк у реки.",
]


PHASES = ["kernels", "kernels_bwd", "dropout", "kernels_flash", "kernels_folded", "forward",
          "serve", "train", "long", "mfa", "tools", "quality", "vocoder_train", "scripts",
          "bench", "parallel", "parallel_sp_pp"]
# peak allocated bytes of the bf16 steps of phases train and long, which
# phase tools holds the memory planner to
MEASURED_PEAKS = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one call of ``fn`` between CUDA events around ``iters``
    back-to-back calls issued from the host: for the plain versions and the
    full-width forward, whose device work outlasts their host work."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn) -> float:
    """Device time of one call of ``fn``: 20 calls captured in one CUDA graph,
    the graph replayed between CUDA events, the median of 5 replays over 20.
    No host work (argument checks, ``torch.empty``, the ctypes call) falls
    inside the timed window, so a kernel of 0.1 ms is timed by the device
    and not by its wrapper."""
    import statistics

    import torch

    iters = 20
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def visible_pairs(B, T, causal, lens=None, segments=None) -> int:
    """The (query, key) pairs the attention of this input computes, over B
    rows of T queries and T keys (heads not counted): the causal triangle, or
    each row's kv length (a packed row of length 0 averages all T keys), or,
    with flash segment ids ``(q_seg, kv_seg)``, the pairs of equal segment
    (inside the triangle when causal)."""
    if segments is not None:
        import torch

        q_seg, kv_seg = (x.to("cpu", torch.int64) for x in segments)
        same = q_seg[:, :, None] == kv_seg[:, None, :]
        if causal:
            same &= torch.ones(T, T, dtype=torch.bool).tril()
        return int(same.sum())
    if causal:
        return B * T * (T + 1) // 2
    if lens is None:
        return B * T * T
    return T * sum(min(x, T) if x > 0 else T for x in lens)


def attention_bound(B, T, H, Dh, dtype_name, causal, lens=None, *, backward=False) -> dict:
    """Least time for the work this input needs, and the operations it
    counts.  Forward: q, k, v read once, o written once; 4*Dh operations per
    visible (query, key) pair (two products of 2*Dh).  Backward: q, k, v, o,
    dO and the f32 lse read once, dq, dk, dv written once; 10*Dh operations
    per visible pair (S, dPd, dV, dQ, dK).  kv lengths (4 bytes a row) count
    as read."""
    elem = 2 if dtype_name == "bfloat16" else 4
    tensors = 8 if backward else 4
    nbytes = tensors * B * T * H * Dh * elem + (4 * B * H * T if backward else 0)
    nbytes += 4 * B if lens is not None else 0
    ops = (10 if backward else 4) * Dh * H * visible_pairs(B, T, causal, lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return {"bound_ms": bound_ms, "bound_by": bound_by, "ops": ops}


def timed_row(bound: dict, ms: float, **fields) -> dict:
    """A timed kernel's row: its fields, the bound, and the achieved TFLOP/s
    and share of the bound (bound_ms / ms) of the measured time."""
    return {**fields, "ms": ms, "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "tflops": bound["ops"] / (ms * 1e-3) / 1e12, "bound_share": bound["bound_ms"] / ms}


def graph_kernel_nodes(fn) -> int:
    """The device kernels one call of ``fn`` launches, counted exactly: the
    call captured in a CUDA graph, and the graph's kernel nodes counted
    through the driver (``cuGraphGetNodes``, ``cuGraphNodeGetType``).
    Memsets and copies are not kernels."""
    import ctypes

    import torch

    def check(status):
        if status != 0:
            raise RuntimeError(f"CUDA driver call failed with status {status}")

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    driver = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(driver.cuGraphGetNodes(handle, None, ctypes.byref(count)))
    nodes = (ctypes.c_void_p * count.value)()
    check(driver.cuGraphGetNodes(handle, nodes, ctypes.byref(count)))
    kind, kernels = ctypes.c_int(0), 0
    for node in nodes[:count.value]:
        check(driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    return kernels


def profiled_kernels(fn, expect: int, calls: int = 10) -> dict:
    """``kernel_split_ms``: device ms a launch of each CUDA kernel ``fn``
    launches (the backward's dQ and dK/dV kernels), from ``torch.profiler``
    over ``calls`` calls, and ``device_kernels_per_call``: the device
    launches of a call, from ``graph_kernel_nodes``.  The profiler may drop a
    kernel's record, so it times the kernels and does not count them.
    Raises unless a call launches ``expect`` kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    per_call = graph_kernel_nodes(fn)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = [ev for ev in prof.key_averages() if ev.device_type.name == "CUDA"]
    split = {ev.key.split("(")[0].replace("void ", ""): ev.device_time_total / ev.count / 1e3
             for ev in device}
    if per_call != expect:
        raise AssertionError(f"a call launched {per_call} device kernels, not {expect}: "
                             f"{sorted(split)}")
    return {"kernel_split_ms": split, "device_kernels_per_call": per_call}


def backward_rate_readings(fwd, bwd) -> dict:
    """A backward row's readings at ``RATE``: ``bwd(*fwd())`` (the forward's
    outputs at that rate, then the backward) timed by graph replay, and its
    dQ and dK/dV kernels' split."""
    saved = fwd()
    return {"ms_rate_0.1": graph_time_ms(lambda: bwd(*saved)),
            "kernel_split_ms_rate_0.1": profiled_kernels(lambda: bwd(*saved), 2)["kernel_split_ms"]}


def library_bwd_ms(fwd, fwd_bwd) -> float:
    """The library's backward alone: its forward and backward through
    autograd minus its forward, each timed by graph replay (the median of 5)."""
    return graph_time_ms(fwd_bwd) - graph_time_ms(fwd)


def dropout_readings(fwd, sdpa) -> dict:
    """A forward row's readings at ``RATE``, what the training step runs:
    the kernel without and under grad (``fwd(for_backward)``), and SDPA's
    forward at ``dropout_p=RATE`` (``sdpa()``), a yardstick only since it
    draws its own mask. SDPA is timed by graph replay, or by CUDA events
    where capture refuses its generator (``library_rate_timing``)."""
    import torch

    row = {"ms_rate_0.1": graph_time_ms(lambda: fwd(False)),
           "ms_for_backward_rate_0.1": graph_time_ms(lambda: fwd(True))}
    try:
        row["library_ms_rate_0.1"], row["library_rate_timing"] = graph_time_ms(sdpa), "graph"
    except RuntimeError:
        torch.cuda.synchronize()
        row["library_ms_rate_0.1"], row["library_rate_timing"] = cuda_time_ms(sdpa), "events"
    return row


def close_or_raise(what, out, ref, tol):
    import torch

    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{what}: kernel disagrees with plain version, max abs err {err}")
    return err


# ---------------------------------------------------------------------------
def phase_device():
    from kokoro_tpu_torch.ops import kernels

    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = kernels.build_all()
    build_s = time.perf_counter() - t0
    from kokoro_tpu_torch import native

    if not native.native_available():  # the host-side C++ aligner of phase mfa
        raise AssertionError("the native duration aligner (csrc/aligner.cpp) did not build")
    regs, spills, serialized, tf32_regs, wide_regs, cluster_regs = {}, {}, {}, {}, {}, {}
    scores_regs = {}
    for name, path in libs.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        regs[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
        spills.update(ptxas_spills(lines))
        tf32_regs.update({fn: used for fn, used in ptxas_registers(lines).items()
                          if TF32_NAMESPACE in fn})
        # K4 at Dh 192 and 256 (template argument 192 or 256)
        wide_regs.update({fn: used for fn, used in ptxas_registers(lines).items()
                          if "Li192E" in fn or "Li256E" in fn})
        # K4 past Dh 256: the cluster instantiations (DH 128, flash, last
        # template argument CL true)
        cluster_regs.update({fn: used for fn, used in ptxas_registers(lines).items()
                             if is_cluster_kernel(fn)})
        # K4 past Dh 2048: the scores-in-memory kernels (csrc/attention_scores.cuh)
        scores_regs.update({fn: used for fn, used in ptxas_registers(lines).items()
                            if SCORES_NAMESPACE in fn})
        # ptxas serialises wgmma where it cannot keep the products asynchronous
        serialized[name] = sorted({ln.strip() for ln in lines if "Performance Loss" in ln})
    from kokoro_tpu_torch.ops import flash_attention as fl

    occupancy = cluster_occupancy()
    emit({"phase": "device", "nvidia_smi": smi, "build_s": build_s,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
          "aligner_library": str(native.library_path().relative_to(ROOT)),
          "ptxas": regs, "spills": spills, "wgmma_serialized": serialized,
          "tf32_registers": tf32_regs, "dh192_256_registers": wide_regs,
          "cluster_registers": cluster_regs, "scores_registers": scores_regs,
          "cluster_ctas": {Dh: fl.cluster_ctas(Dh) for Dh in fl.CLUSTER_HEAD_DIMS},
          "cluster_occupancy": occupancy,
          "tf32_matmul": False, "tf32_cudnn": False})
    # each head dim: the bf16 and f32 forward, dQ and dK/dV kernels
    if len(wide_regs) != 12:
        raise AssertionError(f"expected 12 K4 kernels at Dh 192 and 256, ptxas built "
                             f"{sorted(wide_regs)}")
    # past Dh 256: one set of the six for every head dim (the cluster size
    # is an argument of the launch)
    if len(cluster_regs) != 6:
        raise AssertionError(f"expected 6 K4 cluster kernels, ptxas built {sorted(cluster_regs)}")
    # past Dh 2048, each dtype: the scores, row pass, products over keys and
    # over queries, the backward's scores and the row deltas
    if len(scores_regs) != 12:
        raise AssertionError(f"expected 12 K4 scores-in-memory kernels, ptxas built "
                             f"{sorted(scores_regs)}")
    tensor_core = {fn: sp for fn, sp in spills.items()
                   if any(ns in fn for ns in TENSOR_CORE_NAMESPACES)}
    if tensor_core:
        raise AssertionError(f"the tensor-core kernels spill registers: {tensor_core}")
    if any(serialized.values()):  # every wgmma is a tensor-core kernel's
        raise AssertionError(f"ptxas serialises wgmma: {serialized}")
    refused = {kern: [c for c, n in fits.items() if n < 1] for kern, fits in occupancy.items()}
    if any(refused.values()):
        raise AssertionError(f"the card holds no cluster of these sizes: {refused}")
    return smi


def cluster_occupancy() -> dict:
    """``{"<dtype>/<kernel>": {c: clusters}}``: how many clusters of c CTAs
    (3 to 16, the head dims 320-2048) of each of the six K4 cluster kernels
    (bf16 and f32 forward, dQ and dK/dV) the card holds at once at the
    kernel's shared memory (``cudaOccupancyMaxActiveClusters``)."""
    import torch

    from kokoro_tpu_torch.ops import flash_attention as fl

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for c in range(3, fl.MAX_CLUSTER_CTAS + 1):
            for kern, n in fl.cluster_fits(dtype, c).items():
                out.setdefault(f"{dname}/{kern}", {})[c] = n
    return out


# the mangled namespaces of the tensor-core kernels: the bf16 templates
# (csrc/attention_tc.cuh) and the f32 forward and backward in 3xTF32
# (csrc/attention_tf32.cuh)
TF32_NAMESPACE = "kokoro_attn4tf32"
# K4 past Dh 2048 (csrc/attention_scores.cuh: mma.sync, bf16 and 3xTF32)
SCORES_NAMESPACE = "kokoro_attn6scores"
TENSOR_CORE_NAMESPACES = ("kokoro_attn2tc", TF32_NAMESPACE, SCORES_NAMESPACE)


def is_cluster_kernel(mangled: str) -> bool:
    """Whether a mangled kernel name is a K4 cluster instantiation: DH 128,
    the flash policy, no dropout, and CL (its last template argument) true."""
    return "ILi128ELb1ELb0E" in mangled and "Lb1EEEv" in mangled


def ptxas_registers(lines) -> dict:
    """``{mangled kernel name: ptxas's "Used N registers" line}`` of an
    ``-Xptxas -v`` log (ptxas names the kernel in a "Compiling entry
    function" line, then its properties and registers)."""
    out, current = {}, None
    for ln in lines:
        if "Compiling entry function" in ln:
            current = ln.split("'")[1] if "'" in ln else None
        elif "Used" in ln and "registers" in ln and current is not None:
            out[current] = ln.split(":", 1)[-1].strip()
            current = None
    return out


def ptxas_spills(lines) -> dict:
    """``{mangled kernel name: its ptxas spill line}`` for every kernel of an
    ``-Xptxas -v`` log that spills (ptxas names the kernel in a "Function
    properties for" line, then its stack frame and spills)."""
    out, current = {}, None
    for ln in lines:
        if "Function properties for" in ln:
            current = ln.rsplit(" ", 1)[-1].strip()
        elif "spill stores" in ln and current is not None:
            if "0 bytes spill stores, 0 bytes spill loads" not in ln:
                out[current] = ln.strip()
            current = None
    return out


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def qkv(B, T, H, Dh, dtype):
        return [torch.randn(B, T, H * Dh, generator=gen).to(dev, dtype) for _ in range(3)]

    sweep = []
    H = 8
    # B=4 over the bucket ladder (non-multiples of 128 included), then the
    # shape the full-width forward of phase 3 gives the kernels
    shapes = [(4, T, Dh) for Dh in (64, 128) for T in (128, 432, 512, 848, 896)]
    shapes.append((16, 512, 64))
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for B, T, Dh in shapes:
            q, k, v = qkv(B, T, H, Dh, dtype)
            lens = torch.tensor([T, T - 37, T // 2, 1] * (B // 4), dtype=torch.int32, device=dev)
            for kern in fa.FWD_KERNELS:
                kw = dict(num_heads=H, scale=Dh ** -0.5,
                          kv_lengths=None if kern.causal else lens)
                out = kern(q, k, v, **kw)
                torch.cuda.synchronize()
                ref = fa.packed_attention_reference(q, k, v, causal=kern.causal, **kw)
                err = (out.float() - ref.float()).abs().max().item()
                ok = torch.allclose(out.float(), ref.float(), rtol=TOL[dname], atol=TOL[dname])
                sweep.append({"kernel": kern.name, "dtype": dname, "B": B, "Dh": Dh, "T": T,
                              "max_abs_err": err, "ok": bool(ok)})
                if not ok:
                    raise AssertionError(f"kernel disagrees with plain version: {sweep[-1]}")
    emit({"phase": "kernels", "checks": len(sweep),
          "shapes": "H=8; B=4 Dh{64,128} T{128,432,512,848,896}; B=16 T=512 Dh=64",
          "f32_forward_repeats": f32_forward_repeats(gen),
          "tolerance": TOL, "max_abs_err": {
              f"{r['kernel']}/{r['dtype']}": max(s["max_abs_err"] for s in sweep
                                                 if s["kernel"] == r["kernel"] and s["dtype"] == r["dtype"])
              for r in sweep}})

    # decoder shape: B=32, T=512, H=8, Dh=64
    B, T, H, Dh = 32, 512, 8, 64
    lens_list = [T - 8 * i for i in range(B)]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v = qkv(B, T, H, Dh, dtype)
        qh, kh, vh = (x.view(B, T, H, Dh).transpose(1, 2) for x in (q, k, v))
        keep = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        for kern in fa.FWD_KERNELS:
            kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=None if kern.causal else lens)
            out = kern(q, k, v, **kw)
            ref = fa.packed_attention_reference(q, k, v, causal=kern.causal, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.allclose(out.float(), ref.float(), rtol=TOL[dname], atol=TOL[dname]):
                raise AssertionError(f"{kern.name} {dname} disagrees at the decoder shape: {err}")
            sdpa_kw = dict(is_causal=True) if kern.causal else dict(attn_mask=keep)
            lib = lambda p=0.0: F.scaled_dot_product_attention(qh, kh, vh, scale=Dh ** -0.5,
                                                               dropout_p=p, **sdpa_kw)
            bound = attention_bound(B, T, H, Dh, dname, kern.causal,
                                    None if kern.causal else lens_list)
            drop = dict(kw, dropout_rate=RATE, seed=11)
            timings[(kern.name, dname)] = timed_row(
                bound, graph_time_ms(lambda: kern(q, k, v, **kw)), max_abs_err=err,
                plain_ms=cuda_time_ms(lambda: fa.packed_attention_reference(
                    q, k, v, causal=kern.causal, **kw), iters=5),
                library_ms=graph_time_ms(lib),
                # under grad: the lse and (bf16) O's rounding residual written too
                ms_for_backward=graph_time_ms(lambda: kern(q, k, v, for_backward=True, **kw)),
                **profiled_kernels(lambda: kern(q, k, v, **kw), 1),
                **dropout_readings(lambda grad: kern(q, k, v, for_backward=grad, **drop),
                                   lambda: lib(RATE)))
        timings.update(backward_times(B, T, H, Dh, dtype, lens, lens_list, qkv))
    emit({"phase": "kernel_times", "shape": "B=32 T=512 H=8 Dh=64",
          "kv_lengths": "512 - 8*b", "times": {f"{n}/{d}": r for (n, d), r in timings.items()}})
    return timings


def f32_forward_repeats(gen) -> dict:
    """Each f32 forward (K1 and K2 at rates 0 and ``RATE``, K3, K4 with and
    without segment ids; Dh 64 and 128, ragged T) called twice with
    ``torch.backends.cuda.matmul.allow_tf32`` off and once with it on: O and
    lse bit for bit equal across the three, since the 3xTF32 kernels do not
    read the flag.  Raises at the first call that differs."""
    import torch

    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    B, T, H = 4, 433, 8
    calls = {}
    for Dh in (64, 128):
        q, k, v = (torch.randn(B, T, H * Dh, generator=gen).to(dev) for _ in range(3))
        lens = torch.tensor([T, T - 37, T // 2, 1], dtype=torch.int32, device=dev)
        for kern in fa.FWD_KERNELS:
            for rate in (0.0, RATE):
                kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=None if kern.causal else lens,
                          dropout_rate=rate, seed=77 if rate else None)
                calls[f"{kern.name}/Dh={Dh}/rate={rate}"] = (
                    lambda kern=kern, kw=kw, x=(q, k, v): kern(*x, for_backward=True, **kw)[:2])
        folded = tuple(x.view(B, T, H, Dh).transpose(1, 2).reshape(B * H, T, Dh).contiguous()
                       for x in (q, k, v))
        calls[f"folded_attention_fwd/Dh={Dh}/rate={RATE}"] = (
            lambda x=folded, Dh=Dh: fa.folded_attention_fwd(
                *x, num_heads=1, scale=Dh ** -0.5, dropout_rate=RATE, seed=78,
                for_backward=True)[:2])
        qh, kh, vh = (torch.randn(2, H, 1433, Dh, generator=gen).to(dev) for _ in range(3))
        seg = torch.ones(2, 1433, dtype=torch.int32, device=dev)
        seg[:, 900:] = 2
        for segs in ((None, None), (seg, seg.clone())):
            name = f"flash_attention_fwd/Dh={Dh}/segments={segs[0] is not None}"
            calls[name] = (lambda x=(qh, kh, vh), segs=segs, Dh=Dh: fl.flash_attention_fwd(
                *x, causal=True, scale=Dh ** -0.5, q_seg=segs[0], kv_seg=segs[1],
                return_lse=True))
    for name, call in calls.items():
        first, second = call(), call()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            third = call()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        for what, a, b, c in zip(("o", "lse"), first, second, third):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                raise AssertionError(f"f32 forward {name}: {what} differs between calls "
                                     "(two with allow_tf32 off, one with it on)")
    return {"cases": sorted(calls), "two_calls_bitwise_equal": True,
            "independent_of_allow_tf32": True}


def backward_times(B, T, H, Dh, dtype, lens, lens_list, qkv):
    """The backward kernels at rates 0 and 0.1, their plain version, and
    SDPA's backward (forward+backward through autograd minus forward)."""
    import torch
    import torch.nn.functional as F

    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    dname = str(dtype).split(".")[1]
    q, k, v = qkv(B, T, H, Dh, dtype)
    do = qkv(B, T, H, Dh, dtype)[0]
    heads = [x.view(B, T, H, Dh).transpose(1, 2).contiguous().requires_grad_(True)
             for x in (q, k, v)]
    do_h = do.view(B, T, H, Dh).transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    out = {}
    for kern in fa.BWD_KERNELS:
        fwd = fa.packed_attention_causal if kern.causal else fa.packed_attention_kvlen
        kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=None if kern.causal else lens)
        o, lse, res = fwd(q, k, v, for_backward=True, **kw)
        grads = kern(q, k, v, o, do, lse, res, **kw)
        ref = fa.packed_attention_bwd_reference(q, k, v, do, causal=kern.causal, **kw)
        err = max(close_or_raise(f"{kern.name} {dname} d{n}", a, b, GRAD_TOL[dname])
                  for n, a, b in zip("qkv", grads, ref))
        sdpa_kw = dict(is_causal=True) if kern.causal else dict(attn_mask=mask)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*heads, scale=Dh ** -0.5, **sdpa_kw)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), heads, do_h)

        bound = attention_bound(B, T, H, Dh, dname, kern.causal,
                                None if kern.causal else lens_list, backward=True)
        row = timed_row(
            bound, graph_time_ms(lambda: kern(q, k, v, o, do, lse, res, **kw)), max_abs_err=err,
            plain_ms=cuda_time_ms(lambda: fa.packed_attention_bwd_reference(
                q, k, v, do, causal=kern.causal, **kw), iters=5),
            library_ms=library_bwd_ms(sdpa_fwd, sdpa_fwd_bwd),
            **profiled_kernels(lambda: kern(q, k, v, o, do, lse, res, **kw), 2))
        drop = dict(kw, dropout_rate=RATE, seed=11)
        row.update(backward_rate_readings(
            lambda: fwd(q, k, v, for_backward=True, **drop),
            lambda o, lse, res: kern(q, k, v, o, do, lse, res, **drop)))
        row["plain_ms_rate_0.1"] = cuda_time_ms(lambda: fa.packed_attention_bwd_reference(
            q, k, v, do, causal=kern.causal, **drop), iters=3)
        out[(kern.name, dname)] = row
    return out


def packed_bwd_float64(q, k, v, do, *, num_heads, scale, causal=True, kv_lengths=None,
                       dropout_rate=0.0, seed=None):
    """The packed plain backward's recompute (``packed_attention_bwd_reference``
    without ``o``) in float64 on the same inputs and dropout mask: what the f32
    kernel and the f32 plain version are each held against in ``kernels_bwd``."""
    import torch

    from kokoro_tpu_torch.ops.philox import attention_keep_mask

    B, T, D = q.shape
    H, f64 = num_heads, torch.float64
    heads = lambda x: x.reshape(B, T, H, D // H).transpose(1, 2).to(f64)
    packed = lambda x: x.transpose(1, 2).reshape(B, T, D)
    qh, kh, vh, doh = (heads(x) for x in (q, k, v, do))
    s = qh @ kh.transpose(-1, -2) * scale
    cols = torch.arange(T, device=q.device)
    visible = ((cols[None, :] <= cols[:, None])[None, None] if causal
               else (cols[None, :] < kv_lengths[:, None])[:, None, None, :])
    p = torch.softmax(torch.where(visible, s, torch.full((), -1e9, dtype=f64, device=q.device)),
                      dim=-1)
    keep = (attention_keep_mask(seed, B, H, T, dropout_rate, device=q.device)
            if dropout_rate > 0.0 else None)
    inv_keep = 1.0 / (1.0 - dropout_rate)
    pd = p if keep is None else torch.where(keep, p * inv_keep, 0.0)
    dpd = doh @ vh.transpose(-1, -2)
    dp = dpd if keep is None else torch.where(keep, dpd * inv_keep, 0.0)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    return packed(ds @ kh), packed(ds.transpose(-1, -2) @ qh), packed(pd.transpose(-1, -2) @ doh)


def max_abs_diff(a, b) -> float:
    return max((x.double() - y.double()).abs().max().item() for x, y in zip(a, b))


def phase_kernels_bwd():
    """Forward at rate 0.1 and backward at rates 0 and 0.1, kernel against
    plain version with the same seed, over the bucket ladder; each backward
    called twice, bit for bit equal; the f32 kernel and the f32 plain
    version each against the plain recompute in float64; then rows of kv
    length 1 at rate 0.2 (the quality run's T and heads)."""
    import torch

    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    H = 8
    shapes = [(4, T, Dh) for Dh in (64, 128) for T in (128, 432, 512, 848, 896, 1433)]
    shapes.append((32, 512, 64))
    worst, checks, f64_errs = {}, 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for B, T, Dh in shapes:
            q, k, v, do = (torch.randn(B, T, H * Dh, generator=gen).to(dev, dtype)
                           for _ in range(4))
            lens = torch.tensor([T, T - 37, T // 2, 0] * (B // 4), dtype=torch.int32, device=dev)
            for fwd, bwd in zip(fa.FWD_KERNELS, fa.BWD_KERNELS):
                for rate in (0.0, RATE):
                    kw = dict(num_heads=H, scale=Dh ** -0.5,
                              kv_lengths=None if fwd.causal else lens,
                              dropout_rate=rate, seed=1000 + T if rate else None)
                    o, lse, res = fwd(q, k, v, for_backward=True, **kw)
                    grads = bwd(q, k, v, o, do, lse, res, **kw)
                    again = bwd(q, k, v, o, do, lse, res, **kw)
                    torch.cuda.synchronize()
                    where = f"{bwd.name} {dname} B={B} T={T} Dh={Dh} rate={rate}"
                    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                        raise AssertionError(f"{where}: two calls differ")
                    errs = [close_or_raise(where + " o", o, fa.packed_attention_reference(
                        q, k, v, causal=fwd.causal, **kw), TOL[dname])]
                    ref = fa.packed_attention_bwd_reference(q, k, v, do, causal=fwd.causal, **kw)
                    errs += [close_or_raise(f"{where} d{n}", a, b, GRAD_TOL[dname])
                             for n, a, b in zip("qkv", grads, ref)]
                    key = f"{bwd.name}/{dname}/rate={rate}"
                    worst[key] = max(worst.get(key, 0.0), *errs[1:])
                    if dtype == torch.float32:  # the kernel beside f32's own error
                        exact = packed_bwd_float64(q, k, v, do, causal=fwd.causal, **kw)
                        row = f64_errs.setdefault(key, {"kernel": 0.0, "plain_f32": 0.0})
                        row["kernel"] = max(row["kernel"], max_abs_diff(grads, exact))
                        row["plain_f32"] = max(row["plain_f32"], max_abs_diff(ref, exact))
                        del exact
                    worst[f"{fwd.name}/{dname}/rate={rate}"] = max(
                        worst.get(f"{fwd.name}/{dname}/rate={rate}", 0.0), errs[0])
                    checks += 1
    # one-key rows: every query's dS at the one key sums into its dK (the
    # plain version's dS there is exactly 0)
    B, T, Dh, rate = 4, 384, 64, 0.2
    one_key = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn(B, T, H * Dh, generator=gen).to(dev, dtype) for _ in range(4))
        kw = dict(num_heads=H, scale=Dh ** -0.5, dropout_rate=rate, seed=91,
                  kv_lengths=torch.tensor([1, T, 1, T // 2], dtype=torch.int32, device=dev))
        o, lse, res = fa.packed_attention_kvlen(q, k, v, for_backward=True, **kw)
        grads = fa.packed_attention_bwd_kvlen(q, k, v, o, do, lse, res, **kw)
        ref = fa.packed_attention_bwd_reference(q, k, v, do, causal=False, **kw)
        one_key[dname] = max(close_or_raise(f"one-key rows {dname} rate {rate} d{n}", a, b,
                                            GRAD_TOL[dname]) for n, a, b in zip("qkv", grads, ref))
    emit({"phase": "kernels_bwd", "checks": checks,
          "shapes": "H=8; B=4 Dh{64,128} T{128,432,512,848,896,1433}; B=32 T=512 Dh=64; "
                    "kv_lengths [T, T-37, T/2, 0]", "rates": [0.0, RATE],
          "two_calls_bitwise_equal": True,
          "one_key_rows": {"shape": "B=4 T=384 H=8 Dh=64, kv lengths [1, T, 1, T/2]",
                           "rate": rate, "max_abs_err": one_key},
          "f32_max_abs_err_vs_float64": f64_errs,
          "tolerance": {"forward": TOL, "grad": GRAD_TOL}, "max_abs_err": worst})


def phase_dropout():
    """The kernels' dropout semantics, as scripts/verify_attention_numerics.py
    measures the TPU's: f32, causal, B=2, H=4, T=128, Dh=64."""
    emit(dropout_semantics(4))


def dropout_semantics(H: int) -> dict:
    """The dropout semantics readings at B=2, T=128, Dh=64 and ``H`` heads;
    raises when one is outside ``DROPOUT_LIMITS``."""
    import torch

    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(3)
    B, T, Dh, keep = 2, 128, 64, 1.0 - RATE
    q, k = (0.1 * torch.randn(B, T, H * Dh, generator=gen).to(dev) for _ in range(2))
    kw = dict(num_heads=H, scale=Dh ** -0.5, causal=True)

    def eye_block(j0):
        e = torch.zeros(T, Dh, device=dev)
        e[j0:j0 + Dh] = torch.eye(Dh, device=dev)
        return e[None, :, None, :].expand(B, T, H, Dh).reshape(B, T, H * Dh).contiguous()

    def pd_forward(seed, rate=RATE):
        cols = [fa.packed_attention(q, k, eye_block(j0), dropout_rate=rate, seed=seed, **kw)
                for j0 in range(0, T, Dh)]
        return torch.cat([c.view(B, T, H, Dh) for c in cols], -1).permute(0, 2, 1, 3)

    def pd_backward(seed):
        vx = torch.randn(B, T, H * Dh, generator=gen).to(dev).requires_grad_(True)
        rows = []
        for j0 in range(0, T, Dh):
            out = fa.packed_attention(q, k, vx, dropout_rate=RATE, seed=seed, **kw)
            (dv,) = torch.autograd.grad(out, vx, eye_block(j0))
            rows.append(dv.view(B, T, H, Dh).permute(0, 2, 3, 1))  # [b, h, row, key]
        return torch.cat(rows, 2)

    seed = 41
    pd_fwd, pd_fwd2, pd_other = pd_forward(seed), pd_forward(seed), pd_forward(seed + 1)
    p_det = pd_forward(None, rate=0.0)
    pd_bwd = pd_backward(seed)
    causal = torch.tril(torch.ones(T, T, dtype=torch.bool, device=dev)).expand_as(pd_fwd)
    mask_fwd, mask_bwd = pd_fwd != 0, pd_bwd != 0
    disagree = int((causal & (mask_fwd != mask_bwd)).sum())
    kept = causal & mask_fwd & mask_bwd
    pd_rel = ((pd_fwd - pd_bwd).abs()[kept] / pd_fwd.abs()[kept].clamp(min=1e-12)).max().item()
    keep_hat = mask_fwd[causal].float().mean().item()
    sel = kept & (p_det > 1e-8)
    scale_err = ((pd_fwd[sel] - p_det[sel] / keep).abs() / (p_det[sel] / keep)).max().item()
    # finite difference along the gradient, true f32
    qs, ks, vs = (torch.randn(1, 128, 2 * 64, generator=gen).to(dev) for _ in range(3))
    fkw = dict(num_heads=2, scale=0.125, dropout_rate=RATE, seed=55)

    def f(qq):
        return (fa.packed_attention(qq, ks, vs, **fkw) ** 2).sum()

    leaf = qs.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(f(leaf), leaf)
    gnorm = g.norm().item()
    d, eps = g / gnorm, 1e-2
    with torch.no_grad():
        fd = (f(qs + eps * d).item() - f(qs - eps * d).item()) / (2 * eps)
    fd_rel = abs(fd - gnorm) / max(abs(fd), 1e-12)
    result = {
        "phase": "dropout", "heads": H, "rate": RATE, "keep_rate_observed": keep_hat,
        "keep_rate_abs_err": abs(keep_hat - keep),
        "surviving_weight_scale_max_rel_err": scale_err,
        "mask_fwd_bwd_disagreements": disagree, "mask_positions_checked": int(causal.sum()),
        "pd_fwd_bwd_max_rel_err": pd_rel, "grad_fd_rel_err": fd_rel,
        "same_seed_deterministic": bool(torch.equal(pd_fwd, pd_fwd2)),
        "other_seed_differs": bool(not torch.equal(mask_fwd, pd_other != 0)),
        "limits": DROPOUT_LIMITS,
    }
    if not (result["keep_rate_abs_err"] <= DROPOUT_LIMITS["keep_rate_abs"]
            and scale_err <= DROPOUT_LIMITS["scale_rel"] and disagree == 0
            and fd_rel <= DROPOUT_LIMITS["fd_rel"] and result["same_seed_deterministic"]
            and result["other_seed_differs"]):
        raise AssertionError(f"dropout semantics outside the limits: {result}")
    return result


def _flash_masks(kind, B, T, dev, gen):
    """(q_valid, kv_valid) bool on the card, or (None, None)."""
    import torch

    if kind == "none":
        return None, None
    if kind == "suffix":  # right padding, as collate makes it
        lens = torch.tensor([T, T - 37, T // 2, T - 300][:B], device=dev)
        valid = torch.arange(T, device=dev)[None, :] < lens[:, None]
        return valid, valid
    # interior (non-suffix) padding on the key side, every query valid
    valid = (torch.rand(B, T, generator=gen) > 0.3).to(dev)
    valid[:, 0] = True
    return torch.ones(B, T, dtype=torch.bool, device=dev), valid


# K4's head dims: 64 and 128 (the packed kernels' too), 192 and 256 (K4's
# own), and from 320 the cluster kernels (320, 448 and 896 ragged in their
# last 128-column slice; 640, 768 and 896 clusters of 5, 6 and 7 CTAs, whose
# exchanged tiles split unevenly; 1024 the largest portable cluster), and
# past 1024 one head dim of every cluster size from 9 to 16, larger than the
# portable 8 (1088 ragged); past 2048 the scores in device memory (2112
# with a ragged 64-column last strip, 2560 the model of phase long's hidden
# 2560 at one head, up to 8192)
FLASH_PAST_1024 = (1088, 1152, 1280, 1408, 1536, 1664, 1792, 1920, 2048)
FLASH_PAST_2048 = (2112, 2176, 2304, 2560, 3072, 4096, 8192)
FLASH_HEAD_DIMS = (64, 128, 192, 256, 320, 384, 448, 512, 640, 768, 896, 1024, *FLASH_PAST_1024,
                   *FLASH_PAST_2048)
# the lengths swept up to Dh 256, past it (fewer, to keep the script well
# inside its time limit), and at the clusters of 5-7 and of 9-16 CTAs and
# past 2048 (one; 1024 too at 2176 and 2560)
FLASH_LENGTHS = {"narrow": (1024, 1408, 1433, 1920), "cluster": (1024, 1433),
                 "cluster_5_7_9_16": (1433,), "scores_1024": (1024, 1433)}


def flash_lengths(Dh: int) -> tuple:
    """The T that phase kernels_flash sweeps at head dim ``Dh``."""
    if Dh <= 256:
        return FLASH_LENGTHS["narrow"]
    if Dh in (2176, 2560):
        return FLASH_LENGTHS["scores_1024"]
    one = Dh in (640, 768, 896) or Dh in FLASH_PAST_1024 or Dh in FLASH_PAST_2048
    return FLASH_LENGTHS["cluster_5_7_9_16" if one else "cluster"]


def flash_heads(Dh: int) -> int:
    """Heads of phase kernels_flash's cases at head dim ``Dh`` (B=2): fewer
    past 1024, to bound the phase, and one at 8192."""
    return 8 if Dh <= 1024 else (1 if Dh >= 8192 else 2)


# (H, Dh) of K4's timed rows at the long shape B=12, T=1408: the flagship's 8
# heads of 64, and its hidden 512 over 2 heads (Dh 256) and one (Dh 512, phase
# long's models), hidden 768 over 4 (Dh 192) and 2 (Dh 384), and Dh 1024 at
# one head (the largest portable cluster, 8 CTAs); then past 1024 at one head,
# Dh 1152, 1536 (hidden 1536, phase long's model at one head) and 2048
# (clusters of 9, 12 and 16 CTAs)
FLASH_TIMED = ((8, 64), (2, 256), (4, 192), (2, 384), (1, 512), (1, 1024),
               (1, 1152), (1, 1536), (1, 2048), (1, 2560), (1, 4096))
# the scores-in-memory kernels called directly where the wrappers take the
# cluster kernels: held and timed beside them (B=12 T=1408 H=1)
SCORES_BESIDE_CLUSTERS = (1536, 2048)


def phase_kernels_flash():
    """K4 forward and backward against their plain versions at every head
    dim of ``FLASH_HEAD_DIMS``, each call twice (f32 a third time with
    ``allow_tf32`` on) and bit for bit equal; then the times at the long
    training shape B=12, T=1408 at each (H, Dh) of ``FLASH_TIMED``."""
    import torch

    from kokoro_tpu_torch.ops import flash_attention as fl

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(4)
    B = 2
    worst, worst_ratio, checks = {}, {}, 0
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for Dh in FLASH_HEAD_DIMS:
            H = flash_heads(Dh)
            for T in flash_lengths(Dh):
                q, k, v, do = (torch.randn(B, H, T, Dh, generator=gen).to(dev, dtype)
                               for _ in range(4))
                for causal in (True, False):
                    for kind in ("none", "suffix", "interior"):
                        q_valid, kv_valid = _flash_masks(kind, B, T, dev, gen)
                        q_seg, kv_seg = fl.segment_ids(q, k, q_valid, kv_valid)
                        kw = dict(causal=causal, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)

                        def call():
                            o, lse = fl.flash_attention_fwd(q, k, v, return_lse=True, **kw)
                            return (o, lse), fl.flash_attention_bwd(q, k, v, o, do, lse, **kw)

                        (o, lse), grads = call()
                        again = [call()]
                        if dtype == torch.float32:  # the 3xTF32 kernels do not read the flag
                            torch.backends.cuda.matmul.allow_tf32 = True
                            try:
                                again.append(call())
                            finally:
                                torch.backends.cuda.matmul.allow_tf32 = False
                        torch.cuda.synchronize()
                        where = f"{dname} T={T} Dh={Dh} causal={causal} masks={kind}"
                        for fwd2, grads2 in again:
                            if not all(torch.equal(a, b) for a, b in zip((o, lse), fwd2)):
                                raise AssertionError(f"flash fwd {where}: two calls differ")
                            if not all(torch.equal(a, b) for a, b in zip(grads, grads2)):
                                raise AssertionError(f"flash bwd {where}: two calls differ")
                        ref_o = fl.flash_attention_reference(q, k, v, **kw)
                        err_o = close_or_raise(where + " o", o, ref_o, TOL[dname])
                        ref = fl.flash_attention_bwd_reference(q, k, v, o, do, **kw)
                        err_g = max(close_or_raise(f"{where} d{n}", a, b, GRAD_TOL[dname])
                                    for n, a, b in zip("qkv", grads, ref))
                        for key, err in ((f"fwd/{dname}/Dh={Dh}", err_o),
                                         (f"bwd/{dname}/Dh={Dh}", err_g)):
                            worst[key] = max(worst.get(key, 0.0), err)
                        # the share of the allclose bound used (|S| grows with Dh)
                        ratios = {f"fwd/{dname}/Dh={Dh}": allclose_ratio(o, ref_o, TOL[dname]),
                                  f"bwd/{dname}/Dh={Dh}": max(
                                      allclose_ratio(a, b, GRAD_TOL[dname])
                                      for a, b in zip(grads, ref))}
                        for key, r in ratios.items():
                            worst_ratio[key] = max(worst_ratio.get(key, 0.0), r)
                        checks += 1
                        del again, ref_o, ref
                del q, k, v, do
            torch.cuda.empty_cache()
    emit({"phase": "kernels_flash", "checks": checks, "two_calls_bitwise_equal": True,
          "f32_independent_of_allow_tf32": True,
          "shapes": "B=2 H=8; Dh{64,128,192,256} x T{1024,1408,1433,1920}, "
                    "Dh{320,384,448,512,1024} x T{1024,1433} and Dh{640,768,896} x "
                    "T{1433}; B=2 H=2 Dh{1088,1152,1280,1408,1536,1664,1792,1920,2048} x "
                    "T{1433}; past 2048 (the scores in device memory) B=2 H=2 "
                    "Dh{2112,2176,2304,2560,3072,4096} x T{1433} (and T 1024 at 2176, 2560), "
                    "H=1 Dh 8192; x causal/non-causal x segment ids none/suffix/interior",
          "cluster_ctas_checked": sorted({fl.cluster_ctas(Dh) for Dh in FLASH_HEAD_DIMS
                                          if 256 < Dh <= fl.MAX_CLUSTER_HEAD_DIM}),
          "tolerance": {"forward": TOL, "grad": GRAD_TOL}, "max_abs_err": worst,
          "worst_allclose_ratio": worst_ratio, "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit({"phase": "kernels_flash_scores", **scores_path_checks(gen),
          "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()

    timings = {}
    for H, Dh in FLASH_TIMED:
        timings.update(flash_times(12, 1408, H, Dh, gen))
    emit({"phase": "kernel_times_flash", "shape": "B=12 T=1408 causal",
          "times": {f"{n}/{d}/H={H}/Dh={Dh}": r for (n, d, H, Dh), r in timings.items()},
          "wall_s": time.perf_counter() - t0})
    # the f32 kernels at Dh 192 and 256 (csrc/attention_tf32_wide.cuh): each
    # kernel's device ms, the backward's dQ against its dK/dV kernel
    emit({"phase": "kernel_split_f32_dh192_256", "shape": "B=12 T=1408 causal",
          "kernel_split_ms": {f"{n}/H={H}/Dh={Dh}": r["kernel_split_ms"]
                              for (n, d, H, Dh), r in timings.items()
                              if d == "float32" and Dh in (192, 256)}})
    # the bf16 kernels at Dh 192 and 256 (csrc/attention_tc_wide.cuh): the same
    emit({"phase": "kernel_split_bf16_dh192_256", "shape": "B=12 T=1408 causal",
          "kernel_split_ms": {f"{n}/H={H}/Dh={Dh}": r["kernel_split_ms"]
                              for (n, d, H, Dh), r in timings.items()
                              if d == "bfloat16" and Dh in (192, 256)}})
    # the scores-in-memory kernels where the wrappers take the cluster kernels
    scores = {}
    for Dh in SCORES_BESIDE_CLUSTERS:
        scores.update(scores_times(12, 1408, 1, Dh, gen))
    emit({"phase": "kernel_times_flash_scores", "shape": "B=12 T=1408 H=1 causal",
          "called": "flash_attention_{fwd,bwd}_scores directly (the wrappers route these "
                    "head dims to the cluster kernels)",
          "times": {f"{n}/{d}/Dh={Dh}": {**r, "cluster_ms": timings[(
              "flash_attention_" + n.split("_")[2], d, 1, Dh)]["ms"]}
              for (n, d, Dh), r in scores.items()}})
    # the flagship's rows (H=8, Dh=64) keep their keys; the others carry their head dim
    timings = {(n, d) if (H, Dh) == FLASH_TIMED[0] else (n, d, f"Dh={Dh}"): r
               for (n, d, H, Dh), r in timings.items()}
    timings.update(long_cross_attention(gen))
    forward_item_cost(gen)
    return timings


def flash_times(B, T, H, Dh, gen) -> dict:
    """K4 forward and backward, causal, at (B, H, T, Dh), both dtypes: each
    against its plain version, then its device time, its bound, its plain
    version's time and SDPA's (forward; forward and backward minus forward),
    keyed ``(wrapper, dtype, H, Dh)``.  Past Dh 1024 SDPA runs with its
    memory-efficient backend pinned, and where that refuses the shape the row
    holds its words (``library_refused``) and no library time."""
    import torch
    import torch.nn.functional as F

    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.scripts.probe_flash_tc_wide import sdpa_default_backend

    dev = torch.device("cuda")
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn(B, H, T, Dh, generator=gen).to(dev, dtype) for _ in range(4))
        kw = dict(causal=True, scale=Dh ** -0.5)
        where = f"{dname} B={B} T={T} H={H} Dh={Dh}"
        o, lse = fl.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        err_o = close_or_raise(f"flash fwd {where}", o,
                               fl.flash_attention_reference(q, k, v, **kw), TOL[dname])
        grads = fl.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        ref = fl.flash_attention_bwd_reference(q, k, v, o, do, **kw)
        err_g = max(close_or_raise(f"flash bwd {where} d{n}", a, b, GRAD_TOL[dname])
                    for n, a, b in zip("qkv", grads, ref))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        # past Dh 256 SDPA's flash backend refuses: the first fused backend
        # that takes the call, pinned, else the math backend; past 1024 the
        # memory-efficient backend, pinned, or the words of its refusal
        refused = None
        if Dh > 1024:
            backend = "EFFICIENT_ATTENTION"
            refused = sdpa_refusal(leaves, do, backend)
        else:
            backend = sdpa_backend(leaves, do) if Dh > 256 else None
        # at Dh 192 and 256 SDPA runs unpinned: the backend it picks, named
        named = (backend if backend is not None else
                 sdpa_default_backend(*leaves, Dh ** -0.5) if Dh in (192, 256) else None)

        def sdpa_fwd():
            with sdpa_pinned(backend):
                return F.scaled_dot_product_attention(*leaves, is_causal=True, scale=Dh ** -0.5)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), leaves, do)

        library = {} if named is None else {"library_backend": named}
        if refused is not None:
            library["library_refused"] = refused
        timings[("flash_attention_fwd", dname, H, Dh)] = timed_row(
            attention_bound(B, T, H, Dh, dname, True),
            graph_time_ms(lambda: fl.flash_attention_fwd(q, k, v, **kw)), max_abs_err=err_o,
            **profiled_kernels(lambda: fl.flash_attention_fwd(q, k, v, **kw),
                               3 if fl.scores_path(Dh) else 1),
            # under grad: the lse written too (the flash forward has no dropout)
            ms_for_backward=graph_time_ms(
                lambda: fl.flash_attention_fwd(q, k, v, return_lse=True, **kw)),
            plain_ms=cuda_time_ms(lambda: fl.flash_attention_reference(q, k, v, **kw), iters=3),
            library_ms=None if refused else graph_time_ms(sdpa_fwd), **library)
        timings[("flash_attention_bwd", dname, H, Dh)] = timed_row(
            attention_bound(B, T, H, Dh, dname, True, backward=True),
            graph_time_ms(lambda: fl.flash_attention_bwd(q, k, v, o, do, lse, **kw)),
            max_abs_err=err_g,
            **profiled_kernels(lambda: fl.flash_attention_bwd(q, k, v, o, do, lse, **kw),
                               5 if fl.scores_path(Dh) else 2),
            plain_ms=cuda_time_ms(lambda: fl.flash_attention_bwd_reference(
                q, k, v, o, do, **kw), iters=3),
            library_ms=None if refused else library_bwd_ms(sdpa_fwd, sdpa_fwd_bwd), **library)
        del q, k, v, do, o, lse, grads, ref, leaves
        torch.cuda.empty_cache()
    return timings


def scores_path_checks(gen) -> dict:
    """K4's scores-in-memory kernels beyond the sweep: (a) the compiled
    launcher's grid against ``flash_scores.grid``; (b) rows that see one key
    and rows that see none, both dtypes, causal and not, at Dh 2112 and 2560
    (T=1433, B=2, H=1): the one-key rows' dQ exactly 0, the no-key rows' O
    and dQ exactly 0 and lse +inf, every output within the tolerances, two
    calls bit for bit; (c) the kernels called directly at the cluster head
    dims ``SCORES_BESIDE_CLUSTERS`` (T=1433, B=2, H=2, every mask kind,
    causal), against the plain versions and bitwise over two calls."""
    import torch

    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import flash_scores as fs

    dev = torch.device("cuda")
    grids = 0
    for dtype in (torch.float32, torch.bfloat16):
        for Tq, Tk, Dh, causal in ((1433, 1433, 2112, True), (1408, 1408, 2560, True),
                                   (1024, 1024, 8192, False), (300, 1000, 4096, True)):
            want, got = fs.grid(Tq, Tk, Dh, causal, dtype), fs.launch_grid(Tq, Tk, Dh, causal,
                                                                            dtype)
            if want != got:
                raise AssertionError(f"scores grid at {(Tq, Tk, Dh, causal, dtype)}: the "
                                     f"launcher's {got}, flash_scores.grid's {want}")
            grids += 1
    worst = {}

    def hold(where, dname, outs, refs, tols):
        for label, a, b, tol in zip(("o", "dq", "dk", "dv"), outs, refs, tols):
            err = close_or_raise(f"{where} {label}", a, b, tol)
            key = f"{'fwd' if label == 'o' else 'bwd'}/{dname}"
            worst[key] = max(worst.get(key, 0.0), err)

    rows = []
    B, T = 2, 1433
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for Dh in (2112, 2560):
            q, k, v, do = (torch.randn(B, 1, T, Dh, generator=gen).to(dev, dtype)
                           for _ in range(4))
            one, none = [0, 63, 64, 127, 128, 700, T - 1], [5, 200, 1300]
            q_seg = torch.ones(B, T, dtype=torch.int32, device=dev)
            for i, r in enumerate(one):
                q_seg[:, r] = 2 + i
            kv_seg = q_seg.clone()  # key r alone shares row r's segment
            for r in none:
                q_seg[:, r] = 100 + r  # no key's segment
            for causal in (True, False):
                kw = dict(causal=causal, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
                runs = []
                for _ in range(2):
                    o, lse = fl.flash_attention_fwd(q, k, v, return_lse=True, **kw)
                    runs.append((o, lse, *fl.flash_attention_bwd(q, k, v, o, do, lse, **kw)))
                torch.cuda.synchronize()
                where = f"{dname} Dh={Dh} causal={causal} one-key and no-key rows"
                if not all(torch.equal(a, b) for a, b in zip(*runs)):
                    raise AssertionError(f"{where}: two calls differ")
                o, lse, dq, dk, dv = runs[0]
                zero = lambda x, r: torch.equal(x[:, :, r], torch.zeros_like(x[:, :, r]))  # noqa: E731
                if not (zero(dq, one) and zero(o, none) and zero(dq, none)
                        and torch.isinf(lse[:, :, none]).all()
                        and torch.isfinite(lse[:, :, one]).all()):
                    raise AssertionError(f"{where}: a one-key row's dQ, or a no-key row's O, "
                                         f"dQ or lse, is not what the contract says")
                ref = fl.flash_attention_bwd_reference(q, k, v, o, do, **kw)
                hold(where, dname, (o, dq, dk, dv),
                     (fl.flash_attention_reference(q, k, v, **kw), *ref),
                     (TOL[dname],) + (GRAD_TOL[dname],) * 3)
                rows.append(where)
            del q, k, v, do
    direct = 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for Dh in SCORES_BESIDE_CLUSTERS:
            q, k, v, do = (torch.randn(B, 2, T, Dh, generator=gen).to(dev, dtype)
                           for _ in range(4))
            for kind in ("none", "suffix", "interior"):
                q_valid, kv_valid = _flash_masks(kind, B, T, dev, gen)
                q_seg, kv_seg = fl.segment_ids(q, k, q_valid, kv_valid)
                kw = dict(causal=True, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
                runs = []
                for _ in range(2):
                    o, lse = fl.flash_attention_fwd_scores(q, k, v, return_lse=True, **kw)
                    runs.append((o, lse, *fl.flash_attention_bwd_scores(q, k, v, o, do, lse,
                                                                        **kw)))
                torch.cuda.synchronize()
                where = f"{dname} Dh={Dh} T={T} masks={kind} scores path called directly"
                if not all(torch.equal(a, b) for a, b in zip(*runs)):
                    raise AssertionError(f"{where}: two calls differ")
                o, lse, dq, dk, dv = runs[0]
                ref = fl.flash_attention_bwd_reference(q, k, v, o, do, **kw)
                hold(where, dname, (o, dq, dk, dv),
                     (fl.flash_attention_reference(q, k, v, **kw), *ref),
                     (TOL[dname],) + (GRAD_TOL[dname],) * 3)
                direct += 1
            del q, k, v, do
    torch.cuda.empty_cache()
    return {"grids_equal_the_launchers": grids, "one_and_no_key_cases": rows,
            "direct_at_cluster_head_dims": direct, "max_abs_err": worst,
            "tolerance": {"forward": TOL, "grad": GRAD_TOL}}


def scores_times(B, T, H, Dh, gen) -> dict:
    """The scores-in-memory kernels called directly at (B, H, T, Dh), causal,
    both dtypes: each against its plain version, then its device time, each
    device kernel's time and the share of the bound, keyed
    ``(name, dtype, Dh)``."""
    import torch

    from kokoro_tpu_torch.ops import flash_attention as fl

    dev = torch.device("cuda")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn(B, H, T, Dh, generator=gen).to(dev, dtype) for _ in range(4))
        kw = dict(causal=True, scale=Dh ** -0.5)
        where = f"scores path {dname} B={B} T={T} H={H} Dh={Dh}"
        o, lse = fl.flash_attention_fwd_scores(q, k, v, return_lse=True, **kw)
        err_o = close_or_raise(where, o, fl.flash_attention_reference(q, k, v, **kw), TOL[dname])
        grads = fl.flash_attention_bwd_scores(q, k, v, o, do, lse, **kw)
        ref = fl.flash_attention_bwd_reference(q, k, v, o, do, **kw)
        err_g = max(close_or_raise(f"{where} d{n}", a, b, GRAD_TOL[dname])
                    for n, a, b in zip("qkv", grads, ref))
        out[("flash_scores_fwd", dname, Dh)] = timed_row(
            attention_bound(B, T, H, Dh, dname, True),
            graph_time_ms(lambda: fl.flash_attention_fwd_scores(q, k, v, **kw)),
            max_abs_err=err_o,
            **profiled_kernels(lambda: fl.flash_attention_fwd_scores(q, k, v, **kw), 3))
        out[("flash_scores_bwd", dname, Dh)] = timed_row(
            attention_bound(B, T, H, Dh, dname, True, backward=True),
            graph_time_ms(lambda: fl.flash_attention_bwd_scores(q, k, v, o, do, lse, **kw)),
            max_abs_err=err_g,
            **profiled_kernels(lambda: fl.flash_attention_bwd_scores(q, k, v, o, do, lse, **kw),
                               5))
        del q, k, v, do, o, lse, grads, ref
        torch.cuda.empty_cache()
    return out


SDPA_FUSED = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_pinned(backend):
    """``torch.nn.attention.sdpa_kernel`` pinned to ``backend`` (a name of
    ``SDPBackend``), or no pin."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return contextlib.nullcontext() if backend is None else sdpa_kernel(
        getattr(SDPBackend, backend))


def sdpa_refusal(leaves, do, backend):
    """None where SDPA's causal forward and backward run on ``leaves`` with
    ``backend`` pinned; else the words of its refusal: the error and the
    warnings that give its reasons."""
    import warnings

    import torch
    import torch.nn.functional as F

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            with sdpa_pinned(backend):
                out = F.scaled_dot_product_attention(*leaves, is_causal=True)
                torch.autograd.grad(out, leaves, do)
            torch.cuda.synchronize()
            return None
        except RuntimeError as exc:
            error = str(exc)
    return {"error": error, "warnings": sorted({str(w.message) for w in caught})}


def sdpa_backend(leaves, do) -> str:
    """The first of ``SDPA_FUSED`` that runs SDPA's causal forward and
    backward on ``leaves``, else ``"MATH"`` (no fused backend)."""
    import torch
    import torch.nn.functional as F

    for name in SDPA_FUSED:
        try:
            with sdpa_pinned(name):
                out = F.scaled_dot_product_attention(*leaves, is_causal=True)
                torch.autograd.grad(out, leaves, do)
            torch.cuda.synchronize()
            return name
        except RuntimeError:
            continue
    return "MATH"


# (B, T) of K2 at every kv length T with about 8 work items (query tiles of
# 128 rows x heads, H=8) a CTA on 132 SMs: an item visits T / 128 key tiles
ITEM_COST_SHAPES = [(132, 128), (66, 256), (33, 512), (16, 1024), (12, 1408)]


def forward_item_cost(gen) -> dict:
    """What a work item of the persistent bf16 forward costs beside its key
    tiles: K2 at ``ITEM_COST_SHAPES`` (Dh=64, so 128-key tiles), device ms a
    call by graph replay, over the items of the busiest CTA; a least-squares
    line through (key tiles an item, ms an item) gives the cost of a key tile
    (slope) and of an item's start and end (intercept)."""
    import torch

    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    H, Dh = 8, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    points = []
    for B, T in ITEM_COST_SHAPES:
        q, k, v = (torch.randn(B, T, H * Dh, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(3))
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        ms = graph_time_ms(lambda: fa.packed_attention_kvlen(q, k, v, num_heads=H,
                                                             scale=Dh ** -0.5, kv_lengths=lens))
        tiles = -(-T // 128)
        items = B * H * tiles
        points.append({"B": B, "T": T, "items": items, "key_tiles_per_item": tiles, "ms": ms,
                       "ms_per_item": ms / -(-items // sms)})
    x = [p["key_tiles_per_item"] for p in points]
    y = [p["ms_per_item"] for p in points]
    mx, my = sum(x) / len(x), sum(y) / len(y)
    slope = sum((a - mx) * (b - my) for a, b in zip(x, y)) / sum((a - mx) ** 2 for a in x)
    out = {"phase": "forward_item_cost", "kernel": "packed_attention_fwd_kvlen bf16 H=8 Dh=64, "
           "kv length T", "sms": sms, "points": points, "us_per_key_tile": slope * 1e3,
           "us_per_item": (my - slope * mx) * 1e3}
    emit(out)
    return out


def long_cross_attention(gen):
    """K2 forward (``packed_attention_kvlen``) and the packed kv-length
    backward at the long path's decoder cross-attention shape, B=12, T=1408,
    H=8, Dh=64, f32 and bf16, rates 0 (the long path's) and 0.1, against their
    plain versions: with the kv lengths the long batch gives (every frame
    valid: 1408) and with a mixed set holding a row of length 0.  Then their
    times at the long batch's lengths, keyed ``(name, dtype, "long")``."""
    import torch
    import torch.nn.functional as F

    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    B, T, H, Dh = 12, 1408, 8, 64
    fwd, bwd = fa.packed_attention_kvlen, fa.packed_attention_bwd_kvlen
    lens_sets = {"long_batch": [T] * B, "mixed": [T, T - 37, T // 2, 0] * (B // 4)}
    worst, checks, timings = {}, 0, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn(B, T, H * Dh, generator=gen).to(dev, dtype) for _ in range(4))
        for set_name, lens_list in lens_sets.items():
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            for rate in (0.0, RATE):
                kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=lens, dropout_rate=rate,
                          seed=3000 if rate else None)
                o, lse, res = fwd(q, k, v, for_backward=True, **kw)
                grads = bwd(q, k, v, o, do, lse, res, **kw)
                torch.cuda.synchronize()
                where = f"K2 long shape {dname} lens={set_name} rate={rate}"
                err_o = close_or_raise(where + " o", o, fa.packed_attention_reference(
                    q, k, v, causal=False, **kw), TOL[dname])
                ref = fa.packed_attention_bwd_reference(q, k, v, do, causal=False, **kw)
                err_g = max(close_or_raise(f"{where} d{n}", a, b, GRAD_TOL[dname])
                            for n, a, b in zip("qkv", grads, ref))
                for key, err in ((f"{fwd.name}/{dname}/rate={rate}", err_o),
                                 (f"{bwd.name}/{dname}/rate={rate}", err_g)):
                    worst[key] = max(worst.get(key, 0.0), err)
                checks += 1
                del o, lse, grads, ref
                torch.cuda.empty_cache()

        lens_list = lens_sets["long_batch"]
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=lens)
        o, lse, res = fwd(q, k, v, for_backward=True, **kw)
        heads = [x.view(B, T, H, Dh).transpose(1, 2).contiguous().requires_grad_(True)
                 for x in (q, k, v)]
        do_h = do.view(B, T, H, Dh).transpose(1, 2).contiguous()
        mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]

        def sdpa_fwd(p=0.0):
            return F.scaled_dot_product_attention(*heads, attn_mask=mask, scale=Dh ** -0.5,
                                                  dropout_p=p)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), heads, do_h)

        drop = dict(kw, dropout_rate=RATE, seed=3001)
        timings[(fwd.name, dname, "long")] = timed_row(
            attention_bound(B, T, H, Dh, dname, False, lens_list),
            graph_time_ms(lambda: fwd(q, k, v, **kw)),
            ms_for_backward=graph_time_ms(lambda: fwd(q, k, v, for_backward=True, **kw)),
            **profiled_kernels(lambda: fwd(q, k, v, **kw), 1),
            **dropout_readings(lambda grad: fwd(q, k, v, for_backward=grad, **drop),
                               lambda: sdpa_fwd(RATE)),
            max_abs_err=worst[f"{fwd.name}/{dname}/rate=0.0"],
            plain_ms=cuda_time_ms(lambda: fa.packed_attention_reference(
                q, k, v, causal=False, **kw), iters=3),
            library_ms=graph_time_ms(sdpa_fwd))
        timings[(bwd.name, dname, "long")] = timed_row(
            attention_bound(B, T, H, Dh, dname, False, lens_list, backward=True),
            graph_time_ms(lambda: bwd(q, k, v, o, do, lse, res, **kw)),
            **profiled_kernels(lambda: bwd(q, k, v, o, do, lse, res, **kw), 2),
            **backward_rate_readings(
                lambda: fwd(q, k, v, for_backward=True, **drop),
                lambda o, lse, res: bwd(q, k, v, o, do, lse, res, **drop)),
            max_abs_err=worst[f"{bwd.name}/{dname}/rate=0.0"],
            plain_ms=cuda_time_ms(lambda: fa.packed_attention_bwd_reference(
                q, k, v, do, causal=False, **kw), iters=3),
            library_ms=library_bwd_ms(sdpa_fwd, sdpa_fwd_bwd))
        del q, k, v, do, o, lse, heads, do_h
        torch.cuda.empty_cache()
    emit({"phase": "kernels_cross_long", "checks": checks,
          "shape": "B=12 T=1408 H=8 Dh=64 non-causal, kv lengths 1408 (the long batch) and "
                   "[T, T-37, T/2, 0]", "rates": [0.0, RATE],
          "tolerance": {"forward": TOL, "grad": GRAD_TOL}, "max_abs_err": worst,
          "times_at_long_batch_lengths": {f"{n}/{d}": r for (n, d, _), r in timings.items()}})
    return timings


def phase_kernels_folded():
    """K3 (the packed kernels on the folded (B*H, T, Dh) view) against the
    plain version, folded against packed bit for bit at rate 0.1, then the
    times at B=32, T=512, H=8, Dh=64 and the launches of one
    ``fused_attention`` forward and backward."""
    import torch
    import torch.nn.functional as F

    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(5)
    worst, checks, H = {}, 0, 8
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for Dh in (64, 128):
            for T in (128, 432, 512, 848):
                B = 4
                q, k, v, do = (torch.randn(B, H, T, Dh, generator=gen).to(dev, dtype)
                               for _ in range(4))
                fold = lambda x: x.reshape(B * H, T, Dh)
                pack = lambda x: x.transpose(1, 2).reshape(B, T, H * Dh).contiguous()
                for rate in (0.0, RATE):
                    kw = dict(num_heads=1, scale=Dh ** -0.5, dropout_rate=rate,
                              seed=2000 + T if rate else None)
                    o, lse, res = fa.folded_attention_fwd(fold(q), fold(k), fold(v),
                                                          for_backward=True, **kw)
                    grads = fa.folded_attention_bwd(fold(q), fold(k), fold(v), o, fold(do),
                                                    lse, res, **kw)
                    again = fa.folded_attention_bwd(fold(q), fold(k), fold(v), o, fold(do),
                                                    lse, res, **kw)
                    torch.cuda.synchronize()
                    where = f"folded {dname} T={T} Dh={Dh} rate={rate}"
                    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                        raise AssertionError(f"{where}: two backward calls differ")
                    err_o = close_or_raise(where + " o", o, fa.packed_attention_reference(
                        fold(q), fold(k), fold(v), causal=True, **kw), TOL[dname])
                    ref = fa.packed_attention_bwd_reference(fold(q), fold(k), fold(v), fold(do),
                                                            causal=True, **kw)
                    err_g = max(close_or_raise(f"{where} d{n}", a, b, GRAD_TOL[dname])
                                for n, a, b in zip("qkv", grads, ref))
                    for key, err in ((f"fwd/{dname}/rate={rate}", err_o),
                                     (f"bwd/{dname}/rate={rate}", err_g)):
                        worst[key] = max(worst.get(key, 0.0), err)
                    if rate:
                        pkw = dict(kw, num_heads=H)
                        o_p, lse_p, res_p = fa.packed_attention_causal(
                            pack(q), pack(k), pack(v), for_backward=True, **pkw)
                        grads_p = fa.packed_attention_bwd_causal(
                            pack(q), pack(k), pack(v), o_p, pack(do), lse_p, res_p, **pkw)
                        unfold = lambda x: pack(x.view(B, H, T, Dh))
                        if not (torch.equal(unfold(o), o_p) and all(
                                torch.equal(unfold(a), b) for a, b in zip(grads, grads_p))):
                            raise AssertionError(f"{where}: folded and packed kernels differ")
                    checks += 1
    emit({"phase": "kernels_folded", "checks": checks,
          "shapes": "B=4 H=8; Dh{64,128} x T{128,432,512,848}", "rates": [0.0, RATE],
          "folded_equals_packed_bitwise_at_rate": RATE, "bwd_two_calls_bitwise_equal": True,
          "tolerance": {"forward": TOL, "grad": GRAD_TOL}, "max_abs_err": worst})

    B, T, H, Dh = 32, 512, 8, 64
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn(B * H, T, Dh, generator=gen).to(dev, dtype) for _ in range(4))
        kw = dict(num_heads=1, scale=Dh ** -0.5)
        o, lse, res = fa.folded_attention_fwd(q, k, v, for_backward=True, **kw)
        err_o = close_or_raise(f"folded fwd {dname} B=32 T=512", o, fa.packed_attention_reference(
            q, k, v, causal=True, **kw), TOL[dname])
        grads = fa.folded_attention_bwd(q, k, v, o, do, lse, res, **kw)
        ref = fa.packed_attention_bwd_reference(q, k, v, do, causal=True, **kw)
        err_g = max(close_or_raise(f"folded bwd {dname} d{n}", a, b, GRAD_TOL[dname])
                    for n, a, b in zip("qkv", grads, ref))
        heads = [x.view(B, H, T, Dh).clone().requires_grad_(True) for x in (q, k, v)]

        def sdpa_fwd(p=0.0):
            return F.scaled_dot_product_attention(*heads, is_causal=True, scale=Dh ** -0.5,
                                                  dropout_p=p)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), heads, do.view(B, H, T, Dh))

        drop = dict(kw, dropout_rate=RATE, seed=2001)

        timings[("folded_attention_fwd", dname)] = timed_row(
            attention_bound(B, T, H, Dh, dname, True),
            graph_time_ms(lambda: fa.folded_attention_fwd(q, k, v, **kw)), max_abs_err=err_o,
            **profiled_kernels(lambda: fa.folded_attention_fwd(q, k, v, **kw), 1),
            ms_for_backward=graph_time_ms(
                lambda: fa.folded_attention_fwd(q, k, v, for_backward=True, **kw)),
            **dropout_readings(
                lambda grad: fa.folded_attention_fwd(q, k, v, for_backward=grad, **drop),
                lambda: sdpa_fwd(RATE)),
            plain_ms=cuda_time_ms(lambda: fa.packed_attention_reference(
                q, k, v, causal=True, **kw), iters=5),
            library_ms=graph_time_ms(sdpa_fwd))
        timings[("folded_attention_bwd", dname)] = timed_row(
            attention_bound(B, T, H, Dh, dname, True, backward=True),
            graph_time_ms(lambda: fa.folded_attention_bwd(q, k, v, o, do, lse, res, **kw)),
            **profiled_kernels(lambda: fa.folded_attention_bwd(q, k, v, o, do, lse, res, **kw),
                               2),
            **backward_rate_readings(
                lambda: fa.folded_attention_fwd(q, k, v, for_backward=True, **drop),
                lambda o, lse, res: fa.folded_attention_bwd(q, k, v, o, do, lse, res, **drop)),
            max_abs_err=err_g,
            plain_ms=cuda_time_ms(lambda: fa.packed_attention_bwd_reference(
                q, k, v, do, causal=True, **kw), iters=5),
            library_ms=library_bwd_ms(sdpa_fwd, sdpa_fwd_bwd))
    emit({"phase": "kernel_times_folded", "shape": "B=32 T=512 H=8 Dh=64 causal",
          "times": {f"{n}/{d}": r for (n, d), r in timings.items()}})

    # the main path of this phase: one fused_attention forward and backward
    x = [t.view(B, H, T, Dh).clone().requires_grad_(True) for t in (q, k, v)]
    for kern in fa.FOLDED_KERNELS:
        kern.launches = 0
    out = fa.fused_attention(*x, scale=Dh ** -0.5, dropout_rate=RATE, seed=9)
    torch.autograd.grad(out, x, do.view(B, H, T, Dh))
    torch.cuda.synchronize()
    counts = {kern.name: kern.launches for kern in fa.FOLDED_KERNELS}
    if any(c != 1 for c in counts.values()):
        raise AssertionError(f"fused_attention launched {counts}, expected one each")
    return timings, counts


def phase_forward():
    import torch

    from kokoro_tpu_torch.cli.profile_paths import teacher_forced_batch
    from kokoro_tpu_torch.config import KokoroConfig
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    cfg = KokoroConfig()  # full width: hidden 512, 6+6 layers, 8 heads, ff 1536, vocab 59
    plain = KokoroModel(cfg).init_weights(torch.Generator().manual_seed(0))
    kernel_cfg = KokoroConfig(use_flash_attention=True)
    fused = KokoroModel(kernel_cfg)
    fused.load_state_dict(plain.state_dict())
    B, T, L = 16, 512, 128
    batch = teacher_forced_batch(cfg, B, T, L, dev)
    valid = ~batch["mel_padding_mask"]
    n_layers = cfg.n_decoder_layers
    results = {}
    counts = {}  # dtype -> kernel -> launches in that dtype's main-path forward
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        m_plain = plain.to(dev, dtype).eval()
        m_fused = fused.to(dev, dtype).eval()
        inputs = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in batch.items()}
        with torch.no_grad():
            zero_counts()  # the main path's run: counts from 0
            out_k = m_fused(**inputs)
            torch.cuda.synchronize()
            counts[dname] = read_counts()
            for kern in all_kernels():  # no gradient: the backward kernels stay idle
                expected = n_layers if kern in fa.FWD_KERNELS else 0
                if counts[dname][kern.name] != expected:
                    raise AssertionError(f"{kern.name}: {counts[dname][kern.name]} launches "
                                         f"in one forward, expected {expected}")
            out_p = m_plain(**inputs)
            for key in ("predicted_mel", "predicted_stop_logits"):
                if not torch.isfinite(out_k[key]).all():
                    raise AssertionError(f"{key} not finite on the kernel path ({dname})")
            mel_diff = (out_k["predicted_mel"] - out_p["predicted_mel"]).float().abs()[valid].max().item()
            stop_diff = (out_k["predicted_stop_logits"] - out_p["predicted_stop_logits"]).float().abs()[valid].max().item()
            mel_max = out_p["predicted_mel"].float().abs()[valid].max().item()
            ms_k = cuda_time_ms(lambda: m_fused(**inputs), iters=5, warmup=1)
            ms_p = cuda_time_ms(lambda: m_plain(**inputs), iters=5, warmup=1)
        limit = FORWARD_LIMIT[dname]
        if max(mel_diff, stop_diff) > limit:
            raise AssertionError(f"kernel path differs from plain path ({dname}): "
                                 f"mel {mel_diff}, stop {stop_diff} > {limit}")
        results[dname] = {"mel_max_abs_diff": mel_diff, "stop_max_abs_diff": stop_diff,
                          "mel_max_abs": mel_max, "limit": limit,
                          "forward_ms_kernel_path": ms_k,
                          "forward_ms_plain_path": ms_p}
    emit({"phase": "forward", "B": B, "T": T, "L": L, "launches_per_forward": n_layers,
          "results": results})
    del plain, fused
    torch.cuda.empty_cache()
    return counts


def phase_serve():
    import torch

    from kokoro_tpu_torch.config import KokoroConfig
    from kokoro_tpu_torch.convert import model_metadata, save_model_dir
    from kokoro_tpu_torch.data.phonemes import RussianPhonemeProcessor
    from kokoro_tpu_torch.ops import fused_attention as fa
    from kokoro_tpu_torch.serving import ServeConfig, TTSServer

    max_len = 400
    cfg = KokoroConfig()
    from kokoro_tpu_torch.models.kokoro import KokoroModel

    model = KokoroModel(cfg).init_weights(torch.Generator().manual_seed(0))
    model_dir = save_model_dir(
        ROOT / "kokoro_tpu_torch" / "build" / "smoke_model", model.state_dict(),
        model_metadata(cfg), RussianPhonemeProcessor().to_dict(),
        {"max_seq_length": max_len, "stop_token_threshold": 0.5,
         "post_expected_stop_threshold": 0.2},
    )
    del model
    profile_dir = Path(tempfile.mkdtemp(prefix="serve_profile_"))
    server = TTSServer.for_model(
        str(model_dir), device="cuda", max_len=max_len,
        vocoder_path=str(ROOT / "docs" / "hifigan_v1_int8.npz"),
        config=ServeConfig(host="127.0.0.1", port=0, max_batch_delay_ms=500.0),
        request_timeout_s=600.0, profile_dir=str(profile_dir),
    )
    tts = server.tts
    if tts.vocoder.vocoder_type != "hifigan":
        raise AssertionError("the committed HiFi-GAN weights did not load")
    buckets = [server.pipeline.encode(t)[0] for t in SERVE_TEXTS]
    if len(set(buckets)) != 2 or buckets.count(buckets[0]) != 4:
        raise AssertionError(f"texts do not fall in two buckets of 4 + 1: {buckets}")
    server.start()
    launches0 = sum(read_counts().values())

    def post(text, path="/tts", payload=None):
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=600)
        conn.request("POST", path, body=json.dumps(payload or {"text": text}).encode("utf-8"),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        frames = (resp.getheader("X-Mel-Frames"), resp.getheader("X-Generated-Frames"))
        return resp.status, body, frames, time.perf_counter() - t0

    try:
        t_all = time.perf_counter()
        with ThreadPoolExecutor(len(SERVE_TEXTS)) as pool:
            answers = list(pool.map(post, SERVE_TEXTS))
        wall = time.perf_counter() - t_all
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        # then POST /profile: a one-second trace with a request running under it
        with ThreadPoolExecutor(2) as pool:
            traced = pool.submit(post, None, "/profile", {"seconds": 1})
            time.sleep(0.2)
            under_trace = post(SERVE_TEXTS[0])
            profile_status, profile_body = traced.result()[:2]
    finally:
        server.stop()
    traces = list(profile_dir.glob("*.pt.trace.json"))
    if profile_status != 200 or under_trace[0] != 200 or not traces:
        raise AssertionError(f"POST /profile: HTTP {profile_status} {profile_body[:200]!r}, "
                             f"/tts under it HTTP {under_trace[0]}, {len(traces)} trace files")
    profile = {"status": profile_status, **trace_events(traces[0])}
    shutil.rmtree(profile_dir)
    if not profile["device_events"]:
        raise AssertionError(f"POST /profile traced no device work: {profile}")
    requests = []
    for text, (status, body, (frames, generated), latency) in zip(SERVE_TEXTS, answers):
        if status != 200 or body[:4] != b"RIFF" or body[8:12] != b"WAVE":
            raise AssertionError(f"bad answer for {text!r}: HTTP {status} {body[:80]!r}")
        with wave.open(BytesIO(body)) as w:
            n = w.getnframes()
            rate = w.getframerate()
            samples = w.readframes(n)
        # the pipeline's own counts: frames vocoded (after the trailing-silence
        # trim) and frames the AR decode generated
        frames, generated = int(frames), int(generated)
        if not 0 < n == frames * 256 or not frames <= generated <= max_len:
            raise AssertionError(f"{n} samples for {frames} vocoded / {generated} generated "
                                 f"frames: not frames x 256 with frames <= generated <= {max_len}")
        pcm = memoryview(samples).cast("h")
        if max(abs(x) for x in pcm) == 0:
            raise AssertionError("silent waveform")
        audio_s = n / rate
        requests.append({"text": text, "frames": frames, "generated_frames": generated,
                         "audio_s": audio_s,
                         "latency_s": latency, "rtf": latency / audio_s})
    if stats["dispatches"] >= stats["requests"]:
        raise AssertionError(f"no coalescing: {stats['dispatches']} dispatches for "
                             f"{stats['requests']} requests")
    total_audio = sum(r["audio_s"] for r in requests)
    emit({"phase": "serve", "requests": requests, "wall_s": wall,
          "aggregate_rtf": wall / total_audio, "stats": stats, "profile": profile,
          "kernel_launches": sum(read_counts().values()) - launches0})


# kernel path against plain path, full-width f32 training.  Each tensor's
# gradient at the init, the per-step loss and gradient norm over 3 steps, and
# what the 3 steps moved the parameters (d = after - init; Adam moves a
# weight by about lr whatever its gradient's size, so raw values say little),
# each as |kernel - plain| / |plain|, per tensor ("leaf") and over all
# tensors.  Limits from the readings on the H100 (PERF.md), sound run / the
# planted dK below: grad leaf 7.9e-4 / 4.7e-3, grad all 9.4e-5 / 1.2e-4,
# moved leaf at most 1.3e-2 / 2.3e-2, moved all at most 1.9e-3 / 2.4e-3.
# The gradient per tensor catches the planted fault; the moved-parameter
# limits catch an update that is missed (reads 1) or wrong-signed (reads 2)
TRAIN_LIMIT = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "grad_leaf_rel": 2e-3,
               "grad_all_rel": 3e-4, "moved_leaf_rel": 3e-2, "moved_all_rel": 5e-3}
# the bf16 long step at Dh 256, kernel path against plain path, one step from
# one init (phase long (d)): about 2.5x the readings on the H100, which the
# Dh 64 kernels of the same step read alike (Dh 256 / Dh 64: loss 3.6e-6 /
# 2.8e-6, gradient over all tensors 3.9e-3 / 4.0e-3, worst tensor 4.1e-2 /
# 4.2e-2, mel_projection_in.weight; PERF.md)
BF16_STEP_LIMIT = {"loss_rel": 1e-5, "grad_all_rel": 1e-2, "grad_leaf_rel": 1e-1}
# the control: the causal backward's dK plus Gaussian noise of this share of
# its RMS, which the limits must catch
PLANTED_DK_NOISE = 1e-2


class PlantedDk:
    """A backward wrapper whose dK carries seeded noise (the control)."""

    def __init__(self, kernel):
        self.kernel, self.calls = kernel, 0

    def __call__(self, *args, **kwargs):
        import torch

        dq, dk, dv = self.kernel(*args, **kwargs)
        gen = torch.Generator(device=dk.device).manual_seed(self.calls)
        self.calls += 1
        noise = torch.randn(dk.shape, generator=gen, device=dk.device)
        rms = dk.float().pow(2).mean().sqrt()
        return dq, (dk.float() + PLANTED_DK_NOISE * rms * noise).to(dk.dtype), dv


def relative_gap(ref, other):
    """Per tensor and over all tensors, |other - ref| / |ref|: (the worst
    tensor's value, its name, the value over all tensors)."""
    if set(ref) != set(other):
        raise AssertionError(f"different tensors: {sorted(set(ref) ^ set(other))}")
    worst, name, diff2, size2 = 0.0, None, 0.0, 0.0
    for n, r in ref.items():
        diff, size = (other[n] - r).norm().item(), r.norm().item()
        leaf = diff / size if size > 0 else (0.0 if diff == 0 else math.inf)
        if name is None or leaf > worst:
            worst, name = leaf, n
        diff2, size2 = diff2 + diff * diff, size2 + size * size
    return worst, name, math.sqrt(diff2 / size2)


def all_kernels():
    """Every kernel wrapper of the port: packed K1/K2 forward and backward,
    folded K3 forward and backward, flash K4 forward and backward."""
    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import fused_attention as fa

    return fa.KERNELS + fl.KERNELS


def zero_counts():
    for kern in all_kernels():
        kern.launches = 0


def read_counts():
    return {kern.name: kern.launches for kern in all_kernels()}


def train_parity(B, L, T, planted_module, planted_attr, **model_overrides):
    """Kernel path against plain path at full width in f32 (TF32 off, every
    dropout rate 0, SpecAugment off), 3 steps from one init, and the control
    with seeded noise planted on ``planted_module.planted_attr``'s dK;
    ``model_overrides`` go to ``KokoroConfig`` (phase long: ``n_heads=2``).
    Returns the readings, with each wrapper's launches in the kernel path's
    first forward and backward (one step's); raises when the sound run breaks
    a limit or the planted one breaks none."""
    import torch

    from kokoro_tpu_torch.cli.profile_paths import training_batch
    from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.models.rng import Rng
    from kokoro_tpu_torch.ops import fused_attention as fa
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import (
        create_train_state, make_loss_fn, make_train_step,
    )

    dev = torch.device("cuda")
    no_dropout = dict(encoder_dropout=0.0, decoder_dropout=0.0, decoder_input_dropout=0.0,
                      variance_dropout=0.0, use_stochastic_depth=False)
    cfg = TrainingConfig(compute_dtype="float32", gradient_checkpointing=False,
                         use_spec_augment=False, warmup_steps=2)
    init = KokoroModel(KokoroConfig(**no_dropout, **model_overrides)).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    batch = training_batch(KokoroConfig(), B, T, L, dev)
    paths, step_launches = {}, None
    for name, flash in (("kernel", True), ("plain", False), ("planted_dk", True)):
        model = KokoroModel(KokoroConfig(**no_dropout, **model_overrides,
                                         use_flash_attention=flash))
        model.load_state_dict(init)
        state = create_train_state(model.to(dev), cfg, total_steps=20000)
        step = make_train_step(cfg, build_preclip_norms(state.names, cfg), spec_augment=False)
        params = dict(model.named_parameters())
        launches0 = sum(read_counts().values())
        real_bwd = getattr(planted_module, planted_attr)
        if name == "planted_dk":
            setattr(planted_module, planted_attr, PlantedDk(real_bwd))
        try:
            counts0 = read_counts()
            total, _ = make_loss_fn(model, cfg, spec_augment=False)(
                batch, Rng.from_generator(torch.Generator().manual_seed(0)))
            grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
            grads = {n: g for n, g in zip(params, grads) if g is not None}
            if name == "kernel":
                step_launches = {k: c - counts0[k] for k, c in read_counts().items()}
            metrics = [step(state, batch, torch.Generator().manual_seed(i)) for i in range(3)]
        finally:
            setattr(planted_module, planted_attr, real_bwd)
        torch.cuda.synchronize()
        launched = sum(read_counts().values()) - launches0
        if (launched == 0) == flash:
            raise AssertionError(f"{name} path launched {launched} kernels")
        moved = {n: p.detach() - init[n].to(dev) for n, p in params.items()}
        paths[name] = (metrics, grads, moved)
        del model, state, step, params, total
        torch.cuda.empty_cache()
    mp, gp, dp = paths["plain"]
    parity = {}
    for name in ("kernel", "planted_dk"):
        mk, gk, dk = paths[name]
        grad_leaf, grad_name, grad_all = relative_gap(gp, gk)
        moved_leaf, moved_name, moved_all = relative_gap(dp, dk)
        parity[name] = {
            "loss_rel": max(abs(a["total"] - b["total"]) / abs(b["total"])
                            for a, b in zip(mk, mp)),
            "grad_norm_rel": max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                                 for a, b in zip(mk, mp)),
            "grad_leaf_rel": grad_leaf, "worst_grad": grad_name, "grad_all_rel": grad_all,
            "moved_leaf_rel": moved_leaf, "worst_moved": moved_name,
            "moved_all_rel": moved_all, "stepped": [m["stepped"] for m in mk]}
    result = {"steps": 3, "B": B, "L": L, "T": T, "planted": planted_attr,
              "model_overrides": model_overrides, "launches_per_step": step_launches,
              "limits": TRAIN_LIMIT, **parity,
              "plain_path": [{k: m[k] for k in ("total", "grad_norm", "stepped")} for m in mp]}
    del paths, gp, dp, gk, dk
    torch.cuda.empty_cache()
    sound, planted = parity["kernel"], parity["planted_dk"]
    if not all(m["stepped"] == 1.0 for m in mp) or sound["stepped"] != [1.0] * 3 or any(
            sound[k] > TRAIN_LIMIT[k] for k in TRAIN_LIMIT):
        raise AssertionError(f"kernel path and plain path training disagree: {result}")
    if all(planted[k] <= TRAIN_LIMIT[k] for k in TRAIN_LIMIT):
        raise AssertionError(f"the parity limits do not catch a planted dK fault: {result}")
    return result


def phase_train():
    """(a) kernel path vs plain path, f32, 3 steps; (b) the throughput preset
    in bf16, 2 warm-up + 10 timed steps.  Returns the launches of each kernel
    wrapper in the last timed step (the main path's run)."""
    import torch

    from kokoro_tpu_torch.cli.profile_paths import preset_train_step
    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    B, L, T = 32, 96, 512
    emit({"phase": "train_parity", **train_parity(B, L, T, fa, "packed_attention_bwd_causal")})

    # (b) the preset
    state, step, batch = preset_train_step(dev)
    n_layers = state.model.config.n_decoder_layers
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, per_step = [], []
    t0 = time.perf_counter()
    for _ in range(10):
        zero_counts()  # each step is a main-path run: counts from 0
        steps.append(step(state, batch, gen))
        per_step.append(read_counts())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 10
    packed = {kern.name for kern in fa.FWD_KERNELS + fa.BWD_KERNELS}
    for m, counts in zip(steps, per_step):
        if not (all(math.isfinite(m[k]) for k in ("total", "grad_norm")) and m["stepped"] == 1.0):
            raise AssertionError(f"preset step not finite or skipped: {m}")
        if any(c != (n_layers if name in packed else 0) for name, c in counts.items()):
            raise AssertionError(f"launches per step {counts}, expected {n_layers} for each "
                                 f"packed wrapper and 0 for the others")
    emit({"phase": "train", "preset": "get_high_performance_config (bf16 compute, f32 params, "
          "attention dropout in the kernels, SpecAugment, no remat)",
          "B": B, "L": L, "T": T, "timed_steps": 10, "ms_per_step": ms,
          "mel_frames_per_s": B * T / (ms / 1e3),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches_per_step": per_step[-1],
          "losses": [m["total"] for m in steps], "grad_norms": [m["grad_norm"] for m in steps]})
    MEASURED_PEAKS["train"] = torch.cuda.max_memory_allocated()
    del state, step
    torch.cuda.empty_cache()
    return per_step[-1]


def build_long_corpus(root, n_utts: int, seed: int = 11) -> None:
    """The long-mode synthetic corpus of the quality run
    (``kokoro_tpu_torch.scripts.quality_run.build_corpus(long_mode=True)``,
    the reference's bytes): 18-30 Russian words per utterance, padded to
    16.34 s, so every utterance lands in the 1408-frame bucket."""
    from kokoro_tpu_torch.scripts.quality_run import build_corpus

    build_corpus(Path(root), n_utts, seed=seed, long_mode=True)


def recording_trainer():
    """The quality run's recorder (``quality_run.recording_trainer``) with
    fresh records: returns the ``KokoroTrainer`` subclass, its step records
    (metrics, kernel launches, microbatches, synchronised ms, logged step)
    and its validation records (launches, batches)."""
    from kokoro_tpu_torch.scripts import quality_run

    steps, validations = [], []
    return quality_run.recording_trainer([], steps, validations), steps, validations


def check_long_run(steps, validations, n_layers: int) -> None:
    """Every long-regime trainer step finite, taken and stabilised, K4 and K2
    forward and backward launched once per decoder layer per microbatch and
    no other kernel; each validation K4 and K2 forward once per decoder layer
    per batch."""
    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import fused_attention as fa

    flash = {kern.name for kern in fl.KERNELS}
    cross = {fa.packed_attention_kvlen.name, fa.packed_attention_bwd_kvlen.name}
    for s in steps:
        metrics, counts = s["metrics"], s["launches"]
        if not (metrics["stepped"] == 1.0 and all(
                math.isfinite(metrics[k]) for k in ("total", "grad_norm"))):
            raise AssertionError(f"long trainer step not finite or skipped: {metrics}")
        if not metrics["loss_scale"] < 1.0:
            raise AssertionError(f"stabilization not live at 1408 frames: {metrics}")
        want = {name: n_layers * s["microbatches"] for name in flash | cross}
        if counts != want:
            raise AssertionError(f"long step launches {counts}, expected {want}")
    for v in validations:
        want = {name: n_layers * v["batches"] for name in (fl.flash_attention_fwd.name,
                                                           fa.packed_attention_kvlen.name)}
        if v["launches"] != want:
            raise AssertionError(f"validation launches {v['launches']}, expected {want}")


def phase_long():
    """The long-utterance regime at full width: (a) the trainer over a
    synthetic corpus, one epoch, then a second after a resume; (b) kernel
    path against plain path of the long step in f32, with a planted K4 dK
    control; (c) the bf16 long step's throughput.  Returns the launches of
    each wrapper in the last timed step."""
    import numpy as np
    import torch

    from kokoro_tpu_torch.cli.profile_paths import LONG_REGIME, LONG_SHAPE, long_train_step
    from kokoro_tpu_torch.config import get_default_config
    from kokoro_tpu_torch.inference.tts import KokoroTTS
    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    n_layers = 6
    flash = {kern.name for kern in fl.KERNELS}
    cross = {fa.packed_attention_kvlen.name, fa.packed_attention_bwd_kvlen.name}
    Recording, steps, validations = recording_trainer()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        build_long_corpus(root / "corpus", 26)
        epochs = 2

        def config(num_epochs):
            return get_default_config(**{
                **LONG_REGIME, "data_dir": str(root / "corpus"), "output_dir": str(root / "run"),
                "num_epochs": num_epochs, "save_every": 1, "keep_checkpoints": 50,
                "warmup_steps": min(200, epochs * 10), "resume_checkpoint": "auto"})

        first = Recording(*config(1), device="cuda")
        first.train()
        step_at_break = first.state.opt_step
        del first
        torch.cuda.empty_cache()
        second = Recording(*config(epochs), device="cuda")
        second.train()
        resumed_from = second.start_epoch
        final_step, skipped = second.state.opt_step, second.state.skipped_steps
        n_train, n_val = len(second.train_dataset), len(second.val_dataset)
        del second
        torch.cuda.empty_cache()
        trainer_s = time.perf_counter() - t0
        tts = KokoroTTS(str(root / "run"), device="cuda", max_len=200,
                        vocoder_path=str(ROOT / "docs" / "hifigan_v1_int8.npz"))
        audio = tts.text_to_speech("Привет, мир! Сегодня хорошая погода.")
        del tts
    check_long_run(steps, validations, n_layers)
    if not (final_step > step_at_break > 0 and resumed_from == 1 and skipped == 0):
        raise AssertionError(f"resume did not continue: {step_at_break} -> {final_step}, "
                             f"resumed at epoch {resumed_from}, {skipped} skipped")
    if not (audio.size > 0 and np.isfinite(audio).all()):
        raise AssertionError("the trained run directory did not synthesise finite audio")
    emit({"phase": "long_trainer", "utterances": {"train": n_train, "val": n_val},
          "epochs": epochs, "resume_after_epoch": 1, "opt_step_at_break": step_at_break,
          "opt_step_final": final_step, "skipped_steps": skipped,
          "steps": [{"total": s["metrics"]["total"], "grad_norm": s["metrics"]["grad_norm"],
                     "loss_scale": s["metrics"]["loss_scale"], "microbatches": s["microbatches"],
                     "ms": s["ms"], "launches": s["launches"]} for s in steps],
          "validation_launches": [v["launches"] for v in validations],
          "tts_audio_s": audio.size / 22050, "wall_s": trainer_s})

    # (b) kernel path against plain path of the long step, f32
    emit({"phase": "long_parity", **train_parity(4, LONG_SHAPE["L"], LONG_SHAPE["T"], fl,
                                                 "flash_attention_bwd")})

    # (c) throughput of the bf16 long step
    state, step, batch = long_train_step(dev)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for _ in range(10):
        zero_counts()  # each step is a main-path run: counts from 0
        metrics.append(step(state, batch, gen))
        per_step.append(read_counts())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 10
    for m, counts in zip(metrics, per_step):
        if not (m["stepped"] == 1.0 and math.isfinite(m["total"]) and m["loss_scale"] < 1.0):
            raise AssertionError(f"long step not finite, skipped or unstabilised: {m}")
        want = {name: (n_layers if name in flash | cross else 0) for name in counts}
        if counts != want:
            raise AssertionError(f"long step launches {counts}, expected {want}")
    B, T = LONG_SHAPE["B"], LONG_SHAPE["T"]
    emit({"phase": "long", "config": "scripts/quality_run.py --long through get_default_config "
          "(bf16 compute, f32 params, no attention-weight dropout, SpecAugment, no remat)",
          **LONG_SHAPE, "timed_steps": 10, "ms_per_step": ms,
          "mel_frames_per_s": B * T / (ms / 1e3),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches_per_step": per_step[-1], "loss_scale": metrics[-1]["loss_scale"],
          "losses": [m["total"] for m in metrics]})
    MEASURED_PEAKS["long"] = torch.cuda.max_memory_allocated()
    del state, step, batch
    torch.cuda.empty_cache()

    # (d) K4 at head dim 256, (e) at head dim 512 (the cluster kernels), (f)
    # at head dim 1536 (a cluster of 12 CTAs, larger than the portable 8),
    # (g) at head dim 2560 (the scores in device memory)
    dh256, dh256_counts = long_head_dim(n_layers, LONG_DH256, timed_steps=5)
    emit({"phase": "long_dh256", **dh256})
    dh512, dh512_counts = long_head_dim(n_layers, LONG_DH512, timed_steps=3)
    emit({"phase": "long_dh512", **dh512})
    dh1536, dh1536_counts = long_head_dim(n_layers, LONG_DH1536, timed_steps=3)
    emit({"phase": "long_dh1536", **dh1536})
    dh2560, dh2560_counts = long_head_dim(n_layers, LONG_DH2560, timed_steps=3)
    emit({"phase": "long_dh2560", **dh2560})
    return per_step[-1], dh256_counts, dh512_counts, dh1536_counts, dh2560_counts


# phase long at head dims 256 and 512: the flagship's hidden 512 over 2 heads
# and at one head (its parameter count), where K4 takes the decoder
# self-attention and the packed kernels' gate (Dh 64 and 128) leaves the
# cross-attention on einsum; at Dh 512 K4 runs its cluster kernels; and the
# model widened to hidden 1536 at one head (Dh 1536: K4 over clusters of 12
# CTAs), as the JAX package's config takes it, and to hidden 2560 at one
# head (Dh 2560: K4 with the scores in device memory)
LONG_DH256 = dict(n_heads=2)
LONG_DH512 = dict(n_heads=1)
LONG_DH1536 = dict(hidden_dim=1536, n_heads=1)
LONG_DH2560 = dict(hidden_dim=2560, n_heads=1)


def bf16_step_gap(dev, overrides: dict, f32_loss: bool = False) -> dict:
    """One bf16 forward and backward of the long regime (B=12, L=256,
    T=1408; every dropout rate 0, SpecAugment off) at the model fields
    ``overrides`` (``n_heads``, and ``hidden_dim`` where it is not 512) from
    one init, kernel path against plain path: the loss's relative gap, the
    gradient's over all tensors and its worst tensor's, and each wrapper's
    launches on the kernel path.  With ``f32_loss``, also the plain path's
    loss in f32 from the same init and each bf16 path's relative distance to
    it."""
    import torch

    from kokoro_tpu_torch.cli.profile_paths import LONG_REGIME, LONG_SHAPE, training_batch
    from kokoro_tpu_torch.config import get_default_config
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.models.rng import Rng
    from kokoro_tpu_torch.training.train_step import DTYPES, make_loss_fn

    B, L, T = LONG_SHAPE["B"], LONG_SHAPE["L"], LONG_SHAPE["T"]
    init = None
    readings, launches = {}, None
    paths = [("kernel", True, None), ("plain", False, None)]
    if f32_loss:
        paths.append(("plain_f32", False, "float32"))
    for name, flash, dtype in paths:
        model_cfg, train_cfg = get_default_config(**{
            **LONG_REGIME, **NO_DROPOUT, **overrides, "use_flash_attention": flash})
        model = KokoroModel(model_cfg)
        if init is None:
            init = model.init_weights(torch.Generator().manual_seed(0)).state_dict()
        model.load_state_dict(init)
        # f32 parameters computing in bf16, as create_train_state sets them
        model.to(dev, DTYPES[train_cfg.param_dtype]).set_compute_dtype(
            DTYPES[dtype or train_cfg.compute_dtype])
        batch = training_batch(model_cfg, B, T, L, dev)
        params = dict(model.named_parameters())
        zero_counts()
        with torch.set_grad_enabled(dtype is None):
            total, _ = make_loss_fn(model, train_cfg, spec_augment=False)(
                batch, Rng.from_generator(torch.Generator().manual_seed(0)))
        grads = (torch.autograd.grad(total, list(params.values()), allow_unused=True)
                 if dtype is None else ())
        torch.cuda.synchronize()
        if flash:
            launches = read_counts()
        readings[name] = (total.item(), {n: g.float() for n, g in zip(params, grads)
                                         if g is not None})
        del model, params, total, grads
        torch.cuda.empty_cache()
    (loss_k, grads_k), (loss_p, grads_p) = readings["kernel"], readings["plain"]
    leaf, leaf_name, all_rel = relative_gap(grads_p, grads_k)
    if not (math.isfinite(loss_k) and all(torch.isfinite(g).all() for g in grads_k.values())):
        raise AssertionError(f"bf16 long step at {overrides}: not finite")
    out = {"hidden_dim": model_cfg.hidden_dim, "n_heads": model_cfg.n_heads,
           "head_dim": model_cfg.hidden_dim // model_cfg.n_heads,
           "compute_dtype": train_cfg.compute_dtype,
           "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
           "grad_all_rel": all_rel, "grad_leaf_rel": leaf, "worst_grad": leaf_name,
           "launches": launches}
    if f32_loss:
        loss_f = readings["plain_f32"][0]
        out.update(loss_plain_f32=loss_f,
                   kernel_to_f32_rel=abs(loss_k - loss_f) / abs(loss_f),
                   plain_to_f32_rel=abs(loss_p - loss_f) / abs(loss_f))
    return out


def long_head_dim(n_layers: int, overrides: dict, timed_steps: int):
    """The long regime at ``overrides`` (``LONG_DH256``: Dh 256;
    ``LONG_DH512``: Dh 512; ``LONG_DH1536``: hidden 1536 at one head, Dh
    1536; ``LONG_DH2560``: hidden 2560 at one head, Dh 2560).  (a) f32: ``train_parity`` (kernel path against
    plain path, 3 steps, the planted dK control on K4), K4 forward and
    backward once per decoder layer in the kernel path's step and no other
    wrapper.  (b) bf16: one step from one init, kernel path against plain
    path (at Dh 256 beside the same at the flagship's 8 heads, Dh 64, the
    kernels before these head dims); K4 as in (a).  (c) The bf16 long step's
    time: 2 warm-up and ``timed_steps`` timed steps, K4 forward and backward
    6 a step.  Returns the readings and the launches of the last timed step."""
    import torch

    from kokoro_tpu_torch.cli.profile_paths import LONG_SHAPE, long_train_step
    from kokoro_tpu_torch.ops import flash_attention as fl

    dev = torch.device("cuda")
    n_heads, hidden = overrides["n_heads"], overrides.get("hidden_dim", 512)
    Dh = hidden // n_heads
    flash = {kern.name for kern in fl.KERNELS}
    want = lambda counts: {name: (n_layers if name in flash else 0) for name in counts}
    f32 = train_parity(4, LONG_SHAPE["L"], LONG_SHAPE["T"], fl, "flash_attention_bwd",
                       **overrides)
    if f32["launches_per_step"] != want(f32["launches_per_step"]):
        raise AssertionError(f"f32 long step at Dh {Dh} launches {f32['launches_per_step']}")
    key = f"Dh={Dh}"
    one_head = n_heads == 1
    bf16 = {key: bf16_step_gap(dev, overrides, f32_loss=one_head)}
    if Dh == 256:
        bf16["Dh=64"] = bf16_step_gap(dev, dict(n_heads=8))
    if bf16[key]["launches"] != want(bf16[key]["launches"]):
        raise AssertionError(f"bf16 long step at Dh {Dh} launches {bf16[key]['launches']}")
    gap = bf16[key]
    over = {k: gap[k] for k in BF16_STEP_LIMIT if gap[k] > BF16_STEP_LIMIT[k]}
    if one_head:
        # at one head the loss moves with the bf16 rounding of the attention
        # output about 10x as much as at 2 or 8 heads (PERF.md section 6,
        # scripts/probe_flash_cluster.py), so the loss is held to the f32
        # path: the kernel path no farther from it than the plain path,
        # within the same limit
        over.pop("loss_rel", None)
        if gap["kernel_to_f32_rel"] > gap["plain_to_f32_rel"] + BF16_STEP_LIMIT["loss_rel"]:
            over["kernel_to_f32_rel"] = gap["kernel_to_f32_rel"]
    if over:
        raise AssertionError(f"bf16 long step at Dh {Dh}: kernel path against plain path {over} "
                             f"past {BF16_STEP_LIMIT}: {bf16}")

    state, step, batch = long_train_step(dev, **overrides)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        zero_counts()  # each step is a main-path run: counts from 0
        metrics.append(step(state, batch, gen))
        per_step.append(read_counts())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / timed_steps
    for m, counts in zip(metrics, per_step):
        if not (m["stepped"] == 1.0 and math.isfinite(m["total"])):
            raise AssertionError(f"long step at Dh {Dh} not finite or skipped: {m}")
        if counts != want(counts):
            raise AssertionError(f"long step at Dh {Dh} launches {counts}, expected {want(counts)}")
    peak = torch.cuda.max_memory_allocated()
    del state, step, batch
    torch.cuda.empty_cache()
    return {"model": f"hidden {hidden}, {n_layers}+{n_layers} layers, ff 1536, "
                     f"n_heads {n_heads} (head_dim {Dh})", **LONG_SHAPE,
            "f32_parity": f32, "bf16_step": bf16, "bf16_limits": BF16_STEP_LIMIT,
            "bf16_step_ms": ms, "timed_steps": timed_steps, "peak_memory_gb": peak / 1e9,
            "launches_per_step": per_step[-1],
            "losses": [m["total"] for m in metrics]}, per_step[-1]


GEMINATE_WORD = "суббота"  # its G2P gives b b: the TextGrids' geminate bː


def trace_events(path: Path) -> dict:
    """Events of a ``torch.profiler`` Chrome trace: all of them, and those of
    the device (kernels and copies)."""
    events = json.loads(path.read_text()).get("traceEvents", [])
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return {"bytes": path.stat().st_size, "events": len(events), "device_events": len(device)}


def write_alignments(corpus: Path, align: Path, seed: int = 23) -> dict:
    """One TextGrid per utterance of ``corpus``, as ``mfa align`` would write
    it: the utterance's G2P phones in MFA's inventory (about half the phones
    that ``MFA_PHONE_MAP`` renames through its inverse, iotated vowels split
    into j + vowel, the doubled phone as one geminate ``Xː``, the first
    word's first three phones as one ``spn`` span, a pause per inter-word
    ``<sil>``, leading and trailing ``sil``), over durations from a seeded
    generator that sum to the wav's mel frames, each interval at least 2
    frames.  Returns ``{stem: G2P phone sequence}``."""
    import wave

    import numpy as np

    from kokoro_tpu_torch.data import mfa
    from kokoro_tpu_torch.data.phonemes import RussianPhonemeProcessor
    from kokoro_tpu_torch.data.text_utils import flatten_with_sil

    processor, inverse = RussianPhonemeProcessor(), {v: k for k, v in mfa.MFA_PHONE_MAP.items()}
    rng = np.random.default_rng(seed)
    hop_s = 256 / 22050
    align.mkdir(parents=True, exist_ok=True)
    sequences = {}
    for line in (corpus / "metadata.csv").read_text(encoding="utf-8").splitlines():
        stem, text = line.split("|")
        seq = flatten_with_sil(processor.process_text(text), processor.phoneme_to_id)
        labels, floors, j = ["sil"], [2], 0
        while j < len(seq):
            p = seq[j]
            if j == 0:
                labels.append("spn")
                floors.append(6)
                j += 3
                continue
            if j + 1 < len(seq) and seq[j + 1] == p and p != "<sil>":
                labels.append(p + mfa.LENGTH_MARK)
                floors.append(4)
                j += 2
                continue
            if p == "<sil>":
                labels.append("")
            elif p in mfa.IOTATED:
                labels += ["j", mfa.IOTATED[p]]
                floors.append(2)
            else:
                labels.append(inverse[p] if p in inverse and rng.random() < 0.5 else p)
            floors.append(2)
            j += 1
        labels.append("")
        floors.append(2)
        with wave.open(str(corpus / "wavs" / f"{stem}.wav")) as w:
            frames = min(w.getnframes() // 256 + 1, 1408)
        counts = np.asarray(floors) + rng.multinomial(
            frames - sum(floors), rng.dirichlet(np.ones(len(floors))))
        edges = np.concatenate([[0], np.cumsum(counts)]) * hop_s
        mfa.write_textgrid(align / f"{stem}.TextGrid",
                           [(float(edges[i]), float(edges[i + 1]), lab)
                            for i, lab in enumerate(labels)])
        sequences[stem] = seq
    return sequences


def phase_mfa():
    """The MFA-supervised training data path and kokoro-infer on the card:
    alignments of the long corpus checked by ``cli.preprocess
    --validate-only``, the native aligner against the Python DP, the feature
    cache filled on the card, one epoch of the long regime on the aligned
    durations, a resume that purges the log past the restored step, and
    ``cli.infer`` on the run directory.  Returns the launches of each kernel
    wrapper in the last training step."""
    import contextlib
    import io

    import numpy as np
    import torch

    from kokoro_tpu_torch.cli import infer, preprocess
    from kokoro_tpu_torch.cli.precompute import precompute_features
    from kokoro_tpu_torch.cli.profile_paths import LONG_REGIME
    from kokoro_tpu_torch.config import get_default_config
    from kokoro_tpu_torch.convert import hifigan_state_dict_from_flax
    from kokoro_tpu_torch.data import audio_io, mfa
    from kokoro_tpu_torch.data.dataset import build_fallback_durations
    from kokoro_tpu_torch.inference.vocoder import VocoderManager, load_hifigan_npz
    from kokoro_tpu_torch.native import binding

    n_layers = 6
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, out = root / "corpus", root / "mfa_output"
        build_long_corpus(corpus, 26)
        meta = corpus / "metadata.csv"
        meta.write_text("\n".join(f"{ln} {GEMINATE_WORD}" for ln in
                                  meta.read_text(encoding="utf-8").splitlines()),
                        encoding="utf-8")
        sequences = write_alignments(corpus, out / "alignments")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = preprocess.main(["--corpus", str(corpus), "--output", str(out),
                                  "--validate-only"])
        report = json.loads(printed.getvalue().strip().splitlines()[-1])
        if rc != 0 or report["alignment_rate"] != 1.0 or report["aligned_files"] != 26:
            raise AssertionError(f"preprocess --validate-only: rc {rc}, {report}")

        # the native aligner against the Python DP, utterance by utterance
        integ = mfa.MFAIntegration(alignment_dir=str(out / "alignments"))
        calls, native_s, python_s, expected = binding.calls, 0.0, 0.0, {}
        for stem, seq in sequences.items():
            flat = integ.aligned_phones(stem)
            t = time.perf_counter()
            native = mfa.align_durations(flat, seq)
            native_s += time.perf_counter() - t
            t = time.perf_counter()
            python = mfa.align_durations(flat, seq, use_native=False)
            python_s += time.perf_counter() - t
            if native != python or len(native) != len(seq):
                raise AssertionError(f"{stem}: native aligner {native} != Python DP {python}")
            if min(native) < 1:
                raise AssertionError(f"{stem}: a phone got no frames: {native}")
            expected[stem] = np.asarray(native, np.int64)
        if binding.calls != calls + len(sequences) or not binding.library_path().is_file():
            raise AssertionError("the native aligner was not the one used")
        aligner = {"utterances": len(sequences),
                   "phones_per_utterance": float(np.mean([len(q) for q in sequences.values()])),
                   "native_ms_per_utt": native_s * 1e3 / len(sequences),
                   "python_ms_per_utt": python_s * 1e3 / len(sequences),
                   "library": str(binding.library_path().relative_to(ROOT))}

        def config(num_epochs):
            return get_default_config(**{
                **LONG_REGIME, "data_dir": str(corpus), "output_dir": str(root / "run"),
                "num_epochs": num_epochs, "save_every": 1, "keep_checkpoints": 50,
                "warmup_steps": 20, "resume_checkpoint": "auto", "log_every_steps": 1,
                "use_mfa": True, "mfa_alignment_dir": str(out / "alignments")})

        t = time.perf_counter()
        stats = precompute_features(*config(1), device="cuda")
        precompute_s = time.perf_counter() - t
        if stats["computed"] != 26 or stats["failed"] != 0:
            raise AssertionError(f"precompute on the card: {stats}")

        Recording, steps, validations = recording_trainer()
        seen = []

        class AlignedTrainer(Recording):
            """Checks every item a training batch takes: its durations are
            the aligned ones of its utterance, not the fallback, and sum to
            its mel frames."""

            def _setup_datasets(self):
                super()._setup_datasets()
                get = self.train_dataset.get_features

                def checked(idx, rng):
                    item = get(idx, rng)
                    durs, frames = item["phoneme_durations"], int(item["mel_length"])
                    want = expected[item["audio_file"]].copy()  # the frame sum into the last
                    want[-1] = max(1, want[-1] + frames - want.sum())
                    if not (np.array_equal(durs, want) and durs.sum() == frames
                            and not np.array_equal(durs, build_fallback_durations(
                                len(durs), frames))):
                        raise AssertionError(f"{item['audio_file']}: durations {durs} are "
                                             f"not the aligned {want} over {frames} frames")
                    seen.append(item["audio_file"])
                    return item

                self.train_dataset.get_features = checked

        first = AlignedTrainer(*config(1), device="cuda")
        first.train()
        step_at_break = first.state.opt_step
        train_stems = {smp["audio_file"] for smp in first.train_dataset.samples}
        del first
        torch.cuda.empty_cache()
        # a crash after the last save leaves a record past its step
        logs = root / "run" / "logs" / "metrics.jsonl"
        with open(logs, "a") as f:
            f.write(json.dumps({"tag": "loss/total", "value": 1e9,
                                "step": step_at_break + 1}) + "\n")
        steps_before = len(steps)
        second = AlignedTrainer(*config(2), device="cuda")
        second.train()
        final_step, resumed_from = second.state.opt_step, second.start_epoch
        del second
        torch.cuda.empty_cache()
        check_long_run(steps, validations, n_layers)
        resumed = [s["logged_step"] for s in steps[steps_before:]]
        records = [json.loads(x) for x in logs.read_text().splitlines() if x.strip()]
        if any(r.get("value") == 1e9 for r in records) or not (
                resumed_from == 1 and resumed and resumed[0] == step_at_break + 1
                and final_step > step_at_break > 0):
            raise AssertionError(f"resume: step {step_at_break} -> {final_step}, logged "
                                 f"{resumed}, stale record kept: "
                                 f"{any(r.get('value') == 1e9 for r in records)}")
        totals = [r["step"] for r in records if r.get("tag") == "loss/total"]
        if totals != sorted(set(totals)):
            raise AssertionError(f"loss/total steps not monotonic after the purge: {totals}")
        if set(seen) != train_stems:
            raise AssertionError(f"{len(set(seen))} training utterances checked of "
                                 f"{len(train_stems)}")
        trainer_s = time.perf_counter() - t

        # kokoro-infer on the run directory
        t = time.perf_counter()
        run, wavs = root / "run", root / "wavs"
        npz = ROOT / "docs" / "hifigan_v1_int8.npz"
        params, _ = load_hifigan_npz(npz)
        state = {}
        for name, w in hifigan_state_dict_from_flax(params).items():
            theirs = name.replace(".conv.", ".")
            if theirs.endswith(".weight"):  # weight-normed: g = ||w||, v = w
                prefix = theirs[: -len(".weight")]
                state[prefix + ".weight_g"] = w.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
                state[prefix + ".weight_v"] = w
            else:
                state[theirs] = w
        pth = root / "hifigan_v1.pth"
        torch.save({"generator": state}, pth)
        text_file = root / "lines.txt"
        lines = ["Привет, мир!", "Сегодня хорошая погода.", "Как дела у тебя?"]
        text_file.write_text("\n".join(lines), encoding="utf-8")
        base = ["--model", str(run), "--max-len", "200"]
        text = "Кот спит дома."
        runs = {
            "file_batched": ["--file", str(text_file), "--batched", "--output-dir", str(wavs)],
            "ema": ["--text", text, "--weights", "ema", "--output", str(root / "ema.wav")],
            "model": ["--text", text, "--weights", "model", "--output", str(root / "model.wav")],
            "npz": ["--text", text, "--vocoder-path", str(npz), "--output", str(root / "npz.wav")],
            "pth": ["--text", text, "--vocoder-path", str(pth), "--output", str(root / "pth.wav")],
            # a short traced run: the check needs device events, not a long trace
            "profile": ["--text", text, "--max-len", "16", "--output", str(root / "traced.wav"),
                        "--profile", str(root / "trace")],
        }
        run_s = {}
        for name, argv in runs.items():
            t_run = time.perf_counter()
            if infer.main(base + argv) != 0:
                raise AssertionError(f"cli.infer {name} failed")
            run_s[name] = time.perf_counter() - t_run
        names = sorted(p.name for p in wavs.glob("*.wav"))
        if names != [f"output_{i:04d}.wav" for i in range(len(lines))]:
            raise AssertionError(f"--file --batched wrote {names}")
        audio = {k: audio_io.read_wav(root / f"{k}.wav")[1] for k in ("ema", "model", "npz", "pth")}
        if audio["ema"].shape == audio["model"].shape and np.array_equal(audio["ema"],
                                                                         audio["model"]):
            raise AssertionError("EMA and raw weights gave the same audio")
        pth_err = float(np.abs(audio["pth"] - audio["npz"]).max())
        mel = np.random.default_rng(0).uniform(-9.0, 0.0, (64, 80)).astype(np.float32)
        a = VocoderManager(vocoder_path=str(npz), device="cuda").mel_to_audio(mel)
        b = VocoderManager(vocoder_path=str(pth), device="cuda").mel_to_audio(mel)
        vocoder_err = float(np.abs(a - b).max())
        if audio["pth"].shape != audio["npz"].shape or pth_err > 1e-4 or vocoder_err > 1e-4:
            raise AssertionError(f".pth audio differs from .npz: wav {pth_err}, "
                                 f"vocoder {vocoder_err}")
        traces = list((root / "trace").glob("*.pt.trace.json"))
        if not traces:
            raise AssertionError("--profile wrote no trace")
        trace = trace_events(traces[0])
        if not trace["device_events"]:
            raise AssertionError(f"--profile traced no device work: {trace}")
        infer_s = time.perf_counter() - t
    emit({"phase": "mfa", "alignment_report": report, "aligner": aligner,
          "precompute": stats, "precompute_s": precompute_s,
          "train_utterances": len(train_stems), "opt_step_at_break": step_at_break,
          "opt_step_final": final_step, "resumed_logged_steps": resumed,
          "steps": [{"total": s["metrics"]["total"], "grad_norm": s["metrics"]["grad_norm"],
                     "loss_scale": s["metrics"]["loss_scale"], "microbatches": s["microbatches"],
                     "ms": s["ms"], "launches": s["launches"]} for s in steps],
          "trainer_s": trainer_s,
          "infer": {"wavs": names, "pth_vs_npz_max_abs": {"wav": pth_err, "vocoder": vocoder_err},
                    "ema_vs_model_samples": [len(audio["ema"]), len(audio["model"])],
                    "trace": trace, "run_s": run_s, "wall_s": infer_s},
          "wall_s": time.perf_counter() - t0})
    return steps[-1]["launches"]


# the reference's scalar families (tests/unit/test_observability_tags.py)
SCALAR_FAMILIES = [
    "loss/total", "loss/mel", "loss/duration", "loss/stop", "loss/pitch", "loss/energy",
    "loss/val_total", "loss/val_mel",
    "loss/train_total_epoch", "loss/train_mel_epoch", "loss/train_stop_epoch",
    "loss/val_total_epoch", "loss/val_mel_epoch",
    "stats/grad_norm", "stats/grad_norm_clipped",
    "stats/lr_encoder", "stats/lr_decoder", "stats/lr_decoder_ffn",
    "stats/lr_decoder_attn", "stats/lr_stop_head", "stats/lr_variance_embed",
    "metrics/val_spectral_convergence", "metrics/val_f0_rmse", "metrics/val_mcd",
    "metrics/train_spectral_convergence",
]
SPECTROGRAMS = ("spectrogram/val_predicted", "spectrogram/val_ground_truth",
                "spectrogram/train_predicted", "spectrogram/train_ground_truth")
PLANNER_LIMIT = 0.15  # |estimate / measured allocated peak - 1|


def logged_tags(logdir: Path) -> dict:
    """The tags of a trainer's log by kind (scalars, histograms, images):
    ``metrics.jsonl`` where tensorboard is not installed, else the event
    files."""
    jsonl = logdir / "metrics.jsonl"
    if jsonl.exists():
        tags = {"scalars": set(), "histograms": set(), "images": set()}
        for line in jsonl.read_text().splitlines():
            rec = json.loads(line)
            kind = {"histogram": "histograms", "image": "images"}.get(rec.get("kind"), "scalars")
            tags[kind].add(rec["tag"])
        return tags
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir), size_guidance={"scalars": 0, "histograms": 0,
                                                       "images": 0})
    acc.Reload()
    return {k: set(acc.Tags().get(k, [])) for k in ("scalars", "histograms", "images")}


def attention_kernel_names(path: Path) -> dict:
    """Device kernels of a Chrome trace named for the port's attention
    templates, split by mask policy: ``flash`` (K4) and ``packed`` (K1-K3),
    from the ``FLASH`` template argument, demangled or not."""
    import re

    names = {e.get("name", "") for e in json.loads(path.read_text()).get("traceEvents", [])
             if e.get("cat") == "kernel"}
    out = {"flash": set(), "packed": set()}
    for name in names:
        if "kokoro_attn" not in name:
            continue
        m = re.search(r"<(?:64|128), (true|false)", name) or re.search(r"ILi(?:64|128)ELb([01])",
                                                                       name)
        if m:
            out["flash" if m.group(1) in ("true", "1") else "packed"].add(name)
    return out


def phase_tools():
    """The trainer's tooling on the card (module docstring, phase 12).
    Returns the launches of each kernel wrapper in the last training step."""
    import ast
    import contextlib
    import io
    import logging

    import numpy as np
    import torch

    from kokoro_tpu_torch.cli import plan
    from kokoro_tpu_torch.cli.profile_paths import LONG_REGIME
    from kokoro_tpu_torch.config import get_default_config, get_high_performance_config
    from kokoro_tpu_torch.convert import flax_names
    from kokoro_tpu_torch.inference.vocoder import VocoderManager
    from kokoro_tpu_torch.utils import cache_manager, memory_planner
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import create_train_state, make_train_step
    from kokoro_tpu_torch.utils.profiling import (
        compare_dtype_policies, dtype_ab_batch, profile_dtype_for_config,
    )

    n_layers = 6
    t0 = time.perf_counter()
    log = io.StringIO()
    handler = logging.StreamHandler(log)
    trainer_log = logging.getLogger("kokoro_tpu_torch.training.trainer")
    level = trainer_log.level
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        corpus, run = root / "corpus", root / "run"
        build_long_corpus(corpus, 26)
        Recording, steps, validations = recording_trainer()
        trainer_log.addHandler(handler)
        trainer_log.setLevel(logging.INFO)
        try:
            trainer = Recording(*get_default_config(**{
                **LONG_REGIME, "data_dir": str(corpus), "output_dir": str(run),
                "num_epochs": 1, "warmup_steps": 20, "log_every_steps": 1,
                "histogram_every_steps": 1, "enable_profiling": True, "profile_epoch_start": 0,
                "profile_steps": 2, "enable_interbatch_profiling": True, "verbose": True}),
                device="cuda")
            trainer.train()
        finally:
            trainer_log.removeHandler(handler)
            trainer_log.setLevel(level)
        trainer_s = time.perf_counter() - t0
        check_long_run(steps, validations, n_layers)
        weights = {f"weights/params/{p}" for p in flax_names(trainer.state.model).values()}
        phases = sorted(trainer._interbatch.phases)
        del trainer
        torch.cuda.empty_cache()
        tags = logged_tags(run / "logs")
        missing = sorted(set(SCALAR_FAMILIES) - tags["scalars"]) + sorted(
            set(SPECTROGRAMS) - tags["images"]) + sorted(
            f"val_predictions/{k}" for k in ("log_durations", "pitch", "energy")
            if f"val_predictions/{k}" not in tags["histograms"])
        logged_weights = {t for t in tags["histograms"] if t.startswith("weights/")}
        grads = {t for t in tags["histograms"] if t.startswith("gradients/")}
        if missing or logged_weights != weights or grads != {
                "gradients/" + t[len("weights/"):] for t in weights}:
            raise AssertionError(f"trainer log: missing {missing}, weights/* {len(logged_weights)} "
                                 f"of {len(weights)}, gradients/* {len(grads)}")
        text = log.getvalue()
        lines = {key: sum(key in ln for ln in text.splitlines()) for key in
                 ("HBM plan", "Duration pred @", "interbatch profile:", "Feature cache:")}
        if not all(lines.values()) or phases != ["data", "step"]:
            raise AssertionError(f"trainer log lines {lines}, interbatch phases {phases}")
        traces = list((run / "profiler_logs").glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"profiler window wrote {len(traces)} traces")
        trace = trace_events(traces[0])
        kernels = attention_kernel_names(traces[0])
        if not (trace["device_events"] and kernels["flash"] and kernels["packed"]):
            raise AssertionError(f"profiler trace {trace} names {kernels}")

        # the CLIs on the card
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc_table = plan.main(["--data-dir", str(corpus)])
        table = printed.getvalue()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc_json = plan.main(["--data-dir", str(corpus), "--json"])
        plan_doc = json.loads(printed.getvalue())
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc_cache = cache_manager.main(["--corpus", str(corpus), "--status"])
        cache = ast.literal_eval(printed.getvalue().strip())
        if (rc_table, rc_json, rc_cache) != (0, 0, 0) or "HBM budget" not in table or not (
                plan_doc["buckets"] and plan_doc["hbm_bytes"] > 0) or not (
                cache["exists"] and cache["entries"] == 26 and cache["sampled_corrupt"] == 0):
            raise AssertionError(f"CLIs: plan {rc_table}/{rc_json} {plan_doc.get('hbm_bytes')}, "
                                 f"cache {cache}")
    observability = {
        "trainer_s": trainer_s, "steps": len(steps), "step_ms": [s["ms"] for s in steps],
        "launches_per_step": steps[-1]["launches"],
        "tags": {k: len(v) for k, v in tags.items()}, "log_lines": lines,
        "interbatch_phases": phases, "trace": trace,
        "trace_attention_kernels": {k: sorted(v) for k, v in kernels.items()}}

    # HiFi-GAN V1 with cuDNN TF32 on (torch's default) against off
    voc = VocoderManager(vocoder_path=str(ROOT / "docs" / "hifigan_v1_int8.npz"), device="cuda")
    mels = np.random.default_rng(0).uniform(-9.0, 0.0, (4, 256, 80)).astype(np.float32)
    waves = {}
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        waves[tf32] = voc.mel_to_audio_batch(mels)
    torch.backends.cudnn.allow_tf32 = False
    diff = float(np.abs(waves[True] - waves[False]).max())
    tf32 = {"frames": [4, 256], "max_abs_diff": diff,
            "max_abs_diff_rel_to_peak": diff / float(np.abs(waves[False]).max()),
            "f32_peak": float(np.abs(waves[False]).max()), "test_tolerance": 1e-4}
    if not all(np.isfinite(w).all() for w in waves.values()):
        raise AssertionError("HiFi-GAN waveform not finite")
    del voc

    # the bf16/f32 A/B on the throughput preset (the kernels were built in phase device);
    # the reference's fixed model fields leave the attention on the plain route, so the
    # same A/B on the preset's kernel route runs beside it for comparison
    ab = {}
    zero_counts()
    chosen = profile_dtype_for_config(*get_high_performance_config(), device="cuda", results=ab)
    torch.cuda.synchronize()
    ab_launches = {k: v for k, v in read_counts().items() if v}
    torch.cuda.empty_cache()
    batch = dtype_ab_batch(80, "cuda")

    def kernel_route_step(dtype):
        m, c = get_high_performance_config(compute_dtype=dtype, vocab_size=64)
        state = create_train_state(KokoroModel(m).init_weights(
            torch.Generator().manual_seed(0)).cuda(), c, total_steps=1000)
        step = make_train_step(c, build_preclip_norms(state.names, c), 0.999)
        gen = torch.Generator().manual_seed(0)
        return (lambda: step(state, batch, gen)), ()

    zero_counts()
    ab_kernels = compare_dtype_policies(kernel_route_step, n_steps=5)
    torch.cuda.synchronize()
    ab_kernels["launches"] = {k: v for k, v in read_counts().items() if v}
    del batch
    torch.cuda.empty_cache()

    # the memory sweep and the planner
    configs = {label: (m, c) for label, m, c, _ in memory_planner.sweep_configs()}

    def rel_err(label, B, T, L, peak):
        m, c = configs[label]
        est = memory_planner.estimate_train_step_hbm(
            m, c, B, T, L, n_params=memory_planner.count_params(m, m.vocab_size))
        return est.total_bytes / peak - 1

    swept = memory_planner.sweep(labels=("preset", "long"))
    held = []
    for r in swept["rows"]:
        err = rel_err(r["config"], r["B"], r["T"], r["L"], r["peak_allocated_bytes"])
        emit({"phase": "tools_sweep", **r, "estimate_rel_err": err})
        held.append((f"sweep {r['config']} B={r['B']} T={r['T']}", err))
    for name, label, shape in (("train", "preset", (32, 512, 96)),
                               ("long", "long", memory_planner.LONG)):
        if name in MEASURED_PEAKS:
            held.append((f"phase {name}", rel_err(label, *shape, MEASURED_PEAKS[name])))
    emit({"phase": "tools", "observability": observability, "tf32_vocoder": tf32,
          "dtype_ab": {"chosen": chosen, "launches": ab_launches, **ab},
          "dtype_ab_kernel_route": ab_kernels,
          "planner": {"limit": PLANNER_LIMIT, "rel_err": dict(held),
                      "total_memory_bytes": swept["total_memory_bytes"]},
          "wall_s": time.perf_counter() - t0})
    worst = max(held, key=lambda x: abs(x[1]))
    if abs(worst[1]) > PLANNER_LIMIT:
        raise AssertionError(f"memory planner off by {worst[1]:+.3f} at {worst[0]}")
    return steps[-1]["launches"]


# ---------------------------------------------------------------------------
# phase quality: the quality run, the analyzer and the audio tool
QUALITY_RUN = ["--epochs", "4", "--utts", "96", "--flash-attention"]
QUALITY_TEXT = "Привет, мир! Сегодня хорошая погода."
QUALITY_SHAPE = (12, 384, 8)  # (B, T, H) of a full microbatch: max_batch_size, the bucket


def mixed_lengths(B: int, T: int) -> list:
    """kv lengths of B rows mixing full, short, one-frame and empty rows."""
    pattern = [T, T - 4, (3 * T) // 4, T // 2, 1, 0]
    return [pattern[i % len(pattern)] for i in range(B)]


def hold_recorded(recorders, required) -> dict:
    """K1, K2 forward and both packed backwards against their plain versions
    at every (B, T, H) a run called the forwards at, in both dtypes, at rate
    0 and every dropout rate the run used; K2 at the kv lengths the run gave
    it at that shape and at a mixed set (``recording_shapes``).  Fails unless
    every (B, T, H) of ``required`` was called.  Returns the checks, shapes,
    rates, kv lengths and the worst error of each wrapper at each shape and
    dtype."""
    import torch

    from kokoro_tpu_torch.ops import fused_attention as fa

    causal, kvlen = (recorders[kern.name] for kern in fa.FWD_KERNELS)
    shapes = sorted({key[:3] for rec in (causal, kvlen) for key in rec.calls})
    rates = sorted({0.0} | {key[3] for rec in (causal, kvlen) for key in rec.calls})
    if not set(required) <= set(shapes):
        raise AssertionError(f"the run called the packed kernels at {shapes}, "
                             f"not at every shape of {sorted(required)}")
    cases, lens_seen = [], {}
    for B, T, H in shapes:
        runs = []
        for key, lens in kvlen.calls.items():
            if key[:3] == (B, T, H) and lens not in runs:  # None: no padding mask
                runs.append(lens)
        lens_seen[f"B={B} T={T} H={H}"] = runs
        lens_sets = {**{f"run{i}": lens for i, lens in enumerate(runs)},
                     "mixed": mixed_lengths(B, T)}
        cases.append((B, T, H, list(zip(fa.FWD_KERNELS, fa.BWD_KERNELS)), lens_sets))
    worst, readings = {}, {}

    def note(key, err):
        worst[key] = max(worst.get(key, 0.0), err)

    checks = hold_packed(cases, tuple(rates), torch.Generator(device="cpu").manual_seed(9),
                         note, readings)
    torch.cuda.empty_cache()
    return {"checks": checks, "shapes": [list(x) for x in shapes], "Dh": 64, "rates": rates,
            "kv_lengths_seen": lens_seen, "tolerance": {"forward": TOL, "grad": GRAD_TOL},
            "max_abs_err": worst, **readings}


def worst_by_wrapper(held: dict) -> dict:
    """``hold_recorded``'s worst errors folded to ``{wrapper: {dtype: err}}``."""
    errors = {}
    for key, err in held["max_abs_err"].items():
        name, dname = key.split("/")[0], key.split("/")[-1]
        errors.setdefault(name, {})[dname] = max(errors.get(name, {}).get(dname, 0.0), err)
    return errors


def phase_quality(out: Path):
    """The quality run (``kokoro_tpu_torch.scripts.quality_run``) at full
    width in the default regime, the decoder's attention through the packed
    kernels, on 96 synthetic utterances: 4 epochs, the resume break after 2,
    a checkpoint every 2 epochs: every step taken and finite, K1 and K2
    forward launched twice per decoder layer per microbatch (remat), their
    backward once, K3 and K4 never, validation the forwards only; the resume
    continues from the saved step; the mel losses fall.  Then the regression
    analyzer (finite norms, nonzero deltas, no failed finite-weights check)
    and the audio tool (HiFi-GAN, frames x 256 samples) on its run
    directory.  Then K1, K2 and the packed backward against their plain
    versions at the run's shapes and kv lengths (:func:`hold_recorded`).
    The corpus and run directory stay under ``out`` for phase scripts.
    Returns the launches of each wrapper in the run's last step of 2
    microbatches, and each wrapper's worst error per dtype in those checks."""
    import torch

    from kokoro_tpu_torch.data.audio_io import read_wav
    from kokoro_tpu_torch.ops import fused_attention as fa
    from kokoro_tpu_torch.scripts import analyze_training_regression as analyzer
    from kokoro_tpu_torch.scripts import e2e_audio_artifact as audio_tool
    from kokoro_tpu_torch.scripts import quality_run

    n_layers = 6
    forwards = {fa.packed_attention_causal.name, fa.packed_attention_kvlen.name}
    backwards = {fa.packed_attention_bwd_causal.name, fa.packed_attention_bwd_kvlen.name}
    # remat (gradient_checkpointing, on in the default regime) runs each
    # decoder layer's forward again in the backward
    passes = {**{name: 2 for name in forwards}, **{name: 1 for name in backwards}}
    t0 = time.perf_counter()
    with recording_shapes() as recorders:
        zero_counts()  # the main path's run: counts from 0
        run = quality_run.run(quality_run.parse_args([*QUALITY_RUN, "--out", str(out)]))
        torch.cuda.synchronize()
        counts = read_counts()
    run_s = time.perf_counter() - t0
    payload, steps, validations = run["payload"], run["steps"], run["validations"]
    run_dir = run["run_dir"]

    t0 = time.perf_counter()
    report = analyzer.analyze_checkpoints(run_dir)
    metrics = analyzer.analyze_metrics(analyzer.load_scalars(run_dir / "logs"))
    checks = analyzer.build_checklist(report, metrics)
    analyzer_s = time.perf_counter() - t0
    audio = audio_tool.run(audio_tool.parse_args(["--model", str(run_dir),
                                                  "--text", QUALITY_TEXT]))
    sr, wav = read_wav(audio["wav"])

    for s in steps:
        want = {name: n * n_layers * s["microbatches"] for name, n in passes.items()}
        if not (s["metrics"]["stepped"] and math.isfinite(s["metrics"]["total"])
                and s["launches"] == want):
            raise AssertionError(f"quality step not taken, not finite or launches "
                                 f"{s['launches']} (expected {want}): {s}")
    for v in validations:
        want = {name: n_layers * v["batches"] for name in forwards}
        if v["launches"] != want:
            raise AssertionError(f"validation launches {v['launches']}, expected {want}")
    total = {name: sum(s["launches"].get(name, 0) for s in steps)
             + sum(v["launches"].get(name, 0) for v in validations) for name in counts}
    if counts != total:
        raise AssertionError(f"the run launched {counts}, its steps and validations {total}")
    half = payload["resume_break_after_epoch"]
    resumed = [s for s in steps if s["epoch"] == half + 1]
    if not (payload["skipped_steps"] == 0 and payload["resumed_at_step"]
            == payload["resume_continued_from_step"] > 0
            and resumed and resumed[0]["opt_step"] == payload["resumed_at_step"]):
        raise AssertionError(f"the resume did not continue from the saved step: {payload}")
    history = payload["history"]
    if not (history[-1]["train_mel"] < history[0]["train_mel"]
            and history[-1]["val_mel"] < history[0]["val_mel"]):
        raise AssertionError(f"mel loss did not fall: {history}")
    cks = report["checkpoints"]
    if not (len(cks) == 2 and all("error" not in c and math.isfinite(c["total_norm"])
                                  and c["nonfinite_params"] == 0 for c in cks)
            and all(c["total_delta_norm"] and c["total_delta_norm"] > 0 for c in cks[1:])):
        raise AssertionError(f"analyzer report: {cks}")
    finite = [c for c in checks if c["check"] == "finite weights"]
    if not finite or any(c["status"] == "FAIL" for c in finite):
        raise AssertionError(f"analyzer checklist: {checks}")
    health = audio["hifigan"]
    if not (sr == 22050 and wav.size == audio["mel_frames"] * 256 == audio["samples"] > 0
            and health["nonfinite"] == 0
            and all(math.isfinite(v) for v in health.values())):
        raise AssertionError(f"audio tool: {audio}")
    t0 = time.perf_counter()
    held = hold_recorded(recorders, [QUALITY_SHAPE])
    held["wall_s"] = time.perf_counter() - t0
    emit({"phase": "quality", "command": "quality_run " + " ".join(QUALITY_RUN),
          **{k: payload[k] for k in ("corpus", "epochs", "resume_break_after_epoch",
                                     "resume_continued_from_step", "resumed_at_step",
                                     "optimizer_steps", "skipped_steps", "best_val_mel",
                                     "best_val_epoch", "peak_memory_gb", "checkpoint_bytes",
                                     "launches_per_step")},
          "history": [{k: h[k] for k in ("epoch", "step", "train_mel", "val_mel")}
                      for h in history],
          "validation_launches": [v["launches"] for v in validations],
          "run_s": run_s, "analyzer_s": analyzer_s,
          "analyzer": [{k: c.get(k) for k in ("name", "optimizer_step", "total_norm",
                                              "total_delta_norm", "nonfinite_params")}
                       for c in cks],
          "checklist": {c["check"]: c["status"] for c in checks},
          "audio": {k: audio[k] for k in ("mel_frames", "samples", "hifigan",
                                          "warm_latency_s")},
          "kernels_at_quality_shapes": held})
    return (next(s["launches"] for s in reversed(steps) if s["microbatches"] == 2),
            worst_by_wrapper(held))


# ---------------------------------------------------------------------------
# phase vocoder_train: the vocoder's training path (train_hifigan, quantize_hifigan)
VOCODER_STEPS = 300
VOCODER_LIMITS = {"mel_l1_fall": 2 / 3, "mel_l1_delta": 0.01, "max_rel_weight_err": 0.005}


def phase_vocoder_train():
    """``train_hifigan`` at full width (512 channels, batch 8) for
    ``VOCODER_STEPS`` steps on the 48-utterance quality corpus: every logged
    loss finite, the last logged mel L1 at most two thirds of the first;
    the export loads through ``VocoderManager``, and a T-frame mel vocodes to
    T x 256 finite samples; ``quantize_hifigan`` on it within
    ``VOCODER_LIMITS``.  Returns each attention wrapper's launches over the
    run (none: the path has no attention kernel)."""
    import numpy as np
    import torch

    from kokoro_tpu_torch.inference.vocoder import VocoderManager
    from kokoro_tpu_torch.ops.stft import log_mel_spectrogram
    from kokoro_tpu_torch.scripts import quantize_hifigan, train_hifigan
    from kokoro_tpu_torch.data.audio_io import read_wav

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        corpus = out / "corpus"
        zero_counts()  # the vocoder path's run: counts from 0
        train = train_hifigan.run(train_hifigan.parse_args([
            "--steps", str(VOCODER_STEPS), "--channels", "512", "--batch", "8",
            "--corpus", str(corpus), "--out", str(out / "v1.npz"),
            "--metrics", str(out / "train.json")]))
        torch.cuda.synchronize()
        counts = read_counts()
        quant = quantize_hifigan.run(quantize_hifigan.parse_args([
            "--src", str(out / "v1.npz"), "--out", str(out / "v1_int8.npz"),
            "--metrics", str(out / "int8.json"), "--corpus", str(corpus)]))
        voc = VocoderManager(vocoder_type="hifigan", vocoder_path=str(out / "v1.npz"))
        _, audio = read_wav(sorted((corpus / "wavs").glob("*.wav"))[0])
        mel = log_mel_spectrogram(torch.from_numpy(audio), *train_hifigan.MEL_ARGS).numpy()
        wave_out = voc.mel_to_audio(mel)
    history = train["history"]
    losses = [r[k] for r in history for k in ("loss", "mel_l1", "stft_l1")]
    if not (voc.vocoder_type == "hifigan"
            and voc.hifigan.config.upsample_initial_channel == train["channels"]
            and wave_out.shape == (mel.shape[0] * 256,) and np.isfinite(wave_out).all()):
        raise AssertionError(f"the export vocoded {wave_out.shape} from {mel.shape} "
                             f"through {voc.vocoder_type}")
    if not (all(math.isfinite(v) for v in losses) and train["nonfinite_history_rows"] == 0
            and history[-1]["mel_l1"] <= VOCODER_LIMITS["mel_l1_fall"] * history[0]["mel_l1"]):
        raise AssertionError(f"vocoder training did not converge or is not finite: {history}")
    if not (abs(quant["mel_l1_delta"]) <= VOCODER_LIMITS["mel_l1_delta"]
            and quant["max_rel_weight_err"] <= VOCODER_LIMITS["max_rel_weight_err"]):
        raise AssertionError(f"int8 quantization out of its limits {VOCODER_LIMITS}: {quant}")
    if any(counts.values()):
        raise AssertionError(f"the vocoder path launched attention kernels: {counts}")
    emit({"phase": "vocoder_train", "limits": VOCODER_LIMITS,
          **{k: train[k] for k in ("steps", "batch", "segments", "params_m", "train_seconds",
                                   "ms_per_step", "steady_ms_per_step", "step_tflop",
                                   "tf32_bound_ms",
                                   "peak_memory_bytes", "roundtrip_mel_l1", "tf32")},
          "history": [{k: round(r[k], 4) if k != "step" else r[k] for k in r} for r in history],
          "quantize": {k: quant[k] for k in ("segments", "mel_l1_f32", "mel_l1_int8",
                                             "mel_l1_delta", "max_rel_weight_err", "src_mb",
                                             "out_mb")},
          "vocoded": {"frames": int(mel.shape[0]), "samples": int(wave_out.shape[0])}})
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase scripts: the repository's remaining tools on the port, at reduced size
SCRIPTS_SERVING = ["--clients", "4", "--requests", "12"]
SCRIPTS_DECODE = {"streams": (1, 8), "frames": 128}


def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: ``(result, text)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def phase_scripts(quality: Path):
    """Every other ported tool at a reduced size, each failing the phase on
    an error row or a non-zero exit: ``bench_serving`` (4 clients, 12
    requests) on phase quality's run directory under ``quality``,
    ``bench_batched_decode`` (streams 1 and 8, 128 frames),
    ``bench_step_shapes`` (the first two ``CONFIGS_SHORT`` rows),
    ``examples_validation``, the host tools on the quality corpus and
    ``verify_setup``, which must PASS.  K1, K2 and the packed backwards are
    then held to their plain versions at the shapes, rates and kv lengths
    the step-shape rows gave them (:func:`hold_recorded`).  Returns each
    attention wrapper's launches per step of the step-shape rows and each
    wrapper's worst error per dtype in those checks."""
    import torch

    from kokoro_tpu_torch.ops import fused_attention as fa
    from kokoro_tpu_torch.scripts import (
        bench_batched_decode, bench_serving, bench_step_shapes, check_phoneme_coverage,
        check_split_lengths, examples_validation, stochastic_depth_summary, verify_setup,
        warmup_summary,
    )

    dev = torch.device("cuda")
    wall = {}

    def timed_tool(name, fn, *args):
        t0 = time.perf_counter()
        out = quiet(fn, *args)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    serving, _ = timed_tool("bench_serving", bench_serving.run, bench_serving.parse_args(
        ["--model", str(quality / "run"), *SCRIPTS_SERVING]))
    conc = serving["concurrent"]
    if not (conc["requests"] == 12 and 1 <= conc["dispatches"] <= conc["requests"]
            and serving["single_stream_s"] > 0 and conc["p95_s"] >= conc["p50_s"] > 0):
        raise AssertionError(f"bench_serving: {serving}")
    decode, _ = timed_tool("bench_batched_decode", bench_batched_decode.sweep, dev,
                           SCRIPTS_DECODE["streams"], SCRIPTS_DECODE["frames"])
    if [r.get("streams") for r in decode] != list(SCRIPTS_DECODE["streams"]) or any(
            "error" in r for r in decode):
        raise AssertionError(f"bench_batched_decode: {decode}")
    configs = bench_step_shapes.CONFIGS_SHORT[:2]
    with recording_shapes() as recorders:
        zero_counts()  # the step-shape rows: a main-path run, counts from 0
        shapes, _ = timed_tool("bench_step_shapes", bench_step_shapes.sweep, dev, configs)
        counts = read_counts()
    if len(shapes) != len(configs) or any("error" in r for r in shapes):
        raise AssertionError(f"bench_step_shapes: {shapes}")
    packed = {kern.name for kern in fa.FWD_KERNELS + fa.BWD_KERNELS}
    steps = sum(row["steps_taken"] for row in shapes)
    for row in shapes:
        if row["launches_per_step"] != {name: 6 for name in packed}:
            raise AssertionError(f"step-shape row launches {row['launches_per_step']}, "
                                 f"expected 6 of each packed wrapper")
    if counts != {name: 6 * steps * (name in packed) for name in counts}:
        raise AssertionError(f"the sweep launched {counts} over {steps} steps")
    t0 = time.perf_counter()
    held = hold_recorded(recorders, [(B, T, 8) for B, L, T in configs])
    wall["kernels_at_step_shapes"] = time.perf_counter() - t0
    rcs = {}
    rcs["examples_validation"], text = timed_tool("examples_validation",
                                                  examples_validation.main, ["--device", "cuda"])
    if not text.rstrip().endswith("EXAMPLES: PASS"):
        raise AssertionError(f"examples_validation: {text[-500:]}")
    corpus = str(quality / "corpus")
    for name, module, argv in (
            ("check_phoneme_coverage", check_phoneme_coverage, ["--corpus", corpus]),
            ("check_split_lengths", check_split_lengths, ["--corpus", corpus]),
            ("warmup_summary", warmup_summary, []),
            ("stochastic_depth_summary", stochastic_depth_summary, ["--quick-ref"])):
        rcs[name], text = timed_tool(name, module.main, argv)
    rcs["verify_setup"], setup = timed_tool("verify_setup", verify_setup.main,
                                            ["--corpus", corpus])
    if any(rcs.values()) or not setup.rstrip().endswith("RESULT: PASS"):
        raise AssertionError(f"tool exits {rcs}; verify_setup said {setup}")
    emit({"phase": "scripts", "run_dir": "phase quality's (quality_run " + " ".join(QUALITY_RUN)
          + ")", "bench_serving": {"args": " ".join(SCRIPTS_SERVING),
                                   "vocoder": "griffin_lim", **serving},
          "bench_batched_decode": decode, "bench_step_shapes": shapes,
          "kernels_at_step_shapes": held, "exits": rcs,
          "verify_setup": setup.strip().splitlines(), "wall_s": wall})
    torch.cuda.empty_cache()
    return {name: c // steps for name, c in counts.items()}, worst_by_wrapper(held)


# ---------------------------------------------------------------------------
# phase bench: the repository's two headline benchmarks on the port
BENCH_E2E_EPOCHS = 2          # measured end-to-end epochs (the full bench: 6)
BENCH_INFERENCE_FRAMES = 128  # forced decode length (the full bench: 1024)


def phase_bench(out: Path):
    """``kokoro_tpu_torch.bench`` and ``kokoro_tpu_torch.bench_inference``
    through their functions at the flagship widths.  The compute-only phase
    as the reference runs it (B=32, T=512, K=16 steps a call, 2 warm and 4
    timed calls): each packed wrapper 6 launches a step, no other kernel.
    The end-to-end phase on the full 480-utterance corpus under ``out``,
    ``BENCH_E2E_EPOCHS`` measured epochs after the warm one, every step
    recorded (``quality_run.recording_trainer``): taken, finite, each packed
    wrapper 6 launches; ``end_to_end`` > 0.  Then K1, K2 and both packed
    backwards against their plain versions at every (B, T, H) the epochs
    called them at (:func:`hold_recorded`), every shape of the measured
    epochs' census required, at least one of them at a T that is not a
    multiple of 128.  Then ``bench_inference`` at
    ``BENCH_INFERENCE_FRAMES`` frames, streams 1, 8 and 32: every decode at
    the forced length (the bench raises otherwise), the committed HiFi-GAN,
    finite positive rates.  Returns each wrapper's launches per
    compute-only and per end-to-end step, and each packed wrapper's worst
    error per dtype at the end-to-end shapes."""
    import gc
    from unittest import mock

    import torch

    import kokoro_tpu_torch.training.trainer as trainer_module
    from kokoro_tpu_torch import bench, bench_inference
    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    packed = {kern.name for kern in fa.FWD_KERNELS + fa.BWD_KERNELS}
    n_layers = 6
    wall = {}
    failures = []

    t0 = time.perf_counter()
    zero_counts()  # the compute-only run: a main-path run, counts from 0
    value = bench.bench_compute_only(dev)
    counts = read_counts()
    wall["compute_only"] = time.perf_counter() - t0
    steps = (bench.WARM_CALLS + bench.TIMED_CALLS) * bench.K
    compute_per_step = {name: c / steps for name, c in counts.items()}
    if counts != {name: n_layers * steps * (name in packed) for name in counts}:
        failures.append(f"compute-only launched {counts} over {steps} steps")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    Recording, e2e_steps, _ = recording_trainer()
    with recording_shapes() as recorders, mock.patch.object(trainer_module, "KokoroTrainer",
                                                            Recording):
        zero_counts()  # the end-to-end epochs: a main-path run, counts from 0
        e2e = bench.bench_end_to_end(out, dev, measured_epochs=BENCH_E2E_EPOCHS)
        counts = read_counts()
    wall["end_to_end"] = time.perf_counter() - t0
    for s_ in e2e_steps:
        m = s_["metrics"]
        if not (m["stepped"] == 1.0 and math.isfinite(m["total"]) and s_["microbatches"] == 1
                and s_["launches"] == {name: n_layers for name in packed}):
            failures.append(f"end-to-end step {s_}")
    if counts != {name: n_layers * len(e2e_steps) * (name in packed) for name in counts}:
        failures.append(f"end-to-end launched {counts} over {len(e2e_steps)} steps")
    if not (e2e["frames_per_sec"] > 0 and e2e["shape_steps"] and e2e["buckets"] == 9):
        failures.append(f"end-to-end result {e2e}")
    required = sorted({(int(b), int(t), 8) for b, t in (
        key[1:].split("xk")[0].split("xT") for key in e2e["shape_steps"])})
    if not any(t % 128 for _, t, _ in required):
        failures.append(f"no end-to-end shape at a T that is not a multiple of 128: {required}")
    t0 = time.perf_counter()
    held = hold_recorded(recorders, required)
    wall["kernels_at_e2e_shapes"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    synthesis = bench_inference.run(dev, max_frames=BENCH_INFERENCE_FRAMES)
    wall["bench_inference"] = time.perf_counter() - t0
    detail = synthesis["detail"]
    if detail["hifigan_weights"] != "trained (hifigan_v1_int8.npz)":
        failures.append(f"bench_inference vocoded with {detail['hifigan_weights']}")
    blocks = {"batched": 8, "batched_32": 32}
    if not (detail["frames"] == BENCH_INFERENCE_FRAMES and all(
            synthesis[k]["frames_total"] == BENCH_INFERENCE_FRAMES * n for k, n in blocks.items())):
        failures.append(f"bench_inference decode lengths {synthesis}")
    rates = [synthesis["value"], detail["frames_per_s"]] + [
        synthesis[k]["x_realtime_aggregate"] for k in blocks]
    if not all(math.isfinite(r) and r > 0 for r in rates):
        failures.append(f"bench_inference rates {rates}")
    e2e_per_step = {name: c / max(len(e2e_steps), 1) for name, c in counts.items()}
    emit({"phase": "bench",
          "compute_only": {"value": round(value, 1), "unit": "mel-frames/s",
                           "B": bench.B, "L": bench.L, "T": bench.T, "K": bench.K,
                           "launches_per_step": compute_per_step},
          "end_to_end": {**e2e, "measured_epochs": BENCH_E2E_EPOCHS,
                         "steps": len(e2e_steps),
                         "step_ms": [round(s_["ms"], 1) for s_ in e2e_steps],
                         "launches_per_step": e2e_per_step},
          "kernels_at_e2e_shapes": held, "bench_inference": synthesis, "wall_s": wall})
    if failures:
        raise AssertionError("; ".join(failures))
    return compute_per_step, e2e_per_step, worst_by_wrapper(held)


# ---------------------------------------------------------------------------
# phase parallel: data and tensor parallelism (kokoro_tpu_torch/parallel/)
NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, decoder_input_dropout=0.0,
                  variance_dropout=0.0, use_stochastic_depth=False)
# N ranks against the single process.  The reference's own limits
# (tests/unit/test_tensor_parallel.py:196-232, tests/unit/test_parallel.py)
# on each step's losses and on the parameters after the steps; the gradient
# at the init per tensor (|run - single| / |single|); each step's global
# gradient norm (a missing data-group sum reads about 0.5); what the steps
# moved each tensor.  The gradient per tensor is the check of the update: a
# sum missed or taken twice leaves a tensor 0.5-1 off (the control, no
# model-group sum of the q/k/v norm scales' gradients, reads 0.93 on the
# H100).  Sound runs that split rows or heads read 1.5e-4 to 6.2e-4 there,
# the others 4.3e-7 to 1.7e-6; the limit sits 80x above them and 19x below
# the control.  (It was set when the model drew the pitch and energy
# embeddings N(0, 1), not flax's N(0, 1/sqrt(d)): sound runs read 2.8e-3 to
# 5.9e-3 then, the control 0.86.)  The single process against itself is
# printed beside them: with its parameters moved by one ulp it reads what
# the (1, 2) and (2, 2) runs read (1.5e-4; 5.9e-3, what (2,) read, at the
# N(0, 1) embeddings), with its rows reversed 1.9e-6.  So the gap comes from
# rounding in the forward, through the gradient's kinks (a ReLU input that
# crosses zero), not from the parallel layer (PERF.md has the readings)
PARALLEL_LIMIT = {"loss_rel": 1e-5, "param_rtol": 2e-4, "param_atol": 2e-5,
                  "grad_leaf_rel": 5e-2, "grad_norm_rel": 1e-3, "moved_leaf_rel": 0.5}
# the reference's learning rate (warmup 2 steps, its tests' smoke config)
REFERENCE_LR = 5e-5
# a tenth of it.  Adam moves a parameter by about lr times the sign of its
# gradient whatever the gradient's size, so an element whose small gradient
# has opposite signs in the two runs (about 20 of 48 M at (2,); 25 k at the
# N(0, 1) pitch and energy embeddings) moves apart by up to twice the step.
# At this rate the three steps move a parameter by at most 7.6e-6 (the
# largest group's warmup 5e-8, 2.5e-6, 5e-6), so the parameter limit (atol
# 2e-5) cannot fail on the update itself, and the gradient at the init and
# the moved gap carry the comparison.  The runs were held here while the
# model drew those embeddings N(0, 1): (2,) broke the loss and parameter
# limits at REFERENCE_LR by step 3 then
PARALLEL_LR = 5e-6
# the rate each f32 run of phases parallel and parallel_sp_pp is held at.
# At the flax init, each run that splits rows, heads or frames met every
# limit at REFERENCE_LR in five calls on the H100 (parameter excess -1.0e-6
# to -1.7e-5), and is held there.  The ('data', 'stage') runs missed there
# call by call until two nondeterministic sums of the step were made
# deterministic: the length regulator's gather backward (a scatter-add with
# atomics, ops/lengths.py) and the variance predictors' cuDNN convolution
# backward (models/variance.py).  The single process then gives the same
# step bit for bit (the control "single_again_bitwise", a failure if not),
# and (1, 2) ('data', 'stage') meets every limit at REFERENCE_LR (gradient
# gap 7.6e-8), so it is held there.  (2, 2) ('data', 'stage') splits each
# microbatch's rows over two data ranks, so its sums over rows run in
# another order: it misses the parameter limit at REFERENCE_LR by 8.02e-6 at
# variance_adaptor.energy_predictor.conv0.weight, exactly as the single
# process against itself with its parameters moved one ulp does (the control
# "params_one_ulp": 8.02e-6, gradient gap 5.7e-4 against the run's 5.5e-4),
# so it is rounding moved by Adam's sign step, and it stays held at
# PARALLEL_LR.  A run held below REFERENCE_LR is also run there, and that
# reading is printed beside it (its per-tensor gradient gap and the
# parameter element that failed), not held
HELD_LR = {**{tag: REFERENCE_LR for tag in ("2", "1x2", "2x2", "seq_1x2", "seq_2x2",
                                            "seq_model_1x2x2", "stage_1x2")},
           "stage_2x2": PARALLEL_LR}
PARALLEL_TIMEOUT_S = 300  # a world that has not ended by then is killed and fails


def run_rates(tag: str) -> list:
    """``(suffix, lr)`` of each f32 run of ``tag``: ``("", HELD_LR[tag])``,
    and ``("_reference_lr", REFERENCE_LR)`` when that is another rate."""
    held = HELD_LR[tag]
    return [("", held)] + ([("_reference_lr", REFERENCE_LR)] if held != REFERENCE_LR else [])


def run_lrs(tags) -> set:
    """Every rate the f32 runs of ``tags`` take."""
    return {lr for tag in tags for _, lr in run_rates(tag)}
LOCAL_HEADS = (4, 2)      # 8 heads over 2 and 4 model ranks


class HeadRecorder:
    """A kernel wrapper that records the head count of every call, then
    calls the wrapper (whose launch count goes on as before)."""

    def __init__(self, kernel):
        self.kernel, self.heads = kernel, set()

    def __getattr__(self, name):
        return getattr(self.kernel, name)

    def __call__(self, *args, **kwargs):
        self.heads.add(int(kwargs.get("num_heads") or args[0].shape[1]))
        return self.kernel(*args, **kwargs)


class ShapeRecorder(HeadRecorder):
    """A ``HeadRecorder`` of a packed forward wrapper that also keeps, for
    each (B, T, H, dropout rate) it is called at, the kv lengths of the
    first such call (None for the causal wrapper)."""

    def __init__(self, kernel):
        super().__init__(kernel)
        self.calls = {}

    def __call__(self, q, *args, **kwargs):
        key = (q.shape[0], q.shape[1], kwargs["num_heads"],
               float(kwargs.get("dropout_rate") or 0.0))
        if key not in self.calls:
            lens = kwargs.get("kv_lengths")
            self.calls[key] = None if lens is None else lens.tolist()
        return super().__call__(q, *args, **kwargs)


def record_heads():
    """Put a ``HeadRecorder`` in front of the packed and flash wrappers that
    the autograd Functions look up when called; returns them by name."""
    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import fused_attention as fa

    recorders = {}
    for module, attrs in ((fa, ("packed_attention_causal", "packed_attention_kvlen",
                                "packed_attention_bwd_causal", "packed_attention_bwd_kvlen")),
                          (fl, ("flash_attention_fwd", "flash_attention_bwd"))):
        for attr in attrs:
            rec = HeadRecorder(getattr(module, attr))
            setattr(module, attr, rec)
            recorders[rec.name] = rec
    return recorders


@contextlib.contextmanager
def recording_shapes():
    """A ``ShapeRecorder`` in front of each packed forward wrapper, as the
    autograd Function looks them up, for the body of the ``with``; yields
    them by wrapper name."""
    from kokoro_tpu_torch.ops import fused_attention as fa

    attrs = ("packed_attention_causal", "packed_attention_kvlen")
    recorders = {attr: ShapeRecorder(getattr(fa, attr)) for attr in attrs}
    for attr, rec in recorders.items():
        setattr(fa, attr, rec)
    try:
        yield {rec.name: rec for rec in recorders.values()}
    finally:
        for attr, rec in recorders.items():
            setattr(fa, attr, rec.kernel)


def allclose_ratio(out, ref, tol) -> float:
    """The worst ``|out - ref| / (tol + tol * |ref|)`` over the elements:
    what ``close_or_raise``'s ``torch.allclose(rtol=tol, atol=tol)`` decides
    on (it passes at most 1)."""
    diff = (out.double() - ref.double()).abs()
    return (diff / (tol + tol * ref.double().abs())).max().item()


def float64_control(grads, ref, exact, kv_lengths) -> dict:
    """The f32 kernel's and the f32 plain version's gradients (``grads``,
    ``ref``: packed (B, T, H*Dh)) each against the float64 recompute
    ``exact``: the max abs error per gradient, and where the larger one
    sits (batch row, its kv length, the token)."""
    out = {"kernel": {}, "plain_f32": {}}
    worst = (-1.0, None)
    for n, a, b, x in zip(("dq", "dk", "dv"), grads, ref, exact):
        for who, y in (("kernel", a), ("plain_f32", b)):
            diff = (y.double() - x).abs()
            err = diff.max().item()
            out[who][n] = err
            if err > worst[0]:
                flat = int(diff.argmax())
                row, token = divmod(flat // diff.shape[2], diff.shape[1])
                worst = (err, {"carrier": who, "grad": n, "batch_row": row, "token": token,
                               "kv_length": int(kv_lengths[row]), "abs_err": err,
                               "value": x.reshape(-1)[flat].item()})
    out["worst"] = worst[1]
    return out


def hold_packed(cases, rates, gen, note, readings=None) -> int:
    """Hold the packed forward and backward wrappers against their plain
    versions: for each ``(B, T, H, [(fwd, bwd), ...], {name: kv lengths})``
    of ``cases`` (Dh 64), both dtypes and every rate of ``rates``, the
    causal pair once and the kv-length pair at each set of kv lengths, the
    forward to ``TOL`` and dQ, dK, dV to ``GRAD_TOL``; ``note(key, err)``
    gets each error, keyed ``"<wrapper>/T=<T>/H=<H>/<dtype>"``.  With
    ``readings`` (a dict), also each key's worst ``allclose_ratio`` (under
    ``"allclose_ratio"``) and, for the f32 kv-length backward, the kernel
    and the f32 plain version each against the float64 recompute
    (``float64_control``, under ``"f32_kvlen_bwd_vs_float64"`` by key and
    set of kv lengths, the worst of the rates).  Returns the number of
    checks."""
    import torch

    from kokoro_tpu_torch.ops import fused_attention as fa

    dev, Dh, checks = torch.device("cuda"), 64, 0
    ratios = control = None
    if readings is not None:
        ratios = readings.setdefault("allclose_ratio", {})
        control = readings.setdefault("f32_kvlen_bwd_vs_float64", {})

    def hold(key, what, out, ref, tol):
        err = close_or_raise(what, out, ref, tol)
        if ratios is not None:
            ratios[key] = max(ratios.get(key, 0.0), allclose_ratio(out, ref, tol))
        return err

    for B, T, H, pairs, lens_sets in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q, k, v, do = (torch.randn(B, T, H * Dh, generator=gen).to(dev, dtype)
                           for _ in range(4))
            for fwd, bwd in pairs:
                for set_name, lens in ({"causal": None} if fwd.causal else lens_sets).items():
                    lens = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                                  device=dev)
                    for rate in rates:
                        kw = dict(num_heads=H, scale=Dh ** -0.5, kv_lengths=lens,
                                  dropout_rate=rate, seed=4000 + H if rate else None)
                        o, lse, res = fwd(q, k, v, for_backward=True, **kw)
                        grads = bwd(q, k, v, o, do, lse, res, **kw)
                        torch.cuda.synchronize()
                        where = f"{fwd.name} B={B} T={T} H={H} {dname} {set_name} rate={rate}"
                        key = f"{fwd.name}/T={T}/H={H}/{dname}"
                        note(key, hold(key, where, o, fa.packed_attention_reference(
                            q, k, v, causal=fwd.causal, **kw), TOL[dname]))
                        ref = fa.packed_attention_bwd_reference(q, k, v, do, causal=fwd.causal,
                                                                **kw)
                        key = f"{bwd.name}/T={T}/H={H}/{dname}"
                        note(key, max(hold(key, f"{where} d{n}", a, b, GRAD_TOL[dname])
                                      for n, a, b in zip("qkv", grads, ref)))
                        if control is not None and lens is not None and dtype == torch.float32:
                            exact = packed_bwd_float64(q, k, v, do, causal=False, **kw)
                            got = float64_control(grads, ref, exact, lens.tolist())
                            slot = f"{key}/{set_name}"
                            held = control.get(slot)
                            if held is None or got["worst"]["abs_err"] > held["worst"]["abs_err"]:
                                control[slot] = {**got, "rate": rate}
                            del exact
                        checks += 1
                        del o, lse, grads, ref
            del q, k, v, do
    return checks


def parallel_kernels():
    """(a) The kernels at the head counts tensor parallelism gives them and
    at the shapes a rank's main path gives them: K1, K2 and the packed
    backward at B=32, T=512, H = 4 and 2 (Dh 64); K2 and the kv-length
    backward at the (2, 2) trainer's cross-attention shape, B=6 rows a rank,
    T=1408, H=4, with the long batch's kv lengths (every frame valid) and a
    mixed set holding a row of length 0; each in both dtypes at rates 0 and
    0.1 (the packed layout's row stride is H*Dh, which the tensor-core
    templates derive from H).  K4 forward and backward at B=12 and 6,
    T=1408, H=4; the dropout semantics at H = 4 and 2."""
    import torch

    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(6)
    worst, checks, Dh = {}, 0, 64

    def note(key, err):
        worst[key] = max(worst.get(key, 0.0), err)

    # (B, T, H, kernel pairs, kv-length sets): the preset step's rows at
    # tp = 2 and 4, then the (2, 2) trainer's cross-attention rows
    cases = [(32, 512, H, list(zip(fa.FWD_KERNELS, fa.BWD_KERNELS)),
              {"512-8b": [512 - 8 * i for i in range(32)]}) for H in LOCAL_HEADS]
    cases.append((6, 1408, 4, [(fa.packed_attention_kvlen, fa.packed_attention_bwd_kvlen)],
                  {"long_batch": [1408] * 6, "mixed": [1408, 1371, 704, 0, 1408, 1000]}))
    checks += hold_packed(cases, (0.0, RATE), gen, note)
    T, H = 1408, 4  # the long path's decoder self-attention at tp = 2
    for B in (12, 6):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q, k, v, do = (torch.randn(B, H, T, Dh, generator=gen).to(dev, dtype)
                           for _ in range(4))
            kw = dict(causal=True, scale=Dh ** -0.5)
            o, lse = fl.flash_attention_fwd(q, k, v, return_lse=True, **kw)
            grads = fl.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            where = f"flash B={B} H={H} {dname}"
            note(f"flash_attention_fwd/B={B}/H={H}/{dname}", close_or_raise(
                f"{where} o", o, fl.flash_attention_reference(q, k, v, **kw), TOL[dname]))
            ref = fl.flash_attention_bwd_reference(q, k, v, o, do, **kw)
            note(f"flash_attention_bwd/B={B}/H={H}/{dname}", max(
                close_or_raise(f"{where} d{n}", a, b, GRAD_TOL[dname])
                for n, a, b in zip("qkv", grads, ref)))
            checks += 1
            del q, k, v, do, o, lse, grads, ref
    torch.cuda.empty_cache()
    dropout = {H: dropout_semantics(H) for H in LOCAL_HEADS}
    return {"checks": checks, "tolerance": {"forward": TOL, "grad": GRAD_TOL},
            "shapes": "packed B=32 T=512 Dh=64 H{4,2} rates {0, 0.1} kv lengths 512-8b; "
                      "K2 + kv-length bwd B=6 T=1408 H=4 Dh=64 rates {0, 0.1} kv lengths "
                      "1408 and [1408, 1371, 704, 0, 1408, 1000]; "
                      "flash B{12,6} T=1408 H=4 Dh=64 causal",
            "max_abs_err": worst,
            "dropout_semantics": {H: {k: r[k] for k in (
                "keep_rate_abs_err", "surviving_weight_scale_max_rel_err",
                "mask_fwd_bwd_disagreements", "grad_fd_rel_err")} for H, r in dropout.items()}}


def start_world(job: str, world: int, out: Path, backend: str = "gloo"):
    """Start ``job`` in ``world`` spawned ranks, every one on cuda:0 over
    ``backend`` (a file store under ``out``); :func:`join_world` waits."""
    import torch.multiprocessing as mp

    store = out / f"store_{job}"
    ctx = mp.start_processes(parallel_rank, args=(world, str(store), job, str(out), backend),
                             nprocs=world, join=False, start_method="spawn")
    return job, ctx, time.monotonic() + PARALLEL_TIMEOUT_S


def join_world(started) -> None:
    """Wait for a started world: a rank that raises or dies fails the
    phase, and a world not ended within ``PARALLEL_TIMEOUT_S`` of its start
    is killed and fails it."""
    job, ctx, deadline = started
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
            raise AssertionError(f"parallel job {job}: its ranks did not end within "
                                 f"{PARALLEL_TIMEOUT_S} s")


def parallel_rank(rank: int, world: int, store: str, job: str, out: str, backend: str) -> None:
    """One rank of a spawned world: the process group on cuda:0, the job,
    the barrier, the group's end."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kokoro_tpu_torch.parallel.mesh import init_distributed

    init_distributed(device="cuda:0", backend=backend, init_method=f"file://{store}",
                     rank=rank, world_size=world, timeout_s=PARALLEL_TIMEOUT_S)
    try:
        PARALLEL_JOBS[job](rank, Path(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def parallel_batch(dev):
    """B=8, L=96, T=512 of ``training_batch`` with rows of 512 to 256 valid
    frames, so the data ranks hold different numbers of them."""
    import torch

    from kokoro_tpu_torch.cli.profile_paths import training_batch
    from kokoro_tpu_torch.config import KokoroConfig

    batch = training_batch(KokoroConfig(), 8, 512, 96, dev)
    batch["mel_lengths"] = torch.tensor([512, 480, 400, 512, 300, 512, 256, 500],
                                        dtype=torch.int32, device=dev)
    return batch


def f32_steps(mesh=None, skip_partial_sum: bool = False, lr: float = PARALLEL_LR,
              steps: int = 3, perturb: str = "", plain: bool = False,
              microbatches: int = 0) -> dict:
    """(c) ``steps`` f32 steps at full width, every dropout rate 0, at ``lr``
    with a 2-step warmup, on the rank's rows of ``parallel_batch``: the
    gradient at the init (the step's, summed over the ranks as the step sums
    it), the metrics, the whole parameters and gradients (on the CPU), each
    step's launches, host ms and collectives.  ``perturb`` (one process)
    changes what f32 rounding alone changes: ``rows_reversed`` takes the
    batch's rows in reverse order (the gradient's sums over rows run the
    other way), ``params_ulp`` moves every parameter of the init by about
    one ulp (relative 2**-23 times a seeded normal draw).  ``plain`` builds
    the model with ``use_flash_attention=False`` (the route the trainer takes
    under ``seq`` and ``stage``); ``microbatches`` splits the batch's rows
    into that many accumulation microbatches, the pipelined step's under a
    ``stage`` axis."""
    import torch

    from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.parallel.mesh import shard_batch
    from kokoro_tpu_torch.parallel.tp import gather_tree
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import (
        create_train_state, make_train_step, step_gradients,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = TrainingConfig(compute_dtype="float32", gradient_checkpointing=False,
                         use_spec_augment=False, warmup_steps=2, learning_rate=lr)
    model = KokoroModel(KokoroConfig(**NO_DROPOUT, use_flash_attention=not plain)).init_weights(
        torch.Generator().manual_seed(0))
    if perturb == "params_ulp":
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + 2.0 ** -23 * torch.randn(p.shape, generator=gen))
    state = create_train_state(model.to(dev), cfg, total_steps=20000, mesh=mesh)
    if skip_partial_sum:  # the control: the norm scales keep each rank's part
        state.layout.partial = ()
    pipelined = mesh is not None and mesh.pp > 1
    if pipelined:
        from kokoro_tpu_torch.parallel.pp_step import make_pp_train_step as make_train_step
        from kokoro_tpu_torch.parallel.pp_step import pp_step_gradients as step_gradients
    step = make_train_step(cfg, build_preclip_norms(state.names, cfg), spec_augment=False)
    batch = parallel_batch(dev)
    if perturb == "rows_reversed":
        batch = {k: v.flip(0) for k, v in batch.items()}
    if microbatches:
        batch = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])
                 for k, v in batch.items()}
    local = batch if mesh is None else shard_batch(batch, mesh)
    grads = step_gradients(state, local, torch.Generator().manual_seed(0), cfg,
                           spec_augment=False)[0]
    grads = gather_tree(dict(zip(state.names, grads)), state.layout)
    grads = {n: g.cpu() for n, g in grads.items()}
    metrics, launches, ms, collectives = [], [], [], []
    for i in range(steps):
        before = dict(mesh.stats) if mesh is not None else {}
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        metrics.append(step(state, local, torch.Generator().manual_seed(i)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: v for k, v in read_counts().items() if v})
        if mesh is not None:
            collectives.append({k: mesh.stats[k] - before[k] for k in before})
    params = gather_tree({n: p.detach().clone() for n, p in state.params.items()},
                         state.layout)
    return {"metrics": metrics, "params": {n: p.cpu() for n, p in params.items()},
            "grads": grads, "launches": launches, "step_ms": ms, "collectives": collectives}


def job_nccl_step(rank: int, out: Path) -> None:
    """(b) World size 1 on NCCL: the preset step three times unwrapped, then
    through the parallel layer on a (1, 1) ('data', 'model') mesh; every
    all_reduce is the identity, so the two paths must agree bit for bit."""
    import torch

    from kokoro_tpu_torch.cli.profile_paths import preset_train_step
    from kokoro_tpu_torch.config import TrainingConfig
    from kokoro_tpu_torch.parallel.mesh import create_mesh

    dev = torch.device("cuda", 0)
    runs = {}
    for name in ("unwrapped", "mesh_1x1"):
        mesh = (create_mesh(TrainingConfig(mesh_shape=(1, 1), mesh_axis_names=("data", "model")))
                if name == "mesh_1x1" else None)
        state, step, batch = preset_train_step(dev, mesh=mesh)
        gen = torch.Generator().manual_seed(0)
        metrics, ms = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            metrics.append(step(state, batch, gen))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[name] = {
            "metrics": metrics, "step_ms": ms, "launches": {k: v for k, v in read_counts().items()
                                                            if v},
            "stats": None if mesh is None else dict(mesh.stats),
            "tensors": [p.detach().clone() for p in state.model.parameters()]
            + [state.ema[n].clone() for n in state.names] + list(state.optimizer.mu)
            + list(state.optimizer.nu)}
        del state, step, batch
        torch.cuda.empty_cache()

    def same(a, b):
        return a["metrics"] == b["metrics"] and all(
            torch.equal(x, y) for x, y in zip(a["tensors"], b["tensors"]))

    result = {
        "bit_identical": same(runs["unwrapped"], runs["mesh_1x1"]),
        **{name: {k: r[k] for k in ("step_ms", "launches", "stats")}
           for name, r in runs.items()},
        "losses": [m["total"] for m in runs["mesh_1x1"]["metrics"]]}
    (out / "nccl_step.json").write_text(json.dumps(result))


def job_gloo_2(rank: int, out: Path) -> None:
    """(c) At (2,) and (1, 2): three f32 steps at each rate of
    :func:`run_rates`; the control at (1, 2), at (1, 2)'s held rate, without
    the model-group sum of the q/k/v norm scales' gradients."""
    import torch

    from kokoro_tpu_torch.config import TrainingConfig
    from kokoro_tpu_torch.parallel.mesh import create_mesh

    runs = [(tag + suffix, shape, False, lr) for tag, shape in (("2", (2,)), ("1x2", (1, 2)))
            for suffix, lr in run_rates(tag)]
    for tag, shape, control, lr in runs + [("1x2_control", (1, 2), True, HELD_LR["1x2"])]:
        mesh = create_mesh(TrainingConfig(mesh_shape=shape, mesh_axis_names=("data", "model")))
        run = f32_steps(mesh, skip_partial_sum=control, lr=lr)
        if rank == 0:
            torch.save(run, out / f"steps_{tag}.pt")
        del run
        torch.cuda.empty_cache()


def job_gloo_4(rank: int, out: Path) -> None:
    """(c) At (2, 2): three f32 steps.  (d) The trainer at (2, 2) in bf16:
    one epoch of the long regime on the corpus under ``out``; on rank 0 each
    step's launches (counts from 0 just before the step) and the head count
    of every kernel call; rank 0 writes the checkpoint."""
    import torch

    from kokoro_tpu_torch.cli.profile_paths import LONG_REGIME
    from kokoro_tpu_torch.config import TrainingConfig, get_default_config
    from kokoro_tpu_torch.parallel.mesh import create_mesh

    recorders = record_heads()
    mesh = create_mesh(TrainingConfig(mesh_shape=(2, 2), mesh_axis_names=("data", "model")))
    for suffix, lr in run_rates("2x2"):
        run = f32_steps(mesh, lr=lr)
        run["heads"] = {name: sorted(r.heads) for name, r in recorders.items()}
        if rank == 0:
            torch.save(run, out / f"steps_2x2{suffix}.pt")
        del run
        torch.cuda.empty_cache()
    for r in recorders.values():
        r.heads.clear()
    Recording, steps, validations = recording_trainer()

    class MeshRecordingTrainer(Recording):
        collectives = []

        def _train_step(self, spec_augment):
            step = super()._train_step(spec_augment)

            def counted(state, batch, generator):
                before = dict(self.mesh.stats)
                metrics = step(state, batch, generator)
                self.collectives.append({k: self.mesh.stats[k] - before[k] for k in before})
                return metrics

            return counted

    trainer = MeshRecordingTrainer(*get_default_config(**{
        **LONG_REGIME, "data_dir": str(out / "corpus"), "output_dir": str(out / "run_2x2"),
        "num_epochs": 1, "save_every": 1, "warmup_steps": 20, "resume_checkpoint": "",
        "mesh_shape": (2, 2), "mesh_axis_names": ("data", "model")}), device="cuda:0")
    trainer.train()
    if rank == 0:
        (out / "trainer_2x2.json").write_text(json.dumps({
            "dp_size": trainer.dp_size, "tp_size": trainer.tp_size,
            "steps": steps, "validations": validations, "step_ms": [s["ms"] for s in steps],
            "collectives": MeshRecordingTrainer.collectives,
            "heads": {name: sorted(r.heads) for name, r in recorders.items()},
            "opt_step": trainer.state.opt_step}))


PARALLEL_JOBS = {"nccl_step": job_nccl_step, "gloo_2": job_gloo_2, "gloo_4": job_gloo_4}


def sign_flips(ref: dict, other: dict):
    """The elements whose gradient has opposite signs in ``ref`` and
    ``other``: their count, and the largest such |ref| over the RMS of its
    tensor in ``ref``."""
    count, worst = 0, 0.0
    for name, g in ref.items():
        flipped = (g * other[name]) < 0
        if flipped.any():
            count += int(flipped.sum())
            rms = g.pow(2).mean().sqrt().item()
            worst = max(worst, g[flipped].abs().max().item() / max(rms, 1e-30))
    return count, worst


def held_to_single(run: dict, single: dict, init: dict) -> dict:
    """N ranks against the single process: each step's loss and gradient
    norm rel; the gradient at the init per tensor and over all; the worst
    parameter |diff| - (atol + rtol |single|), which the limits want <= 0,
    with that element's gradient at the init in both runs and its tensor's
    gradient RMS; the elements whose gradient at the init has opposite
    signs in the two runs (the largest such |gradient| over its tensor's
    RMS); what the steps moved the parameters from ``init`` (per tensor
    and over all, as phase train)."""
    import torch

    lim = PARALLEL_LIMIT

    def rel(a, b, keys):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in keys)

    pairs = list(zip(run["metrics"], single["metrics"]))
    loss_rel = [rel(a, b, ("total", "mel", "duration", "stop", "pitch", "energy"))
                for a, b in pairs]
    grad_rel = [rel(a, b, ("grad_norm",)) for a, b in pairs]
    grad_leaf, grad_name, grad_all = relative_gap(single["grads"], run["grads"])
    excess, worst = -math.inf, None
    for name, ref in single["params"].items():
        over = ((run["params"][name] - ref).abs()
                - (lim["param_atol"] + lim["param_rtol"] * ref.abs()))
        if over.max().item() > excess:
            excess, worst = over.max().item(), (name, int(over.argmax()))
    flips, flip_max = sign_flips(single["grads"], run["grads"])
    name, i = worst
    g = single["grads"][name]
    worst_element = {
        "name": name, "index": i, "param_single": single["params"][name].flatten()[i].item(),
        "param_run": run["params"][name].flatten()[i].item(),
        "init": init[name].flatten()[i].item(), "grad_single": g.flatten()[i].item(),
        "grad_run": run["grads"][name].flatten()[i].item(),
        "tensor_grad_rms": g.pow(2).mean().sqrt().item()}
    moved_leaf, moved_name, moved_all = relative_gap(
        {n: p - init[n] for n, p in single["params"].items()},
        {n: p - init[n] for n, p in run["params"].items()})
    return {"loss_rel": loss_rel, "grad_norm_rel": grad_rel, "grad_leaf_rel": grad_leaf,
            "worst_grad": grad_name, "grad_all_rel": grad_all, "param_excess": excess,
            "worst_param": worst_element, "grad_sign_flips": flips,
            "grad_sign_flip_max_over_rms": flip_max, "moved_leaf_rel": moved_leaf,
            "worst_moved": moved_name, "moved_all_rel": moved_all,
            "held": (max(loss_rel) <= lim["loss_rel"] and max(grad_rel) <= lim["grad_norm_rel"]
                     and grad_leaf <= lim["grad_leaf_rel"] and excess <= 0.0 and moved_leaf <= lim["moved_leaf_rel"]),
            "stepped": [m["stepped"] for m in run["metrics"]],
            "totals": [m["total"] for m in run["metrics"]]}


def phase_parallel():
    """Data and tensor parallelism on the one card (module docstring, phase
    17).  Returns, per kernel, its launches per step on rank 0 of the
    (2, 2) runs and the head counts it ran at."""
    import subprocess

    import numpy as np
    import torch

    from kokoro_tpu_torch.cli.profile_paths import LONG_REGIME
    from kokoro_tpu_torch.config import KokoroConfig, get_default_config
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import fused_attention as fa

    t0 = time.perf_counter()
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        build_long_corpus(out / "corpus", 26)
        # (b), (c) and (d)'s worlds start together and run beside (a) and the
        # single-process reference: about 50 GB of the card's 80 together;
        # the card and the host's cores are shared, so no host time here is
        # a clean one
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "-m", "kokoro_tpu_torch.cli.train", "--distributed",
               "--data-dir", str(out / "corpus"), "--output-dir", str(out / "run_cli"),
               "--epochs", "1", "--resume", "", "--no-mfa", "--no-speed-perturbation",
               "--flash-attention", "--no-attention-weight-dropout",
               "--no-gradient-checkpointing", "--save-every", "1"]
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, start_new_session=True)
        try:
            started = [start_world("gloo_4", 4, out), start_world("gloo_2", 2, out),
                       start_world("nccl_step", 1, out, backend="nccl")]
            kernels = parallel_kernels()
            walls["a_kernels"] = time.perf_counter() - t0
            singles = {lr: f32_steps(lr=lr) for lr in run_lrs(("2", "1x2", "2x2"))}
            twins = {p: f32_steps(steps=0, perturb=p)["grads"]
                     for p in ("rows_reversed", "params_ulp")}
            torch.cuda.empty_cache()
            for world in started:
                join_world(world)
            _, cli_err = proc.communicate(timeout=max(1.0, PARALLEL_TIMEOUT_S - (
                time.perf_counter() - t0)))
        except BaseException:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
            raise
        cli_meta = out / "run_cli" / "checkpoint_epoch_1" / "metadata.json"
        if proc.returncode != 0 or not cli_meta.exists():
            raise AssertionError(f"kokoro-train --distributed exited {proc.returncode}: "
                                 f"{cli_err[-3000:]}")
        cli = json.loads(cli_meta.read_text())
        nccl = json.loads((out / "nccl_step.json").read_text())
        walls["a_b_c_d_together"] = time.perf_counter() - t0
        init = KokoroModel(KokoroConfig(**NO_DROPOUT)).init_weights(
            torch.Generator().manual_seed(0)).state_dict()
        held = {tag + suffix: held_to_single(torch.load(out / f"steps_{tag}{suffix}.pt"),
                                             singles[lr], init)
                for tag in ("2", "1x2", "2x2") for suffix, lr in run_rates(tag)}
        held["1x2_control"] = held_to_single(torch.load(out / "steps_1x2_control.pt"),
                                             singles[HELD_LR["1x2"]], init)
        single = singles[HELD_LR["2"]]  # the gradient at the init is the same at every rate
        rounding = {}  # the single process against itself, f32 rounding changed
        for p, grads in twins.items():
            rounding[p] = dict(zip(
                ("grad_leaf_rel", "worst_grad", "grad_all_rel", "grad_sign_flips",
                 "grad_sign_flip_max_over_rms"),
                relative_gap(single["grads"], grads) + sign_flips(single["grads"], grads)))
        runs = {tag: torch.load(out / f"steps_{tag}.pt") for tag in ("2", "1x2", "2x2")}
        mesh_trainer = json.loads((out / "trainer_2x2.json").read_text())

        # (d) one process resumes the (2, 2) checkpoint for one more epoch
        t = time.perf_counter()
        Recording, single_steps, _ = recording_trainer()
        single_run = Recording(*get_default_config(**{
            **LONG_REGIME, "data_dir": str(out / "corpus"), "output_dir": str(out / "run_2x2"),
            "num_epochs": 2, "save_every": 1, "warmup_steps": 20, "resume_checkpoint": "auto"}),
            device="cuda")
        single_run.train()
        resumed = {"start_epoch": single_run.start_epoch, "opt_step": single_run.state.opt_step,
                   "metrics": [s["metrics"] for s in single_steps]}
        del single_run
        torch.cuda.empty_cache()
        walls["d_resume"] = time.perf_counter() - t

    n_layers = 6
    flash = {kern.name for kern in fl.KERNELS}
    cross = {fa.packed_attention_kvlen.name, fa.packed_attention_bwd_kvlen.name}
    causal = {fa.packed_attention_causal.name, fa.packed_attention_bwd_causal.name}
    failures = []
    if not nccl["bit_identical"]:
        failures.append(f"world size 1 on NCCL differs from the unwrapped step: {nccl}")
    if not (cli["config"]["distributed_init"] and cli["counters"]["optimizer_step"] > 0):
        failures.append(f"kokoro-train --distributed: {cli['counters']}")
    for tag in ("2", "1x2", "2x2"):
        if not held[tag]["held"] or held[tag]["stepped"] != [1.0] * 3:
            failures.append(f"{tag} against the single process: {held[tag]}")
    if held["1x2_control"]["held"]:
        failures.append(f"the control (no norm-scale gradient sum) held: {held['1x2_control']}")
    for counts in runs["2x2"]["launches"]:  # K1 and K2 per decoder layer at T=512
        want = {n: n_layers for n in causal | cross}
        if counts != want:
            failures.append(f"(2, 2) f32 step launches {counts}, expected {want}")
    if any(runs["2x2"]["heads"][n] != [4] for n in causal | cross):
        failures.append(f"(2, 2) f32 step kernels ran at heads {runs['2x2']['heads']}")
    steps = mesh_trainer["steps"]
    for s_ in steps:
        m, counts = s_["metrics"], s_["launches"]
        want = {name: n_layers * s_["microbatches"] for name in flash | cross}
        if not (m["stepped"] == 1.0 and math.isfinite(m["total"])) or counts != want:
            failures.append(f"(2, 2) trainer step {m} launches {counts}, expected {want}")
    heads = mesh_trainer["heads"]
    if not steps or any(heads[n] != [4] for n in flash | cross):
        failures.append(f"(2, 2) trainer kernels ran at heads {heads}, expected 4")
    if not (resumed["start_epoch"] == 1 and resumed["metrics"]
            and resumed["opt_step"] == mesh_trainer["opt_step"] + len(resumed["metrics"])
            and all(m["stepped"] == 1.0 and math.isfinite(m["total"])
                    for m in resumed["metrics"])):
        failures.append(f"one process resuming the (2, 2) checkpoint: {resumed}")

    def per_step(collectives):
        return {k: float(np.mean([c[k] for c in collectives])) for k in collectives[0]}

    result = {
        "phase": "parallel", "kernels_at_local_heads": kernels,
        "world_1_nccl": {"bit_identical": nccl["bit_identical"],
                         "step_ms": {k: nccl[k]["step_ms"] for k in ("unwrapped", "mesh_1x1")},
                         "mesh_1x1_stats_3_steps": nccl["mesh_1x1"]["stats"],
                         "cli_opt_steps": cli["counters"]["optimizer_step"]},
        "gloo_f32_vs_single": {"limits": PARALLEL_LIMIT,
                               "held_at_lr": {t: HELD_LR[t] for t in ("2", "1x2", "2x2")},
                               "not_held": "runs tagged _reference_lr: readings at "
                                           f"{REFERENCE_LR}", **held,
                               "single_against_itself": rounding,
                               "single_totals": {lr: [m["total"] for m in s_["metrics"]]
                                                 for lr, s_ in singles.items()},
                               "single_step_ms": {lr: s_["step_ms"]
                                                  for lr, s_ in singles.items()},
                               "step_ms_rank0": {t: runs[t]["step_ms"] for t in runs},
                               "collectives_per_step_rank0": {
                                   t: per_step(runs[t]["collectives"]) for t in runs}},
        "trainer_2x2_bf16": {"steps": [{"total": s_["metrics"]["total"],
                                        "grad_norm": s_["metrics"]["grad_norm"],
                                        "microbatches": s_["microbatches"],
                                        "launches": {k: v for k, v in s_["launches"].items()
                                                     if v}} for s_ in steps],
                             "step_ms_rank0": mesh_trainer["step_ms"],
                             "collectives_per_step_rank0": per_step(
                                 mesh_trainer["collectives"]),
                             "heads": heads, "resumed_by_one_process": resumed},
        "note": "ranks share one card over gloo: not a scaling measurement",
        "wall_s": walls}
    emit(result)
    if failures:
        raise AssertionError("; ".join(failures))
    # per kernel: launches per step per rank on its parallel path, and the heads
    launches = dict(runs["2x2"]["launches"][-1])
    launches.update({n: steps[-1]["launches"][n] for n in flash | cross})
    where = {n: "(2, 2) f32 preset-shape step, B=8 T=512 (2 rows a rank)" for n in causal}
    where.update({n: "(2, 2) bf16 long-regime trainer step, 2 microbatches of 6 rows a rank, "
                     "T=1408" for n in flash | cross})
    return {n: {"launches": launches[n], "heads": 4, "launches_are": where[n]}
            for n in causal | cross | flash}


# ---------------------------------------------------------------------------
# phase parallel_sp_pp: sequence and pipeline parallelism (parallel/mesh.py's
# seq axis, parallel/pp.py, parallel/pp_step.py)
# (tag, mesh shape, axis names, accumulation microbatches) of the f32 runs,
# per spawned world
SP_PP_RUNS = {
    "sp_pp_2": [("seq_1x2", (1, 2), ("data", "seq"), 0),
                ("stage_1x2", (1, 2), ("data", "stage"), 2)],
    "sp_pp_4": [("seq_2x2", (2, 2), ("data", "seq"), 0),
                ("seq_model_1x2x2", (1, 2, 2), ("data", "seq", "model"), 0),
                ("stage_2x2", (2, 2), ("data", "stage"), 2)],
}
# the bf16 trainer's meshes on the long corpus (4 ranks)
SP_PP_TRAINERS = [("seq_2x2", ("data", "seq"), {}),
                  ("stage_2x2", ("data", "stage"), {"use_stochastic_depth": False})]
DISABLED_LINE = "use_flash_attention disabled"


def write_peak(out: Path, tag: str) -> None:
    """This rank's peak allocated bytes since the last reset, to a file."""
    import torch
    import torch.distributed as dist

    (out / f"peak_{tag}_{dist.get_rank()}.json").write_text(
        json.dumps(torch.cuda.max_memory_allocated()))
    torch.cuda.reset_peak_memory_stats()


def job_sp_pp_steps(rank: int, out: Path, job: str) -> None:
    """(a) Three f32 steps on each mesh of ``SP_PP_RUNS[job]``: the plain
    attention route (the trainer's under ``seq`` and ``stage``), each rank
    its rows and, under ``seq``, its frames; under ``stage`` 2 microbatches
    through the pipeline (3 of the 6 decoder layers a stage)."""
    import torch

    from kokoro_tpu_torch.config import TrainingConfig
    from kokoro_tpu_torch.parallel.mesh import create_mesh

    for tag, shape, names, micro in SP_PP_RUNS[job]:
        mesh = create_mesh(TrainingConfig(mesh_shape=shape, mesh_axis_names=names))
        for suffix, lr in run_rates(tag):
            torch.cuda.reset_peak_memory_stats()
            run = f32_steps(mesh, plain=True, microbatches=micro, lr=lr)
            write_peak(out, tag + suffix)
            if rank == 0:
                torch.save(run, out / f"steps_{tag}{suffix}.pt")
            del run
            torch.cuda.empty_cache()


def job_sp_pp_2(rank: int, out: Path) -> None:
    job_sp_pp_steps(rank, out, "sp_pp_2")


def job_sp_pp_4(rank: int, out: Path) -> None:
    job_sp_pp_steps(rank, out, "sp_pp_4")


def job_sp_pp_trainer(rank: int, out: Path) -> None:
    """(b) ``KokoroTrainer`` in bf16 on the long corpus under ``out``, one
    epoch at (2, 2) ('data', 'seq'), then one at (2, 2) ('data', 'stage');
    on rank 0 each step's launches (counts from 0 just before the step),
    collectives and ms, and the trainer's log lines; every rank its peak
    allocated bytes."""
    import logging

    import torch

    from kokoro_tpu_torch.cli.profile_paths import LONG_REGIME
    from kokoro_tpu_torch.config import get_default_config

    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    trainer_log = logging.getLogger("kokoro_tpu_torch.training.trainer")
    trainer_log.addHandler(handler)
    trainer_log.setLevel(logging.INFO)
    for tag, names, extra in SP_PP_TRAINERS:
        Recording, steps, validations = recording_trainer()

        class MeshRecordingTrainer(Recording):
            collectives = []

            def _train_step(self, spec_augment):
                step = super()._train_step(spec_augment)

                def counted(state, batch, generator):
                    before = dict(self.mesh.stats)
                    metrics = step(state, batch, generator)
                    self.collectives.append({k: self.mesh.stats[k] - before[k] for k in before})
                    return metrics

                return counted

        lines.clear()
        torch.cuda.reset_peak_memory_stats()
        trainer = MeshRecordingTrainer(*get_default_config(**{
            **LONG_REGIME, **extra, "data_dir": str(out / "corpus"),
            "output_dir": str(out / f"run_{tag}"), "num_epochs": 1, "save_every": 1,
            "warmup_steps": 20, "resume_checkpoint": "", "mesh_shape": (2, 2),
            "mesh_axis_names": names}), device="cuda:0")
        trainer.train()
        write_peak(out, f"trainer_{tag}")
        if rank == 0:
            (out / f"trainer_{tag}.json").write_text(json.dumps({
                "sizes": [trainer.dp_size, trainer.sp_size, trainer.tp_size, trainer.pp_size],
                "use_flash": trainer.state.model.config.use_flash_attention,
                "disabled_line": [x for x in lines if x.startswith(DISABLED_LINE)],
                "steps": steps, "validations": validations,
                "step_ms": [s["ms"] for s in steps],
                "collectives": MeshRecordingTrainer.collectives,
                "opt_step": trainer.state.opt_step}))
        del trainer
        torch.cuda.empty_cache()


PARALLEL_JOBS.update(sp_pp_2=job_sp_pp_2, sp_pp_4=job_sp_pp_4, sp_pp_trainer=job_sp_pp_trainer)


def phase_parallel_sp_pp():
    """Sequence and pipeline parallelism on the one card (module docstring,
    phase 18).  Returns, per kernel, its launches on these paths (0: the
    reference's routing turns the kernels off under ``seq`` and ``stage``)."""
    import subprocess

    import numpy as np
    import torch

    from kokoro_tpu_torch.config import KokoroConfig
    from kokoro_tpu_torch.models.kokoro import KokoroModel

    t0 = time.perf_counter()
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        build_long_corpus(out / "corpus", 26)
        # (c) kokoro-train on 2 processes sharing cuda:0 over gloo
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "kokoro_tpu_torch.cli.train", "--distributed",
               "--dist-backend", "gloo", "--device", "cuda:0", "--mesh-shape", "1,2",
               "--mesh-axes", "data,seq", "--data-dir", str(out / "corpus"),
               "--output-dir", str(out / "run_cli"), "--epochs", "1", "--resume", "",
               "--no-mfa", "--no-speed-perturbation", "--flash-attention",
               "--no-attention-weight-dropout", "--no-gradient-checkpointing", "--save-every",
               "1"]
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, start_new_session=True)
        try:
            started = [start_world("sp_pp_4", 4, out), start_world("sp_pp_2", 2, out)]
            # the single process on the plain route, the batch whole and in 2
            # microbatches, at each rate, beside the worlds
            lrs = run_lrs(tag for runs in SP_PP_RUNS.values() for tag, *_ in runs)
            singles = {(lr, micro): f32_steps(plain=True, lr=lr, microbatches=micro)
                       for lr in lrs | {REFERENCE_LR} for micro in (0, 2)}
            # the controls: the stage runs' single process again, and with
            # its parameters moved one ulp
            controls = {perturb: f32_steps(plain=True, lr=REFERENCE_LR, microbatches=2,
                                           perturb=perturb)
                        for perturb in ("", "params_ulp")}
            torch.cuda.empty_cache()
            for world in started:
                join_world(world)
            walls["a_steps"] = time.perf_counter() - t0
            t = time.perf_counter()
            join_world(start_world("sp_pp_trainer", 4, out))
            walls["b_trainers"] = time.perf_counter() - t
            _, cli_err = proc.communicate(timeout=max(1.0, PARALLEL_TIMEOUT_S - (
                time.perf_counter() - t0)))
        except BaseException:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
            raise
        cli_meta = out / "run_cli" / "checkpoint_epoch_1" / "metadata.json"
        if proc.returncode != 0 or not cli_meta.exists():
            raise AssertionError(f"kokoro-train --distributed on data,seq exited "
                                 f"{proc.returncode}: {cli_err[-3000:]}")
        cli = json.loads(cli_meta.read_text())
        tags = [tag for runs in SP_PP_RUNS.values() for tag, *_ in runs]
        runs = {tag + suffix: (torch.load(out / f"steps_{tag}{suffix}.pt"), lr)
                for tag in tags for suffix, lr in run_rates(tag)}
        trainers = {tag: json.loads((out / f"trainer_{tag}.json").read_text())
                    for tag, *_ in SP_PP_TRAINERS}
        peaks = {}
        for path in sorted(out.glob("peak_*.json")):
            tag, rank = path.stem[len("peak_"):].rsplit("_", 1)
            peaks.setdefault(tag, {})[int(rank)] = json.loads(path.read_text())
    init = KokoroModel(KokoroConfig(**NO_DROPOUT)).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    held = {tag: held_to_single(run, singles[lr, 2 if tag.startswith("stage") else 0], init)
            for tag, (run, lr) in runs.items()}
    single_ref = singles[REFERENCE_LR, 2]
    control = {"single_again_bitwise": all(
                   torch.equal(controls[""][key][n], single_ref[key][n])
                   for key in ("grads", "params") for n in single_ref[key]),
               # the tensors whose gradient at the init differs between the two runs
               "single_again_grads_differ": sorted(
                   n for n, g in single_ref["grads"].items()
                   if not torch.equal(g, controls[""]["grads"][n])),
               "single_again": held_to_single(controls[""], single_ref, init),
               "params_one_ulp": held_to_single(controls["params_ulp"], single_ref, init),
               "single_totals": [m["total"] for m in single_ref["metrics"]]}
    runs = {tag: run for tag, (run, _) in runs.items()}
    failures = []
    for tag, h in held.items():
        if tag in tags and (not h["held"] or h["stepped"] != [1.0] * 3):
            failures.append(f"{tag} against the single process: {h}")
        if any(any(c.values()) for c in runs[tag]["launches"]):
            failures.append(f"{tag} launched a kernel: {runs[tag]['launches']}")
    if not control["single_again_bitwise"]:
        failures.append("the single process's f32 steps differ run to run in "
                        f"{control['single_again_grads_differ']}")
    for tag, tr in trainers.items():
        steps = tr["steps"]
        if tr["use_flash"] or not tr["disabled_line"] or not steps:
            failures.append(f"trainer {tag}: flash {tr['use_flash']}, log "
                            f"{tr['disabled_line']}, {len(steps)} steps")
        for s_ in steps:
            if not (s_["metrics"]["stepped"] == 1.0 and math.isfinite(s_["metrics"]["total"])
                    and not any(s_["launches"].values())):
                failures.append(f"trainer {tag} step {s_}")
        if any(v["launches"] for v in tr["validations"]):
            failures.append(f"trainer {tag} validation launched {tr['validations']}")
    if not (cli["config"]["distributed_init"] and cli["counters"]["optimizer_step"] > 0
            and cli["config"]["mesh_axis_names"] == ["data", "seq"]):
        failures.append(f"kokoro-train --distributed data,seq: {cli['counters']}")

    def per_step(collectives):
        return {k: float(np.mean([c[k] for c in collectives])) for k in collectives[0]}

    result = {
        "phase": "parallel_sp_pp",
        "f32_vs_single": {"limits": PARALLEL_LIMIT,
                          "held_at_lr": {t: HELD_LR[t] for t in tags},
                          "not_held": f"runs tagged _reference_lr: readings at {REFERENCE_LR}",
                          "control_single_2_microbatches_at_reference_lr": control,
                          "route": "plain attention (use_flash_attention=False), both sides",
                          **held, "single_step_ms": {f"lr={lr} microbatches={m}": s_["step_ms"]
                                                     for (lr, m), s_ in singles.items()},
                          "step_ms_rank0": {t: r["step_ms"] for t, r in runs.items()},
                          "collectives_per_step_rank0": {
                              t: per_step(r["collectives"]) for t, r in runs.items()},
                          "launches": {t: r["launches"] for t, r in runs.items()}},
        "trainers_bf16_long": {tag: {
            "sizes_dp_sp_tp_pp": tr["sizes"], "disabled_line": tr["disabled_line"],
            "steps": [{"total": s_["metrics"]["total"], "grad_norm": s_["metrics"]["grad_norm"],
                       "microbatches": s_["microbatches"],
                       "attention_launches": sum(s_["launches"].values())}
                      for s_ in tr["steps"]],
            "step_ms_rank0": tr["step_ms"], "collectives_per_step_rank0": per_step(
                tr["collectives"]), "opt_step": tr["opt_step"]} for tag, tr in trainers.items()},
        "peak_allocated_gb_per_rank": {tag: {r: b / 1e9 for r, b in sorted(v.items())}
                                       for tag, v in peaks.items()},
        "cli_data_seq": {"opt_steps": cli["counters"]["optimizer_step"],
                         "mesh": cli["config"]["mesh_shape"]},
        "note": "ranks share one card over gloo: not a scaling measurement",
        "wall_s": walls}
    emit(result)
    if failures:
        raise AssertionError("; ".join(failures))
    launches = {}
    for tr in trainers.values():
        for s_ in tr["steps"]:
            for name, c in s_["launches"].items():
                launches[name] = max(launches.get(name, 0), c)
    return {kern.name: {"launches": launches.get(kern.name, 0),
                        "launches_are": "per bf16 long-regime trainer step on rank 0 of (2, 2) "
                                        "('data', 'seq') and ('data', 'stage'): the kernels "
                                        "are off there, as the reference routes"}
            for kern in all_kernels()}


def parse_phases(argv) -> list:
    """Every phase with no arguments (the contract run); ``--phases a,b`` runs
    a subset, for a short call after a change, and prints no contract lines.
    Phase scripts brings phase quality, whose run directory it serves."""
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU.")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {','.join(PHASES)}")
    args = parser.parse_args(argv)
    names = args.phases.split(",")
    if "scripts" in names:
        names.append("quality")
    unknown = set(names) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")
    return [p for p in PHASES if p in names]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import kokoro_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the kokoro_tpu_torch package is missing ({err})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    phases = parse_phases(sys.argv[1:])
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        return run_phases(phases, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_phases(phases, work: Path) -> int:
    """Run ``phases`` in order, a later phase reading what an earlier one
    left under ``work``; the contract lines when they are all of
    ``PHASES``."""
    import torch

    t_start = time.perf_counter()
    phase_s = {}  # wall seconds of each phase, host clock

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phase_s[name] = time.perf_counter() - t
        return out

    smi = timed("device", phase_device)
    timings, counts, long_counts = {}, {}, {}
    if "kernels" in phases:
        timings.update(timed("kernels", phase_kernels))
    for name, fn in (("kernels_bwd", phase_kernels_bwd), ("dropout", phase_dropout)):
        if name in phases:
            timed(name, fn)
    if "kernels_flash" in phases:
        timings.update(timed("kernels_flash", phase_kernels_flash))
    if "kernels_folded" in phases:
        folded_times, folded_counts = timed("kernels_folded", phase_kernels_folded)
        timings.update(folded_times)
        counts.update({name: (c, "per kernels_folded call: one fused_attention forward and "
                                 "backward, B=32 T=512 H=8 Dh=64 bf16") for name, c in folded_counts.items()})
    for name, fn in (("forward", phase_forward), ("serve", phase_serve)):
        if name in phases:
            timed(name, fn)
    if "train" in phases:  # launches in one bf16 preset training step
        for name, c in timed("train", phase_train).items():
            if c:
                counts[name] = (c, "per bf16 preset training step (B=32 L=96 T=512)")
    long_step = "per bf16 long training step (B=12 L=256 T=1408)"
    dh256_counts, dh512_counts, dh1536_counts, dh2560_counts = {}, {}, {}, {}
    if "long" in phases:  # launches in one bf16 long training step
        (long_path, dh256_counts, dh512_counts, dh1536_counts,
         dh2560_counts) = timed("long", phase_long)
        for name, c in long_path.items():
            if name.startswith("flash"):
                counts[name] = (c, long_step)
            elif c:
                long_counts[name] = c
    mfa_counts = {}
    if "mfa" in phases:  # launches in the last long training step on MFA durations
        mfa_counts = {name: c for name, c in timed("mfa", phase_mfa).items() if c}
    tools_counts = {}
    if "tools" in phases:  # launches in the last long training step with diagnostics on
        tools_counts = {name: c for name, c in timed("tools", phase_tools).items() if c}
    quality_counts, quality_errors = {}, {}
    if "quality" in phases:  # launches in the quality run's last step, errors at its shapes
        quality_counts, quality_errors = timed("quality",
                                               lambda: phase_quality(work / "quality"))
    vocoder_counts, scripts_counts, scripts_errors = {}, {}, {}
    if "vocoder_train" in phases:  # launches over the vocoder's training run (none)
        vocoder_counts = timed("vocoder_train", phase_vocoder_train)
    if "scripts" in phases:  # launches per bench_step_shapes step, errors at its shapes
        scripts_counts, scripts_errors = timed("scripts",
                                               lambda: phase_scripts(work / "quality"))
    bench_path = None
    if "bench" in phases:  # launches per compute-only and end-to-end step, errors
        bench_path = timed("bench", lambda: phase_bench(work / "bench"))
    parallel_path = {}
    if "parallel" in phases:  # launches per step on rank 0 of the (2, 2) runs
        parallel_path = timed("parallel", phase_parallel)
    sp_pp_path = {}
    if "parallel_sp_pp" in phases:  # launches per step on the seq and stage paths
        sp_pp_path = timed("parallel_sp_pp", phase_parallel_sp_pp)
    torch.cuda.synchronize()
    emit({"wall_s": time.perf_counter() - t_start, "phases": phases, "phase_wall_s": phase_s})
    if phases != PHASES:
        # a subset run checks no contract: its last line says so, and has no "ok"
        emit({"partial_run": phases, "contract_checked": False})
        return 0

    shapes = {"packed": "B=32 T=512 H=8 Dh=64", "folded": "B=32 T=512 H=8 Dh=64 (folded B*H=256)",
              "flash": "B=12 T=1408 H=8 Dh=64 causal"}
    kernels = []
    for kern in all_kernels():
        r = timings[(kern.name, "bfloat16")]
        launches, launches_are = counts[kern.name]
        row = {
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "tflops": r["tflops"],
            "bound_share": r["bound_share"], "dtype": "bfloat16",
            "shape": shapes[kern.name.split("_")[0]], "launches_are": launches_are,
        }
        for extra in ("ms_for_backward", "ms_rate_0.1", "ms_for_backward_rate_0.1",
                      "library_ms_rate_0.1", "library_rate_timing"):
            if extra in r:
                row[extra] = r[extra]
        row["device_kernels_per_call"] = r["device_kernels_per_call"]
        if (kern.name, "bfloat16", "long") in timings:  # K2 and its backward
            row["long_shape"] = {
                **timings[(kern.name, "bfloat16", "long")],
                "shape": "B=12 T=1408 H=8 Dh=64, kv lengths 1408",
                "launches": long_counts[kern.name], "launches_are": long_step}
        if kern.name.startswith("flash"):  # K4 at head dims 192 and 256, and past 256
            for key, timed_dims, path_counts, path in (
                    ("head_dims_192_256", FLASH_TIMED[1:3], dh256_counts, "n_heads=2, head_dim 256"),
                    ("head_dims_320_1024", FLASH_TIMED[3:6], dh512_counts,
                     "n_heads=1, head_dim 512: the cluster kernels"),
                    ("head_dims_1088_2048", FLASH_TIMED[6:9], dh1536_counts,
                     "hidden_dim=1536, n_heads=1, head_dim 1536: clusters of 12 CTAs"),
                    ("head_dims_2112_up", FLASH_TIMED[9:], dh2560_counts,
                     "hidden_dim=2560, n_heads=1, head_dim 2560: the scores in device "
                     "memory (csrc/attention_scores.cuh)")):
                row[key] = {
                    "launches": path_counts[kern.name],
                    "launches_are": f"per bf16 long training step at {path} (B=12 L=256 T=1408)",
                    **{f"Dh={Dh}/{dname}": {
                        **{k: timings[(kern.name, dname, f"Dh={Dh}")][k] for k in (
                            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                            "max_abs_err", "tflops", "bound_share", "kernel_split_ms")},
                        **{k: v for k, v in timings[(kern.name, dname, f"Dh={Dh}")].items()
                           if k in ("library_backend", "library_refused")},
                        "shape": f"B=12 T=1408 H={H} Dh={Dh} causal"}
                       for H, Dh in timed_dims for dname in ("bfloat16", "float32")}}
        if kern.name in mfa_counts:  # the slice's own path: the trainer on MFA durations
            row["mfa_path"] = {
                "launches": mfa_counts[kern.name],
                "launches_are": "per long training step on MFA durations (phase mfa: "
                                "2 microbatches of B=12 L=256 T=1408)"}
        if kern.name in quality_counts:  # this slice's path: the quality run
            row["quality_path"] = {
                "launches": quality_counts[kern.name],
                "launches_are": "per training step of the quality run's default regime with "
                                "the packed kernels (phase quality: 2 microbatches of B=12 "
                                "T=384, attention dropout in the kernel; remat runs each "
                                "forward twice)",
                "max_abs_err": quality_errors[kern.name],
                "max_abs_err_at": "every (B, T=384, H=8, Dh=64) of the run, rate 0 and the "
                                  "run's rates, K2 at the run's kv lengths and a mixed set"}
        if kern.name in parallel_path:  # a rank of the (2, 2) ('data', 'model') mesh
            row["parallel_path"] = parallel_path[kern.name]
        if kern.name in sp_pp_path:  # this slice's paths: the seq and stage axes
            row["sp_pp_path"] = sp_pp_path[kern.name]
        if kern.name in vocoder_counts:  # this slice's paths: the vocoder's training
            row["vocoder_train_path"] = {
                "launches": vocoder_counts[kern.name],
                "launches_are": "over train_hifigan's run (phase vocoder_train, "
                                f"{VOCODER_STEPS} steps): HiFi-GAN has no attention"}
        if kern.name in scripts_counts:  # and the tools: bench_step_shapes
            row["scripts_path"] = {
                "launches": scripts_counts[kern.name],
                "launches_are": "per bf16 preset step of bench_step_shapes (phase scripts: "
                                "B=16 and 48, L=64, T=288)"}
            if kern.name in scripts_errors:
                row["scripts_path"].update(
                    max_abs_err=scripts_errors[kern.name],
                    max_abs_err_at="every (B, T=288, H=8, Dh=64) of the step-shape rows, "
                                   "rate 0 and the rows' rates, K2 at the rows' kv lengths "
                                   "and a mixed set")
        if bench_path is not None:  # this slice's path: the two headline benchmarks
            compute_per_step, e2e_per_step, bench_errors = bench_path
            row["bench_path"] = {
                "launches_per_compute_only_step": compute_per_step[kern.name],
                "launches_per_end_to_end_step": e2e_per_step[kern.name],
                "launches_are": "kokoro_tpu_torch.bench: per step of the compute-only phase "
                                "(B=32 L=96 T=512, bf16 preset) and per step of the end-to-end "
                                f"epochs ({BENCH_E2E_EPOCHS} measured, 480 utterances, nine "
                                "buckets T 256-896)"}
            if kern.name in bench_errors:
                row["bench_path"].update(
                    max_abs_err=bench_errors[kern.name],
                    max_abs_err_at="every (B, T, H=8, Dh=64) of the end-to-end epochs, rate 0 "
                                   "and the epochs' rates, K2 at their kv lengths and a mixed "
                                   "set")
        if kern.name in tools_counts:  # the trainer with its diagnostics
            row["tools_path"] = {
                "launches": tools_counts[kern.name],
                "launches_are": "per long training step with the trainer's diagnostics on "
                                "(phase tools: 2 microbatches of B=12 L=256 T=1408)"}
        kernels.append(row)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
