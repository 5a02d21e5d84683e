#!/usr/bin/env python3
"""Drive the PyTorch port (kokoro_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                          # every phase, the contract lines
    python3 chip_smoke.py --phases kernels_flash,long   # some phases; its last line is
                                                        # {"partial_run": [...], ...}, no "ok"

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``kokoro_tpu_torch/csrc/``, one ``nvcc`` per source,
   all started together; ptxas's registers and spills per kernel, and a
   failure if a tensor-core kernel (``csrc/attention_tc.cuh``) spills; and
   the host-side C++ duration aligner (``csrc/aligner.cpp``, ``g++``).
2. kernels: the packed forward kernels (K1 causal, K2 kv-length) against their
   plain PyTorch version (TF32 off), f32 at 2e-5 and bf16 at 2e-2 abs/rel, the
   reference's own forward tolerances; then kernel_times at the decoder's
   shape B=32, T=512, H=8, Dh=64: each kernel (forward and backward, rates 0
   and 0.1), its plain version, one PyTorch library call (SDPA forward; for a
   backward, SDPA forward+backward through autograd minus its forward; timed
   as a yardstick only, the port never calls it), the bound, the achieved
   TFLOP/s and the share of the bound.  Kernels and library calls are timed
   on the device (20 calls in a CUDA graph, the median of 5 replays), the
   plain versions by CUDA events around the calls.
3. kernels_bwd: the packed forward with in-kernel dropout and the backward
   kernels (rates 0 and 0.1) against the plain versions with the same seed,
   B=4 over the bucket ladder and T=1433, Dh 64 and 128, a kv-length row of
   length 0 included; gradients at f32 1e-4 / bf16 3e-2.
4. dropout: the packed kernels' dropout semantics, as
   ``scripts/verify_attention_numerics.py`` measures the TPU's.
5. kernels_flash: K4 (``ops/flash_attention.py``) forward and backward
   against their plain versions, Dh 64/128 x T 1024/1408/1433/1536/1920 x causal
   and not x segment ids none/suffix/interior, f32 and bf16; then its times at
   the long path's shape B=12, T=1408, H=8, Dh=64.  Then the long path's other
   attention kernels, K2 forward and the packed kv-length backward, at its
   cross-attention shape B=12, T=1408, H=8, Dh=64 against their plain
   versions (f32 and bf16, rates 0 and 0.1, kv lengths 1408 as the long batch
   gives them and a mixed set with a row of length 0), and their times there.
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
   bf16 long step at B=12, L=256, T=1408: 2 warm-up and 10 timed steps.
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

Then the script's wall time and each phase's, the kernels' JSON line (eight wrappers, each
with the launches of its main-path run: a preset step, a long step or a
kernels_folded call, and its bf16 time, TFLOP/s and share of the bound; K2
and its backward also carry ``long_shape``, their times at T=1408 and
launches per long step; the kernels of phase mfa carry ``mfa_path``, their
launches per training step there), the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises; nothing falls
back to the CPU or to a plain version.  Exits non-zero without CUDA or
without the repository around it.
"""

from __future__ import annotations

import http.client
import json
import math
import shutil
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
PEAK_OPS = {"bfloat16": 989e12,    # dense bf16 tensor-core rate
            "float32": 67e12}      # f32 outside the tensor cores (no TF32)
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
          "serve", "train", "long", "mfa"]


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


def library_bwd_ms(fwd, fwd_bwd) -> float:
    """The library's backward alone: its forward and backward through
    autograd minus its forward, each timed by graph replay (the median of 5)."""
    return graph_time_ms(fwd_bwd) - graph_time_ms(fwd)


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
    regs, spills = {}, {}
    for name, path in libs.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        regs[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
        spills.update(ptxas_spills(lines))
    emit({"phase": "device", "nvidia_smi": smi, "build_s": build_s,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
          "aligner_library": str(native.library_path().relative_to(ROOT)),
          "ptxas": regs, "spills": spills, "tf32_matmul": False, "tf32_cudnn": False})
    tensor_core = {fn: sp for fn, sp in spills.items() if "kokoro_attn2tc" in fn}
    if tensor_core:
        raise AssertionError(f"the tensor-core kernels spill registers: {tensor_core}")
    return smi


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
            if kern.causal:
                lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, scale=Dh ** -0.5)
            else:
                lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep, scale=Dh ** -0.5)
            bound = attention_bound(B, T, H, Dh, dname, kern.causal,
                                    None if kern.causal else lens_list)
            drop = dict(kw, dropout_rate=RATE, seed=11)
            timings[(kern.name, dname)] = timed_row(
                bound, graph_time_ms(lambda: kern(q, k, v, **kw)), max_abs_err=err,
                plain_ms=cuda_time_ms(lambda: fa.packed_attention_reference(
                    q, k, v, causal=kern.causal, **kw), iters=5),
                library_ms=graph_time_ms(lib),
                **{"ms_rate_0.1": graph_time_ms(lambda: kern(q, k, v, **drop))})
        timings.update(backward_times(B, T, H, Dh, dtype, lens, lens_list, qkv))
    emit({"phase": "kernel_times", "shape": "B=32 T=512 H=8 Dh=64",
          "kv_lengths": "512 - 8*b", "times": {f"{n}/{d}": r for (n, d), r in timings.items()}})
    return timings


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
        o, lse = fwd(q, k, v, return_lse=True, **kw)
        grads = kern(q, k, v, o, do, lse, **kw)
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
            bound, graph_time_ms(lambda: kern(q, k, v, o, do, lse, **kw)), max_abs_err=err,
            plain_ms=cuda_time_ms(lambda: fa.packed_attention_bwd_reference(
                q, k, v, do, causal=kern.causal, **kw), iters=5),
            library_ms=library_bwd_ms(sdpa_fwd, sdpa_fwd_bwd))
        drop = dict(kw, dropout_rate=RATE, seed=11)
        o, lse = fwd(q, k, v, return_lse=True, **drop)
        row["ms_rate_0.1"] = graph_time_ms(lambda: kern(q, k, v, o, do, lse, **drop))
        row["plain_ms_rate_0.1"] = cuda_time_ms(lambda: fa.packed_attention_bwd_reference(
            q, k, v, do, causal=kern.causal, **drop), iters=3)
        out[(kern.name, dname)] = row
    return out


def phase_kernels_bwd():
    """Forward at rate 0.1 and backward at rates 0 and 0.1, kernel against
    plain version with the same seed, over the bucket ladder."""
    import torch

    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1)
    H = 8
    shapes = [(4, T, Dh) for Dh in (64, 128) for T in (128, 432, 512, 848, 896, 1433)]
    shapes.append((32, 512, 64))
    worst, checks = {}, 0
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
                    o, lse = fwd(q, k, v, return_lse=True, **kw)
                    grads = bwd(q, k, v, o, do, lse, **kw)
                    torch.cuda.synchronize()
                    where = f"{bwd.name} {dname} B={B} T={T} Dh={Dh} rate={rate}"
                    errs = [close_or_raise(where + " o", o, fa.packed_attention_reference(
                        q, k, v, causal=fwd.causal, **kw), TOL[dname])]
                    ref = fa.packed_attention_bwd_reference(q, k, v, do, causal=fwd.causal, **kw)
                    errs += [close_or_raise(f"{where} d{n}", a, b, GRAD_TOL[dname])
                             for n, a, b in zip("qkv", grads, ref)]
                    key = f"{bwd.name}/{dname}/rate={rate}"
                    worst[key] = max(worst.get(key, 0.0), *errs[1:])
                    worst[f"{fwd.name}/{dname}/rate={rate}"] = max(
                        worst.get(f"{fwd.name}/{dname}/rate={rate}", 0.0), errs[0])
                    checks += 1
    emit({"phase": "kernels_bwd", "checks": checks,
          "shapes": "H=8; B=4 Dh{64,128} T{128,432,512,848,896,1433}; B=32 T=512 Dh=64; "
                    "kv_lengths [T, T-37, T/2, 0]", "rates": [0.0, RATE],
          "tolerance": {"forward": TOL, "grad": GRAD_TOL}, "max_abs_err": worst})


def phase_dropout():
    """The kernels' dropout semantics, as scripts/verify_attention_numerics.py
    measures the TPU's: f32, causal, B=2, H=4, T=128, Dh=64."""
    import torch

    from kokoro_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(3)
    B, H, T, Dh, keep = 2, 4, 128, 64, 1.0 - RATE
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
        "phase": "dropout", "rate": RATE, "keep_rate_observed": keep_hat,
        "keep_rate_abs_err": abs(keep_hat - keep),
        "surviving_weight_scale_max_rel_err": scale_err,
        "mask_fwd_bwd_disagreements": disagree, "mask_positions_checked": int(causal.sum()),
        "pd_fwd_bwd_max_rel_err": pd_rel, "grad_fd_rel_err": fd_rel,
        "same_seed_deterministic": bool(torch.equal(pd_fwd, pd_fwd2)),
        "other_seed_differs": bool(not torch.equal(mask_fwd, pd_other != 0)),
        "limits": DROPOUT_LIMITS,
    }
    emit(result)
    if not (result["keep_rate_abs_err"] <= DROPOUT_LIMITS["keep_rate_abs"]
            and scale_err <= DROPOUT_LIMITS["scale_rel"] and disagree == 0
            and fd_rel <= DROPOUT_LIMITS["fd_rel"] and result["same_seed_deterministic"]
            and result["other_seed_differs"]):
        raise AssertionError(f"dropout semantics outside the limits: {result}")


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


def phase_kernels_flash():
    """K4 forward and backward against their plain versions, then the times
    at the long training shape B=12, T=1408, H=8, Dh=64."""
    import torch
    import torch.nn.functional as F

    from kokoro_tpu_torch.ops import flash_attention as fl

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(4)
    B, H = 2, 8
    worst, checks = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for Dh in (64, 128):
            for T in (1024, 1408, 1433, 1536, 1920):
                q, k, v, do = (torch.randn(B, H, T, Dh, generator=gen).to(dev, dtype)
                               for _ in range(4))
                for causal in (True, False):
                    for kind in ("none", "suffix", "interior"):
                        q_valid, kv_valid = _flash_masks(kind, B, T, dev, gen)
                        q_seg, kv_seg = fl.segment_ids(q, k, q_valid, kv_valid)
                        kw = dict(causal=causal, scale=Dh ** -0.5, q_seg=q_seg, kv_seg=kv_seg)
                        o, lse = fl.flash_attention_fwd(q, k, v, return_lse=True, **kw)
                        grads = fl.flash_attention_bwd(q, k, v, o, do, lse, **kw)
                        torch.cuda.synchronize()
                        where = f"{dname} T={T} Dh={Dh} causal={causal} masks={kind}"
                        ref_o = fl.flash_attention_reference(q, k, v, **kw)
                        err_o = close_or_raise(where + " o", o, ref_o, TOL[dname])
                        ref = fl.flash_attention_bwd_reference(q, k, v, o, do, **kw)
                        err_g = max(close_or_raise(f"{where} d{n}", a, b, GRAD_TOL[dname])
                                    for n, a, b in zip("qkv", grads, ref))
                        for key, err in ((f"fwd/{dname}", err_o), (f"bwd/{dname}", err_g)):
                            worst[key] = max(worst.get(key, 0.0), err)
                        checks += 1
    emit({"phase": "kernels_flash", "checks": checks,
          "shapes": "B=2 H=8; Dh{64,128} x T{1024,1408,1433,1536,1920} x causal/non-causal "
                    "x segment ids none/suffix/interior",
          "tolerance": {"forward": TOL, "grad": GRAD_TOL}, "max_abs_err": worst})

    B, T, H, Dh = 12, 1408, 8, 64  # the long path's decoder self-attention
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn(B, H, T, Dh, generator=gen).to(dev, dtype) for _ in range(4))
        kw = dict(causal=True, scale=Dh ** -0.5)
        o, lse = fl.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        err_o = close_or_raise(f"flash fwd {dname} long shape", o,
                               fl.flash_attention_reference(q, k, v, **kw), TOL[dname])
        grads = fl.flash_attention_bwd(q, k, v, o, do, lse, **kw)
        ref = fl.flash_attention_bwd_reference(q, k, v, o, do, **kw)
        err_g = max(close_or_raise(f"flash bwd {dname} long shape d{n}", a, b, GRAD_TOL[dname])
                    for n, a, b in zip("qkv", grads, ref))
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*leaves, is_causal=True, scale=Dh ** -0.5)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), leaves, do)

        timings[("flash_attention_fwd", dname)] = timed_row(
            attention_bound(B, T, H, Dh, dname, True),
            graph_time_ms(lambda: fl.flash_attention_fwd(q, k, v, **kw)), max_abs_err=err_o,
            plain_ms=cuda_time_ms(lambda: fl.flash_attention_reference(q, k, v, **kw), iters=3),
            library_ms=graph_time_ms(sdpa_fwd))
        timings[("flash_attention_bwd", dname)] = timed_row(
            attention_bound(B, T, H, Dh, dname, True, backward=True),
            graph_time_ms(lambda: fl.flash_attention_bwd(q, k, v, o, do, lse, **kw)),
            max_abs_err=err_g,
            plain_ms=cuda_time_ms(lambda: fl.flash_attention_bwd_reference(
                q, k, v, o, do, **kw), iters=3),
            library_ms=library_bwd_ms(sdpa_fwd, sdpa_fwd_bwd))
        del q, k, v, do, o, lse, grads, ref, leaves
        torch.cuda.empty_cache()
    emit({"phase": "kernel_times_flash", "shape": "B=12 T=1408 H=8 Dh=64 causal",
          "times": {f"{n}/{d}": r for (n, d), r in timings.items()}})
    timings.update(long_cross_attention(gen))
    return timings


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
                o, lse = fwd(q, k, v, return_lse=True, **kw)
                grads = bwd(q, k, v, o, do, lse, **kw)
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
        o, lse = fwd(q, k, v, return_lse=True, **kw)
        heads = [x.view(B, T, H, Dh).transpose(1, 2).contiguous().requires_grad_(True)
                 for x in (q, k, v)]
        do_h = do.view(B, T, H, Dh).transpose(1, 2).contiguous()
        mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, None, :]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*heads, attn_mask=mask, scale=Dh ** -0.5)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), heads, do_h)

        timings[(fwd.name, dname, "long")] = timed_row(
            attention_bound(B, T, H, Dh, dname, False, lens_list),
            graph_time_ms(lambda: fwd(q, k, v, **kw)),
            max_abs_err=worst[f"{fwd.name}/{dname}/rate=0.0"],
            plain_ms=cuda_time_ms(lambda: fa.packed_attention_reference(
                q, k, v, causal=False, **kw), iters=3),
            library_ms=graph_time_ms(sdpa_fwd))
        timings[(bwd.name, dname, "long")] = timed_row(
            attention_bound(B, T, H, Dh, dname, False, lens_list, backward=True),
            graph_time_ms(lambda: bwd(q, k, v, o, do, lse, **kw)),
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
                    o, lse = fa.folded_attention_fwd(fold(q), fold(k), fold(v),
                                                     return_lse=True, **kw)
                    grads = fa.folded_attention_bwd(fold(q), fold(k), fold(v), o, fold(do),
                                                    lse, **kw)
                    torch.cuda.synchronize()
                    where = f"folded {dname} T={T} Dh={Dh} rate={rate}"
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
                        o_p, lse_p = fa.packed_attention_causal(pack(q), pack(k), pack(v),
                                                                return_lse=True, **pkw)
                        grads_p = fa.packed_attention_bwd_causal(
                            pack(q), pack(k), pack(v), o_p, pack(do), lse_p, **pkw)
                        unfold = lambda x: pack(x.view(B, H, T, Dh))
                        if not (torch.equal(unfold(o), o_p) and all(
                                torch.equal(unfold(a), b) for a, b in zip(grads, grads_p))):
                            raise AssertionError(f"{where}: folded and packed kernels differ")
                    checks += 1
    emit({"phase": "kernels_folded", "checks": checks,
          "shapes": "B=4 H=8; Dh{64,128} x T{128,432,512,848}", "rates": [0.0, RATE],
          "folded_equals_packed_bitwise_at_rate": RATE,
          "tolerance": {"forward": TOL, "grad": GRAD_TOL}, "max_abs_err": worst})

    B, T, H, Dh = 32, 512, 8, 64
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn(B * H, T, Dh, generator=gen).to(dev, dtype) for _ in range(4))
        kw = dict(num_heads=1, scale=Dh ** -0.5)
        o, lse = fa.folded_attention_fwd(q, k, v, return_lse=True, **kw)
        err_o = close_or_raise(f"folded fwd {dname} B=32 T=512", o, fa.packed_attention_reference(
            q, k, v, causal=True, **kw), TOL[dname])
        grads = fa.folded_attention_bwd(q, k, v, o, do, lse, **kw)
        ref = fa.packed_attention_bwd_reference(q, k, v, do, causal=True, **kw)
        err_g = max(close_or_raise(f"folded bwd {dname} d{n}", a, b, GRAD_TOL[dname])
                    for n, a, b in zip("qkv", grads, ref))
        heads = [x.view(B, H, T, Dh).clone().requires_grad_(True) for x in (q, k, v)]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(*heads, is_causal=True, scale=Dh ** -0.5)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), heads, do.view(B, H, T, Dh))

        timings[("folded_attention_fwd", dname)] = timed_row(
            attention_bound(B, T, H, Dh, dname, True),
            graph_time_ms(lambda: fa.folded_attention_fwd(q, k, v, **kw)), max_abs_err=err_o,
            plain_ms=cuda_time_ms(lambda: fa.packed_attention_reference(
                q, k, v, causal=True, **kw), iters=5),
            library_ms=graph_time_ms(sdpa_fwd))
        timings[("folded_attention_bwd", dname)] = timed_row(
            attention_bound(B, T, H, Dh, dname, True, backward=True),
            graph_time_ms(lambda: fa.folded_attention_bwd(q, k, v, o, do, lse, **kw)),
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


def train_parity(B, L, T, planted_module, planted_attr):
    """Kernel path against plain path at full width in f32 (TF32 off, every
    dropout rate 0, SpecAugment off), 3 steps from one init, and the control
    with seeded noise planted on ``planted_module.planted_attr``'s dK.
    Returns the readings; raises when the sound run breaks a limit or the
    planted one breaks none."""
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
    init = KokoroModel(KokoroConfig(**no_dropout)).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    batch = training_batch(KokoroConfig(), B, T, L, dev)
    paths = {}
    for name, flash in (("kernel", True), ("plain", False), ("planted_dk", True)):
        model = KokoroModel(KokoroConfig(**no_dropout, use_flash_attention=flash))
        model.load_state_dict(init)
        state = create_train_state(model.to(dev), cfg, total_steps=20000)
        step = make_train_step(cfg, build_preclip_norms(state.names, cfg), spec_augment=False)
        params = dict(model.named_parameters())
        launches0 = sum(read_counts().values())
        real_bwd = getattr(planted_module, planted_attr)
        if name == "planted_dk":
            setattr(planted_module, planted_attr, PlantedDk(real_bwd))
        try:
            total, _ = make_loss_fn(model, cfg, spec_augment=False)(
                batch, Rng.from_generator(torch.Generator().manual_seed(0)))
            grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
            grads = {n: g for n, g in zip(params, grads) if g is not None}
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
    del state, step
    torch.cuda.empty_cache()
    return per_step[-1]


LONG_WORDS = [
    "привет", "мир", "как", "дела", "всё", "хорошо", "говорит", "москва", "сегодня",
    "завтра", "погода", "ясная", "ветер", "слабый", "дождь", "вечером", "утром", "новости",
    "слушайте", "внимательно", "спасибо", "пожалуйста", "конечно", "возможно", "правда",
    "работа", "время",
]


def build_long_corpus(root, n_utts: int, seed: int = 11) -> None:
    """The long-mode synthetic corpus of ``scripts/quality_run.py``
    (``build_corpus(long_mode=True)``): 18-30 Russian words per utterance, a
    harmonic source with per-word pitch moves and onset noise bursts, padded
    to 16.34 s, so every utterance lands in the 1408-frame bucket."""
    import numpy as np

    from kokoro_tpu_torch.data.audio_io import save_wav

    rng = np.random.default_rng(seed)
    sr, lines = 22050, []
    for i in range(n_utts):
        words = list(rng.choice(LONG_WORDS, size=int(rng.integers(18, 31))))
        base_f0 = float(rng.uniform(100, 200))
        pieces = []
        for w in words:
            dur = 0.12 + 0.05 * len(w) + float(rng.uniform(0, 0.08))
            n = int(sr * dur)
            tt = np.arange(n) / sr
            f0 = base_f0 * (1.0 + 0.2 * rng.standard_normal()) * (1.0 - 0.1 * tt / max(dur, 1e-6))
            phase = 2 * np.pi * np.cumsum(f0) / sr
            voiced = 0.5 * np.sin(phase) + 0.25 * np.sin(2 * phase) + 0.12 * np.sin(3 * phase)
            noise = np.zeros(n)
            burst = int(0.25 * n)
            noise[:burst] = 0.2 * rng.standard_normal(burst)
            env = np.minimum(1.0, np.arange(n) / (0.02 * sr))
            env *= env[::-1]
            pieces.append((voiced + noise) * env)
            pieces.append(np.zeros(int(sr * rng.uniform(0.02, 0.08))))
        audio = np.concatenate(pieces)
        target = int(16.34 * sr)
        audio = np.pad(audio, (0, max(0, target - audio.shape[0])))[:target]
        audio += 0.01 * rng.standard_normal(audio.shape[0])
        save_wav(root / "wavs" / f"q{i:04d}.wav",
                 (0.8 * audio / np.abs(audio).max()).astype(np.float32), sr)
        lines.append(f"q{i:04d}|{' '.join(words)}")
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")


def counting_trainer():
    """A ``KokoroTrainer`` subclass (a fresh class, with fresh records, per
    call) that records each step's metrics, its kernel launches (counts set
    to 0 just before the step and read just after), its microbatches, its
    wall time (host clock, synchronised) and the step number it logs at, and
    the launches of each validation."""
    import torch

    from kokoro_tpu_torch.training.trainer import KokoroTrainer

    class CountingTrainer(KokoroTrainer):
        steps, validations, logged_steps, step_ms = [], [], [], []

        def _train_step(self, spec_augment):
            step = super()._train_step(spec_augment)

            def counted(state, batch, generator):
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                metrics = step(state, batch, generator)
                torch.cuda.synchronize()
                self.step_ms.append((time.perf_counter() - t0) * 1e3)
                micro = batch["mel_specs"].shape[0] if batch["mel_specs"].dim() == 4 else 1
                self.steps.append((metrics, read_counts(), micro))
                self.logged_steps.append(self.host_step + 1)
                return metrics

            return counted

        def validate_epoch(self, epoch):
            zero_counts()
            out = super().validate_epoch(epoch)
            torch.cuda.synchronize()
            self.validations.append((read_counts(), len(self.val_batcher.build_batches(0))))
            return out

    return CountingTrainer


def check_long_run(steps, validations, n_layers: int) -> None:
    """Every long-regime trainer step finite, taken and stabilised, K4 and K2
    forward and backward launched once per decoder layer per microbatch and
    no other kernel; each validation K4 and K2 forward once per decoder layer
    per batch."""
    from kokoro_tpu_torch.ops import flash_attention as fl
    from kokoro_tpu_torch.ops import fused_attention as fa

    flash = {kern.name for kern in fl.KERNELS}
    cross = {fa.packed_attention_kvlen.name, fa.packed_attention_bwd_kvlen.name}
    for metrics, counts, micro in steps:
        if not (metrics["stepped"] == 1.0 and all(
                math.isfinite(metrics[k]) for k in ("total", "grad_norm"))):
            raise AssertionError(f"long trainer step not finite or skipped: {metrics}")
        if not metrics["loss_scale"] < 1.0:
            raise AssertionError(f"stabilization not live at 1408 frames: {metrics}")
        want = {name: (n_layers * micro if name in flash | cross else 0) for name in counts}
        if counts != want:
            raise AssertionError(f"long step launches {counts}, expected {want}")
    for counts, n_batches in validations:
        want = {name: (n_layers * n_batches if name in (fl.flash_attention_fwd.name,
                                                        fa.packed_attention_kvlen.name) else 0)
                for name in counts}
        if counts != want:
            raise AssertionError(f"validation launches {counts}, expected {want}")


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
    CountingTrainer = counting_trainer()

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

        first = CountingTrainer(*config(1), device="cuda")
        first.train()
        step_at_break = first.state.opt_step
        del first
        torch.cuda.empty_cache()
        second = CountingTrainer(*config(epochs), device="cuda")
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
    steps, validations = CountingTrainer.steps, CountingTrainer.validations
    check_long_run(steps, validations, n_layers)
    if not (final_step > step_at_break > 0 and resumed_from == 1 and skipped == 0):
        raise AssertionError(f"resume did not continue: {step_at_break} -> {final_step}, "
                             f"resumed at epoch {resumed_from}, {skipped} skipped")
    if not (audio.size > 0 and np.isfinite(audio).all()):
        raise AssertionError("the trained run directory did not synthesise finite audio")
    emit({"phase": "long_trainer", "utterances": {"train": n_train, "val": n_val},
          "epochs": epochs, "resume_after_epoch": 1, "opt_step_at_break": step_at_break,
          "opt_step_final": final_step, "skipped_steps": skipped,
          "steps": [{"total": m["total"], "grad_norm": m["grad_norm"],
                     "loss_scale": m["loss_scale"], "microbatches": micro, "ms": ms,
                     "launches": {k: v for k, v in c.items() if v}}
                    for (m, c, micro), ms in zip(steps, CountingTrainer.step_ms)],
          "validation_launches": [{k: v for k, v in c.items() if v} for c, _ in validations],
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
    del state, step, batch
    torch.cuda.empty_cache()
    return per_step[-1]


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

        CountingTrainer = counting_trainer()
        seen = []

        class AlignedTrainer(CountingTrainer):
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
        steps_before = len(CountingTrainer.steps)
        second = AlignedTrainer(*config(2), device="cuda")
        second.train()
        final_step, resumed_from = second.state.opt_step, second.start_epoch
        del second
        torch.cuda.empty_cache()
        check_long_run(CountingTrainer.steps, CountingTrainer.validations, n_layers)
        resumed = CountingTrainer.logged_steps[steps_before:]
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
    steps = CountingTrainer.steps
    emit({"phase": "mfa", "alignment_report": report, "aligner": aligner,
          "precompute": stats, "precompute_s": precompute_s,
          "train_utterances": len(train_stems), "opt_step_at_break": step_at_break,
          "opt_step_final": final_step, "resumed_logged_steps": resumed,
          "steps": [{"total": m["total"], "grad_norm": m["grad_norm"],
                     "loss_scale": m["loss_scale"], "microbatches": micro, "ms": ms,
                     "launches": {k: v for k, v in c.items() if v}}
                    for (m, c, micro), ms in zip(steps, CountingTrainer.step_ms)],
          "trainer_s": trainer_s,
          "infer": {"wavs": names, "pth_vs_npz_max_abs": {"wav": pth_err, "vocoder": vocoder_err},
                    "ema_vs_model_samples": [len(audio["ema"]), len(audio["model"])],
                    "trace": trace, "run_s": run_s, "wall_s": infer_s},
          "wall_s": time.perf_counter() - t0})
    return steps[-1][1]


def parse_phases(argv) -> list:
    """Every phase with no arguments (the contract run); ``--phases a,b`` runs
    a subset, for a short call after a change, and prints no contract lines."""
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port on one NVIDIA GPU.")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {','.join(PHASES)}")
    names = parser.parse_args(argv).phases.split(",")
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
    if "long" in phases:  # launches in one bf16 long training step
        for name, c in timed("long", phase_long).items():
            if name.startswith("flash"):
                counts[name] = (c, long_step)
            elif c:
                long_counts[name] = c
    mfa_counts = {}
    if "mfa" in phases:  # launches in the last long training step on MFA durations
        mfa_counts = {name: c for name, c in timed("mfa", phase_mfa).items() if c}
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
        if "ms_rate_0.1" in r:
            row["ms_rate_0.1"] = r["ms_rate_0.1"]
        if (kern.name, "bfloat16", "long") in timings:  # K2 and its backward
            row["long_shape"] = {
                **timings[(kern.name, "bfloat16", "long")],
                "shape": "B=12 T=1408 H=8 Dh=64, kv lengths 1408",
                "launches": long_counts[kern.name], "launches_are": long_step}
        if kern.name in mfa_counts:  # the slice's own path: the trainer on MFA durations
            row["mfa_path"] = {
                "launches": mfa_counts[kern.name],
                "launches_are": "per long training step on MFA durations (phase mfa: "
                                "2 microbatches of B=12 L=256 T=1408)"}
        kernels.append(row)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
