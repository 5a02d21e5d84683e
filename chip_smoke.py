#!/usr/bin/env python3
"""Drive the PyTorch port (kokoro_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``kokoro_tpu_torch/csrc/``, one ``nvcc`` per source.
2. kernels: each forward kernel against its plain PyTorch version on the
   card (TF32 off for the plain version), f32 at 2e-5 and bf16 at 2e-2
   abs/rel, the reference's own forward tolerances.
3. kernel_times: at the decoder's shape B=32, T=512, H=8, Dh=64, each kernel
   (forward at rates 0 and 0.1, backward at rates 0 and 0.1), its plain
   version, one PyTorch library call (``scaled_dot_product_attention``
   forward; for the backward, SDPA forward+backward through autograd minus
   its forward; timed as a yardstick only, the port never calls it) and the
   bound.
4. kernels_bwd: the forward kernels with in-kernel dropout (rate 0.1) and
   the backward kernels (rates 0 and 0.1) against the plain forward and
   backward with the same seed, f32 and bf16, a kv-length row of length 0
   included; gradients at the reference's f32 1e-4 / bf16 3e-2.
5. dropout: the kernels' dropout semantics, measured as
   ``scripts/verify_attention_numerics.py`` measures the TPU's: identity-block
   probes read out the forward's and the backward's dropped weights; keep
   rate, survivor scale, fwd/bwd mask agreement, determinism per seed, and a
   finite-difference check along the gradient.
6. forward: the teacher-forced forward at full width (hidden 512, 6+6
   layers, 8 heads, ff 1536, vocab 59; B=16, T=512, L=128, given durations),
   kernel path against plain path, f32 and bf16; each forward kernel must be
   launched exactly once per decoder layer per forward, the backward ones
   never.
7. serve: a full-width model directory with seeded random weights and the
   committed HiFi-GAN (docs/hifigan_v1_int8.npz), ``TTSServer`` on
   127.0.0.1, five concurrent Russian texts (two phoneme buckets); every
   answer a WAV of (the frames the pipeline reports) x 256 samples, fewer
   dispatches than requests.
8. train: the training step at full width, B=32, L=96, T=512 (``bench.py``'s
   compute-only shape, seeded synthetic batch).  (a) kernel path against
   plain path: f32, TF32 off, every dropout rate 0, SpecAugment off, 3 steps
   from one init; per-step loss and gradient norm and what the steps moved
   the parameters must agree, and a control run with a planted dK fault must
   fail those limits.  (b) the throughput preset (bf16 compute on f32 parameters,
   attention dropout in the kernels, SpecAugment, no remat): 2 warm-up and
   10 timed steps, every loss finite, every step taken, each of the four
   kernel wrappers launched exactly once per decoder layer per step.

Then the script's wall time, the kernels' JSON line (launches: one bf16
preset training step), the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises; nothing falls back
to the CPU or to a plain version.  Exits non-zero without CUDA or without the
repository around it.
"""

from __future__ import annotations

import http.client
import json
import math
import subprocess
import sys
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def attention_bound_ms(B, T, H, Dh, dtype_name, causal, lens) -> tuple[float, str]:
    """Least time for the work this input needs: q, k, v read once, o written
    once; 4*Dh operations per visible (query, key) pair."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * B * T * H * Dh * elem + (0 if causal else 4 * B)
    # a row with every key masked (length 0) still averages all T keys
    pairs = B * T * (T + 1) // 2 if causal else T * sum(min(x, T) if x > 0 else T for x in lens)
    ops = 4 * Dh * H * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bwd_bound_ms(B, T, H, Dh, dtype_name, causal, lens) -> tuple[float, str]:
    """Least time for the backward this input needs: q, k, v, o, dO and the
    f32 lse read once, dq, dk, dv written once; 10*Dh operations per visible
    (query, key) pair (S, dPd, dV, dQ, dK: five products of 2*Dh)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = 8 * B * T * H * Dh * elem + 4 * B * H * T + (0 if causal else 4 * B)
    pairs = B * T * (T + 1) // 2 if causal else T * sum(min(x, T) if x > 0 else T for x in lens)
    ops = 10 * Dh * H * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    regs = {}
    for name, path in libs.items():
        log = path.with_suffix(".log")
        regs[name] = [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln] if log.exists() else []
    emit({"phase": "device", "nvidia_smi": smi, "build_s": build_s,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in libs.items()},
          "ptxas": regs, "tf32_matmul": False, "tf32_cudnn": False})
    return smi


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
            bound, bound_by = attention_bound_ms(B, T, H, Dh, dname, kern.causal, lens_list)
            timings[(kern.name, dname)] = {
                "max_abs_err": err,
                "ms": cuda_time_ms(lambda: kern(q, k, v, **kw)),
                "plain_ms": cuda_time_ms(lambda: fa.packed_attention_reference(
                    q, k, v, causal=kern.causal, **kw), iters=5),
                "library_ms": cuda_time_ms(lib),
                "bound_ms": bound, "bound_by": bound_by,
            }
            drop = dict(kw, dropout_rate=RATE, seed=11)
            timings[(kern.name, dname)]["ms_rate_0.1"] = cuda_time_ms(lambda: kern(q, k, v, **drop))
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

        bound, bound_by = attention_bwd_bound_ms(B, T, H, Dh, dname, kern.causal, lens_list)
        row = {
            "max_abs_err": err,
            "ms": cuda_time_ms(lambda: kern(q, k, v, o, do, lse, **kw)),
            "plain_ms": cuda_time_ms(lambda: fa.packed_attention_bwd_reference(
                q, k, v, do, causal=kern.causal, **kw), iters=5),
            "library_ms": cuda_time_ms(sdpa_fwd_bwd) - cuda_time_ms(sdpa_fwd),
            "bound_ms": bound, "bound_by": bound_by,
        }
        drop = dict(kw, dropout_rate=RATE, seed=11)
        o, lse = fwd(q, k, v, return_lse=True, **drop)
        row["ms_rate_0.1"] = cuda_time_ms(lambda: kern(q, k, v, o, do, lse, **drop))
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
    shapes = [(4, T, Dh) for Dh in (64, 128) for T in (128, 432, 512, 848, 896)]
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
          "shapes": "H=8; B=4 Dh{64,128} T{128,432,512,848,896}; B=32 T=512 Dh=64; "
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
            for kern in fa.KERNELS:  # the main path's run: counts from 0
                kern.launches = 0
            out_k = m_fused(**inputs)
            torch.cuda.synchronize()
            counts[dname] = {kern.name: kern.launches for kern in fa.KERNELS}
            for kern in fa.KERNELS:  # no gradient: the backward kernels stay idle
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
    server = TTSServer.for_model(
        str(model_dir), device="cuda", max_len=max_len,
        vocoder_path=str(ROOT / "docs" / "hifigan_v1_int8.npz"),
        config=ServeConfig(host="127.0.0.1", port=0, max_batch_delay_ms=500.0),
        request_timeout_s=600.0,
    )
    tts = server.tts
    if tts.vocoder.vocoder_type != "hifigan":
        raise AssertionError("the committed HiFi-GAN weights did not load")
    buckets = [server.pipeline.encode(t)[0] for t in SERVE_TEXTS]
    if len(set(buckets)) != 2 or buckets.count(buckets[0]) != 4:
        raise AssertionError(f"texts do not fall in two buckets of 4 + 1: {buckets}")
    server.start()
    launches0 = fa.total_launches()

    def post(text):
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=600)
        conn.request("POST", "/tts", body=json.dumps({"text": text}).encode("utf-8"),
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
    finally:
        server.stop()
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
          "aggregate_rtf": wall / total_audio, "stats": stats,
          "kernel_launches": fa.total_launches() - launches0})


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


def phase_train():
    """(a) kernel path vs plain path, f32, 3 steps; (b) the throughput preset
    in bf16, 2 warm-up + 10 timed steps.  Returns the launches of each kernel
    wrapper in the last timed step (the main path's run)."""
    import torch

    from kokoro_tpu_torch.cli.profile_paths import preset_train_step, training_batch
    from kokoro_tpu_torch.config import KokoroConfig, TrainingConfig
    from kokoro_tpu_torch.models.kokoro import KokoroModel
    from kokoro_tpu_torch.models.rng import Rng
    from kokoro_tpu_torch.ops import fused_attention as fa
    from kokoro_tpu_torch.training.optimizer import build_preclip_norms
    from kokoro_tpu_torch.training.train_step import (
        create_train_state, make_loss_fn, make_train_step,
    )

    dev = torch.device("cuda")
    B, L, T = 32, 96, 512
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
        launches0 = fa.total_launches()
        real_bwd = fa.packed_attention_bwd_causal
        if name == "planted_dk":
            fa.packed_attention_bwd_causal = PlantedDk(real_bwd)
        try:
            total, _ = make_loss_fn(model, cfg, spec_augment=False)(
                batch, Rng.from_generator(torch.Generator().manual_seed(0)))
            grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
            grads = {n: g for n, g in zip(params, grads) if g is not None}
            metrics = [step(state, batch, torch.Generator().manual_seed(i)) for i in range(3)]
        finally:
            fa.packed_attention_bwd_causal = real_bwd
        torch.cuda.synchronize()
        launched = fa.total_launches() - launches0
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
    emit({"phase": "train_parity", "steps": 3, "limits": TRAIN_LIMIT, **parity,
          "plain_path": [{k: m[k] for k in ("total", "grad_norm", "stepped")} for m in mp]})
    del paths, gp, dp, gk, dk
    torch.cuda.empty_cache()
    sound, planted = parity["kernel"], parity["planted_dk"]
    if not all(m["stepped"] == 1.0 for m in mp) or sound["stepped"] != [1.0] * 3 or any(
            sound[k] > TRAIN_LIMIT[k] for k in TRAIN_LIMIT):
        raise AssertionError(f"kernel path and plain path training disagree: {sound}")
    if all(planted[k] <= TRAIN_LIMIT[k] for k in TRAIN_LIMIT):
        raise AssertionError(f"the parity limits do not catch a planted dK fault: {planted}")

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
        for kern in fa.KERNELS:  # each step is a main-path run: counts from 0
            kern.launches = 0
        steps.append(step(state, batch, gen))
        per_step.append({kern.name: kern.launches for kern in fa.KERNELS})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 10
    for m, counts in zip(steps, per_step):
        if not (all(math.isfinite(m[k]) for k in ("total", "grad_norm")) and m["stepped"] == 1.0):
            raise AssertionError(f"preset step not finite or skipped: {m}")
        if any(c != n_layers for c in counts.values()):
            raise AssertionError(f"launches per step {counts}, expected {n_layers} each")
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
        from kokoro_tpu_torch.ops import fused_attention as fa
    except ImportError as err:
        print(f"chip_smoke: the kokoro_tpu_torch package is missing ({err})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = phase_device()
    timings = phase_kernels()
    phase_kernels_bwd()
    phase_dropout()
    phase_forward()
    phase_serve()
    counts = phase_train()  # launches in one bf16 preset training step
    torch.cuda.synchronize()

    kernels = []
    for kern in fa.KERNELS:
        r = timings[(kern.name, "bfloat16")]
        kernels.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": counts[kern.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "ms_rate_0.1": r["ms_rate_0.1"],
            "dtype": "bfloat16", "shape": "B=32 T=512 H=8 Dh=64",
            "launches_are": "per bf16 preset training step",
        })
    emit({"wall_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
