#!/usr/bin/env python3
"""Drive the PyTorch port (kokoro_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``kokoro_tpu_torch/csrc/``, one ``nvcc`` per source.
2. kernels: each kernel against its plain PyTorch version on the card (TF32
   off for the plain version), f32 at 2e-5 and bf16 at 2e-2 abs/rel, the
   reference's own forward tolerances; then times at the decoder's shape
   B=32, T=512, H=8, Dh=64: kernel, plain version, one
   ``scaled_dot_product_attention`` call (timed as a yardstick only; the
   port never calls it) and the bound.
3. forward: the teacher-forced forward at full width (hidden 512, 6+6
   layers, 8 heads, ff 1536, vocab 59; B=16, T=512, L=128, given durations),
   kernel path against plain path, f32 and bf16; each kernel must be launched
   exactly once per decoder layer per forward.
4. serve: a full-width model directory with seeded random weights and the
   committed HiFi-GAN (docs/hifigan_v1_int8.npz), ``TTSServer`` on
   127.0.0.1, five concurrent Russian texts (two phoneme buckets); every
   answer a WAV of (the frames the pipeline reports) x 256 samples, fewer
   dispatches than requests.

Then the kernels' JSON line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises; nothing falls back
to the CPU or to a plain version.  Exits non-zero without CUDA or without the
repository around it.
"""

from __future__ import annotations

import http.client
import json
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
            for kern in fa.KERNELS:
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
        for kern in fa.KERNELS:
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
    emit({"phase": "kernel_times", "shape": "B=32 T=512 H=8 Dh=64",
          "kv_lengths": "512 - 8*b", "times": {f"{n}/{d}": r for (n, d), r in timings.items()}})
    return timings


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
            for name, launches in counts[dname].items():
                if launches != n_layers:
                    raise AssertionError(f"{name}: {launches} launches in one "
                                         f"forward, expected {n_layers}")
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

    smi = phase_device()
    timings = phase_kernels()
    counts = phase_forward()["bfloat16"]  # every number of the kernels line is bf16
    phase_serve()
    torch.cuda.synchronize()

    kernels = []
    for kern in fa.KERNELS:
        r = timings[(kern.name, "bfloat16")]
        kernels.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": counts[kern.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "dtype": "bfloat16",
            "shape": "B=32 T=512 H=8 Dh=64",
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
