"""Serving-throughput benchmark of the continuous-batching server:
aggregate requests per second and latency percentiles under concurrent
load, against strictly sequential serving.

Port of ``scripts/bench_serving.py``.  Runs the port's whole stack in
process, ``KokoroTTS`` -> ``KokoroPipeline`` -> ``BatchScheduler`` ->
``TTSServer`` on 127.0.0.1, and drives it over real HTTP with N concurrent
clients.  The warm-up is the reference's: every text once in turn, then one
concurrent burst at every power-of-two group size up to the client count,
so each (bucket, rows) decode and vocoder group has run once before the
measurement (here that pays the kernel build, the allocator and first
calls).  Then the single-stream time is the best of 8 sequential requests,
and ``--clients`` clients send ``--requests`` requests in all.  Prints the
reference's one JSON line (``single_stream_s``, ``concurrent``: clients,
requests, wall_s, req_per_s, p50_s, p95_s, dispatches,
speedup_vs_sequential); ``--out`` writes it with the model directory, the
vocoder and the card's name and power limit.

A model directory with random weights decodes every request to its length
cap: use a trained run directory (``kokoro_tpu_torch.scripts.quality_run``'s
``<out>/run``).

    python -m kokoro_tpu_torch.scripts.bench_serving --model RUN_DIR [--clients 16] \\
        [--requests 48] [--vocoder griffin_lim|hifigan] [--vocoder-path NPZ] \\
        [--out FILE] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
import time
from pathlib import Path
from typing import Dict

TEXTS = [
    "привет мир",
    "как дела",
    "всё хорошо",
    "доброе утро",
    "спокойной ночи",
    "до свидания",
]


def post_tts(port: int, text: str, timeout: float = 900.0) -> float:
    """POST one text to ``/tts``; the seconds until the whole WAV arrived."""
    t0 = time.perf_counter()
    for attempt in (1, 2):  # one retry on transient transport resets
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        try:
            conn.request("POST", "/tts", body=json.dumps({"text": text}).encode())
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise RuntimeError(f"HTTP {resp.status}: {body[:200]!r}")
            return time.perf_counter() - t0
        except (ConnectionResetError, ConnectionAbortedError):
            if attempt == 2:
                raise
        finally:
            conn.close()
    raise RuntimeError("unreachable")


def run(args) -> Dict:
    """Start the server, warm it, measure; returns the reference's line as
    a dict."""
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.inference.tts import KokoroTTS
    from kokoro_tpu_torch.serving import BatchScheduler, KokoroPipeline, ServeConfig, TTSServer

    device = resolve_device(args.device)
    tts = KokoroTTS(args.model, device=device, vocoder_type=args.vocoder,
                    vocoder_path=args.vocoder_path)
    if tts.vocoder.vocoder_type != args.vocoder:
        raise RuntimeError(f"asked for {args.vocoder}, the server would run "
                           f"{tts.vocoder.vocoder_type}")
    pipeline = KokoroPipeline(tts)
    cfg = ServeConfig(port=0, max_batch_size=args.max_batch_size,
                      max_batch_delay_ms=30.0, queue_limit=1024)
    sched = BatchScheduler(pipeline.encode, pipeline.decode_batch, cfg).start()
    srv = TTSServer(sched, sample_rate=tts.sample_rate, config=cfg).start()
    port = srv.port

    def burst(texts):
        threads = [threading.Thread(target=post_tts, args=(port, t)) for t in texts]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    try:
        for text in TEXTS:  # every bucket once, sequentially
            post_tts(port, text)
        size = 2  # then every power-of-two group size up to the client count
        while size <= args.clients:
            burst((TEXTS * ((size // len(TEXTS)) + 1))[:size])
            size *= 2

        # single stream: sequential requests, the best of 8
        single = min(post_tts(port, TEXTS[i % len(TEXTS)]) for i in range(8))

        latencies: list = []
        lock = threading.Lock()
        idx = {"i": 0}

        def client():
            while True:
                with lock:
                    i = idx["i"]
                    if i >= args.requests:
                        return
                    idx["i"] += 1
                dt = post_tts(port, TEXTS[i % len(TEXTS)])
                with lock:
                    latencies.append(dt)

        d0 = sched.stats["dispatches"]
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(args.clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        dispatches = sched.stats["dispatches"] - d0
    finally:
        srv.stop()

    latencies.sort()
    n = len(latencies)
    return {
        "single_stream_s": round(single, 3),
        "concurrent": {
            "clients": args.clients,
            "requests": n,
            "wall_s": round(wall, 2),
            "req_per_s": round(n / wall, 2),
            "p50_s": round(latencies[n // 2], 3),
            "p95_s": round(latencies[min(n - 1, int(n * 0.95))], 3),
            "dispatches": dispatches,
            "speedup_vs_sequential": round(single * n / wall, 2),
        },
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True)
    p.add_argument("--vocoder", default="griffin_lim", choices=("hifigan", "griffin_lim"))
    p.add_argument("--vocoder-path", default=None)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--requests", type=int, default=48)
    p.add_argument("--max-batch-size", type=int, default=32)
    p.add_argument("--out", default=None,
                   help="also write the line with the model, vocoder and card")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from kokoro_tpu_torch.device import resolve_device
    from kokoro_tpu_torch.scripts.quality_run import payload_device

    args = parse_args(argv)
    line = run(args)
    print(json.dumps(line))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "device": payload_device(resolve_device(args.device)), "model": str(args.model),
            "vocoder": args.vocoder, "vocoder_path": args.vocoder_path, **line}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
