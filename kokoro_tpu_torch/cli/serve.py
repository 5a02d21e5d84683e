"""Continuous-batching TTS HTTP server of the PyTorch port.

    python -m kokoro_tpu_torch.cli.serve --model <model_dir> --device cuda --port 8700
    curl -s localhost:8700/tts -d '{"text": "привет мир"}' > out.wav
    curl -s localhost:8700/stats

``<model_dir>`` is a directory written by ``kokoro_tpu_torch.convert.save_model_dir``.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

logger = logging.getLogger(__name__)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="kokoro-serve-torch", description="Serve TTS over HTTP with continuous batching"
    )
    parser.add_argument("--model", required=True, help="model directory (convert.save_model_dir)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8700)
    parser.add_argument("--vocoder", choices=("hifigan", "griffin_lim"), default="hifigan")
    parser.add_argument("--vocoder-path", default=None, help="HiFi-GAN weights (.npz)")
    parser.add_argument("--max-len", type=int, default=None, help="frame cap per utterance")
    parser.add_argument("--max-batch-size", type=int, default=32, help="largest decode group")
    parser.add_argument("--max-batch-delay-ms", type=float, default=30.0,
                        help="how long a lone request waits for batchmates")
    parser.add_argument("--queue-limit", type=int, default=256,
                        help="pending-request cap before 503 backpressure")
    parser.add_argument("--request-timeout-s", type=float, default=900.0)
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    from kokoro_tpu_torch.serving import ServeConfig, TTSServer

    cfg = ServeConfig(host=args.host, port=args.port, max_batch_size=args.max_batch_size,
                      max_batch_delay_ms=args.max_batch_delay_ms, queue_limit=args.queue_limit)
    server = TTSServer.for_model(
        args.model, device=args.device, config=cfg, request_timeout_s=args.request_timeout_s,
        vocoder_type=args.vocoder, vocoder_path=args.vocoder_path, max_len=args.max_len,
    ).start()
    logger.info("serving on http://%s:%d (max batch %d, delay %.0f ms)",
                args.host, server.port, cfg.max_batch_size, cfg.max_batch_delay_ms)

    done = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: done.set())
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    done.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
