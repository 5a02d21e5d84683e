"""Continuous-batching TTS server.

Port of ``kokoro_tpu/serving/server.py``, three layers:

* ``BatchScheduler``: ``submit(text)`` returns a ``concurrent.futures.Future``;
  one scheduler thread collects pending requests into batches (bounded by
  ``max_batch_size`` and ``max_batch_delay_ms``), groups them by the
  pipeline's bucket key and dispatches each group in ONE call;
* the pipeline protocol, ``encode(text) -> (bucket_key, enc) | None`` and
  ``decode_batch(bucket_key, encs) -> list[Synthesis | None]``;
  ``KokoroPipeline`` adapts a ``KokoroTTS`` (decode groups padded to
  power-of-two row counts, vocoder input padded to ``VOCODE_QUANTUM``
  frames);
* ``TTSServer``: a stdlib ``ThreadingHTTPServer`` with ``POST /tts``
  (JSON ``{"text": ...}`` -> ``audio/wav``, with the request's mel frame
  counts in ``X-Mel-Frames`` / ``X-Generated-Frames``), ``GET /healthz``,
  ``GET /stats``.

Requests coalesce, different buckets never share a decode, one request's
failure does not fail its batchmates, and a full queue answers 503.
"""

from __future__ import annotations

import io
import json
import logging
import queue
import threading
import time
import wave
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Hashable, List, NamedTuple, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class QueueFullError(RuntimeError):
    """Backpressure signal: the pending-request queue is at capacity."""


class Synthesis(NamedTuple):
    """One request's result: the waveform, the mel frames it was vocoded from
    (``frames * hop`` samples) and the frames the AR decode generated before
    the trailing-silence trim.  Both counts are None for a multi-chunk text,
    whose waveform also holds the pauses between chunks."""

    audio: np.ndarray
    frames: Optional[int] = None
    generated_frames: Optional[int] = None


@dataclass
class ServeConfig:
    host: str = "127.0.0.1"
    port: int = 8700
    # Largest decode group.
    max_batch_size: int = 32
    # How long the scheduler holds the FIRST request of a forming batch to
    # let concurrent requests coalesce.  Latency floor for a lone request.
    max_batch_delay_ms: float = 30.0
    # Pending-request cap across all buckets; submits beyond it raise
    # QueueFullError (HTTP 503) instead of growing latency unboundedly.
    queue_limit: int = 256


@dataclass
class _Pending:
    text: str
    bucket: Hashable
    enc: Any
    future: Future = field(default_factory=Future)


class BatchScheduler:
    """Micro-batching front of the single device-dispatch thread.

    ``encode`` runs on the caller's thread (host-side G2P, no device); the
    scheduler thread owns every ``decode_batch`` call, so all device work is
    serialised on one CUDA stream.
    """

    def __init__(
        self,
        encode: Callable[[str], Optional[Tuple[Hashable, Any]]],
        decode_batch: Callable[[Hashable, List[Any]], List[Optional[Synthesis]]],
        config: Optional[ServeConfig] = None,
    ) -> None:
        self.encode = encode
        self.decode_batch = decode_batch
        self.config = config or ServeConfig()
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._pending_count = 0
        self._count_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats: Dict[str, Any] = {
            "requests": 0,
            "rejected": 0,
            "encode_failures": 0,
            "decode_failures": 0,
            "dispatches": 0,
            "batched_requests": 0,  # requests that shared a dispatch
            "batch_size_hist": {},  # dispatch group size -> count
            "queue_high_water": 0,
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "BatchScheduler":
        self._thread = threading.Thread(
            target=self._run, name="kokoro-serve-scheduler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._q.put(None)  # wake the blocking get
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    # -- client side -------------------------------------------------------
    def submit(self, text: str) -> Future:
        """Enqueue one utterance; the Future resolves to a ``Synthesis``
        (None for text without phonemes) or raises the per-request failure."""
        self.stats["requests"] += 1
        with self._count_lock:
            if self._pending_count >= self.config.queue_limit:
                self.stats["rejected"] += 1
                raise QueueFullError(
                    f"pending queue at capacity ({self.config.queue_limit})"
                )
            self._pending_count += 1
            self.stats["queue_high_water"] = max(
                self.stats["queue_high_water"], self._pending_count
            )
        try:
            keyed = self.encode(text)
        except Exception:
            with self._count_lock:
                self._pending_count -= 1
            self.stats["encode_failures"] += 1
            raise
        if keyed is None:
            with self._count_lock:
                self._pending_count -= 1
            self.stats["encode_failures"] += 1
            fut: Future = Future()
            fut.set_result(None)  # unsynthesizable text (no phonemes)
            return fut
        item = _Pending(text=text, bucket=keyed[0], enc=keyed[1])
        self._q.put(item)
        return item.future

    # -- scheduler thread ---------------------------------------------------
    def _collect(self) -> List[_Pending]:
        """Block for the first request, then coalesce up to max_batch_size
        within max_batch_delay_ms of it."""
        cfg = self.config
        try:
            first = self._q.get(timeout=0.2)
        except queue.Empty:
            return []
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + cfg.max_batch_delay_ms / 1e3
        while len(batch) < cfg.max_batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            groups: Dict[Hashable, List[_Pending]] = {}
            for item in batch:
                groups.setdefault(item.bucket, []).append(item)
            for bucket, items in groups.items():
                self._dispatch(bucket, items)
            with self._count_lock:
                self._pending_count -= len(batch)

    def _dispatch(self, bucket: Hashable, items: List[_Pending]) -> None:
        self.stats["dispatches"] += 1
        hist = self.stats["batch_size_hist"]
        hist[len(items)] = hist.get(len(items), 0) + 1
        if len(items) > 1:
            self.stats["batched_requests"] += len(items)
        try:
            results = self.decode_batch(bucket, [it.enc for it in items])
        except Exception as err:
            # batch-level failure: fail THESE futures, keep serving
            self.stats["decode_failures"] += len(items)
            logger.exception("decode_batch failed for bucket %r", bucket)
            for it in items:
                if not it.future.done():
                    it.future.set_exception(err)
            return
        for it, res in zip(items, results):
            if not it.future.done():
                it.future.set_result(res)


class KokoroPipeline:
    """Adapts ``KokoroTTS`` to the scheduler's encode/decode protocol.

    Single-chunk texts bucket by their padded phoneme length and decode
    together, the group padded to a power-of-two row count (repeating the
    first row; the extra rows are dropped) so the shapes a server sees stay
    few under variable load; texts that split into several chunks take the
    ``"multi"`` bucket and synthesize one after another inside their
    dispatch."""

    MULTI = "multi"
    # vocoder input is padded up to a multiple of this many frames (log-mel
    # silence) and the waveforms cut back, so a group vocodes in one call
    VOCODE_QUANTUM = 128

    def __init__(self, tts) -> None:
        self.tts = tts

    def encode(self, text: str) -> Optional[Tuple[Hashable, Any]]:
        chunks = self.tts.split_text(text)
        if len(chunks) > 1:
            return (self.MULTI, text)
        enc = self.tts._encode_chunk(chunks[0] if chunks else text)
        if enc is None:
            return None
        return (int(enc["phoneme_indices"].shape[1]), enc)

    def decode_batch(self, bucket: Hashable, encs: List[Any]) -> List[Optional[Synthesis]]:
        if bucket == self.MULTI:
            return [Synthesis(self.tts.text_to_speech(text)) for text in encs]
        n_real = len(encs)
        encs = list(encs) + [encs[0]] * (_pow2(n_real) - n_real)
        tts = self.tts
        mel, lengths = tts.generate_batch(encs)
        mels: List[Optional[np.ndarray]] = []
        for row in range(n_real):  # decode-padded rows are dropped
            n = int(lengths[row])
            if n == 0:
                mels.append(None)
                continue
            mels.append(tts._trim_trailing_silence(np.clip(mel[row, :n], -11.5, 2.0)))
        wavs = self._vocode_group(mels)
        return [None if w is None else Synthesis(w, mels[row].shape[0], int(lengths[row]))
                for row, w in enumerate(wavs)]

    def _vocode_group(self, mels: List[Optional[np.ndarray]]) -> List[Optional[np.ndarray]]:
        """Vocode a dispatch group's mels in one batched call: rows padded to
        a common quantised T and a power-of-two batch, each waveform cut
        back to its own frame count."""
        tts = self.tts
        real = [(i, m) for i, m in enumerate(mels) if m is not None]
        out: List[Optional[np.ndarray]] = [None] * len(mels)
        if not real:
            return out
        q = self.VOCODE_QUANTUM
        t_pad = max(((m.shape[0] + q - 1) // q) * q for _, m in real)
        rows = [np.pad(m, ((0, t_pad - m.shape[0]), (0, 0)), constant_values=-11.5)
                for _, m in real]
        rows += [rows[0]] * (_pow2(len(rows)) - len(rows))
        wavs = tts.vocoder.mel_to_audio_batch(np.stack(rows))
        hop = int(tts.vocoder.audio["hop_length"])
        for k, (i, m) in enumerate(real):
            out[i] = np.asarray(wavs[k][: m.shape[0] * hop])
        return out


def _pow2(n: int) -> int:
    """The least power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


def wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    """PCM16 WAV container around a float waveform (stdlib only)."""
    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16.tobytes())
    return buf.getvalue()


class TTSServer:
    """HTTP front end: POST /tts, GET /healthz, GET /stats."""

    def __init__(self, scheduler: BatchScheduler, sample_rate: int = 22050,
                 config: Optional[ServeConfig] = None,
                 request_timeout_s: float = 900.0) -> None:
        self.scheduler = scheduler
        self.sample_rate = sample_rate
        self.config = config or scheduler.config
        self.request_timeout_s = request_timeout_s
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to logging, not stderr
                logger.debug("http: " + fmt, *args)

            def _json(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"ok": True})
                elif self.path == "/stats":
                    self._json(200, outer.scheduler.stats)
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                try:
                    self._post()
                except BrokenPipeError:  # client went away mid-response
                    pass
                except Exception as err:  # never reset the connection
                    logger.exception("handler failure")
                    try:
                        self._json(500, {"error": f"internal: {err}"})
                    except OSError:
                        pass

            def _post(self):
                if self.path != "/tts":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    text = req["text"]
                except (ValueError, KeyError) as err:
                    self._json(400, {"error": f"bad request: {err}"})
                    return
                try:
                    fut = outer.scheduler.submit(text)
                except QueueFullError:
                    self._json(503, {"error": "queue full, retry later"})
                    return
                try:
                    result = fut.result(timeout=outer.request_timeout_s)
                except TimeoutError:
                    self._json(504, {"error": "synthesis timed out"})
                    return
                except Exception as err:
                    self._json(500, {"error": f"synthesis failed: {err}"})
                    return
                if result is None or np.size(result.audio) == 0:
                    self._json(422, {"error": "text produced no audio"})
                    return
                body = wav_bytes(result.audio, outer.sample_rate)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                if result.frames is not None:
                    self.send_header("X-Mel-Frames", str(result.frames))
                    self.send_header("X-Generated-Frames", str(result.generated_frames))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((self.config.host, self.config.port), Handler)
        self.port = self._httpd.server_address[1]  # port 0 -> OS-assigned
        self._serve_thread: Optional[threading.Thread] = None

    @classmethod
    def for_model(cls, model_dir: str, device: str = "cuda",
                  config: Optional[ServeConfig] = None,
                  request_timeout_s: float = 900.0, **tts_kwargs) -> "TTSServer":
        """KokoroTTS -> KokoroPipeline -> a started BatchScheduler -> server
        (not yet started).  ``device`` defaults to CUDA and raises without
        it."""
        from kokoro_tpu_torch.inference.tts import KokoroTTS

        tts = KokoroTTS(model_dir, device=device, **tts_kwargs)
        pipeline = KokoroPipeline(tts)
        cfg = config or ServeConfig()
        scheduler = BatchScheduler(pipeline.encode, pipeline.decode_batch, cfg).start()
        server = cls(scheduler, sample_rate=tts.sample_rate, config=cfg,
                     request_timeout_s=request_timeout_s)
        server.tts, server.pipeline = tts, pipeline
        return server

    def start(self) -> "TTSServer":
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="kokoro-serve-http", daemon=True
        )
        self._serve_thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10.0)
        self.scheduler.stop()
