"""Continuous-batching TTS serving: concurrent requests coalesce into
phoneme-bucket groups that decode together on one CUDA stream."""

from kokoro_tpu_torch.serving.server import (
    BatchScheduler,
    KokoroPipeline,
    QueueFullError,
    ServeConfig,
    Synthesis,
    TTSServer,
    wav_bytes,
)

__all__ = [
    "BatchScheduler",
    "KokoroPipeline",
    "QueueFullError",
    "ServeConfig",
    "Synthesis",
    "TTSServer",
    "wav_bytes",
]
