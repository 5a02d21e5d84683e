"""Utilities of the port (the rest of ``kokoro_tpu/utils`` is a later slice)."""
